"""Silhouette vertices and the two geometry forms of the port's walk.

The JAX kernel walks a boundary of up to 96 rows (segments of both
boundaries plus interior vertices) from a static unroll whose edge data
was formed on the host in float64, and a larger one from SMEM-table loops
that form everything in float32 (``ops/pallas_walk.py:139-451``).
``ops/walk_kernel.py`` holds the plain PyTorch version of both; here each
loop is held against the JAX device function on the same seeded numpy
points, the silhouette queries against ``geometry/queries.py``; one
16-step launch of the plain walk against the interpreted Pallas kernel in
each form is in ``test_torch_silhouette_walk.py``.

XLA's CPU backend contracts ``a * b + c`` into a fused multiply-add
(``tests/test_pallas_walk.py:180-182`` notes it too); the TPU kernel and
the CUDA kernel (``-fmad=false``) round every operation. So the JAX
device functions run in one subprocess whose XLA is capped at AVX, which
has no FMA: there every output is bit-equal, except the square roots
(the closest-point distance and the silhouette distance), where
PyTorch's CPU ``sqrt`` misrounds a fraction of a percent of float32 inputs
by one ulp.

The one-launch comparisons use a staircase terrain: its walls are
axis-aligned with integer corners, so a hit point lies exactly on its
wall. On a sloped wall (the rolling hills of
``models/topography.py``) the hit point rounds off the wall's line, and
whether the wall's end vertices are silhouettes from there is decided by
its last bit: a one-ulp difference anywhere upstream (the math libraries'
sin, exp and log) then changes the next radius, and walks desynchronize
within a few wall visits (with the JAX package's own transcendentals
0.41 of 1,024 lanes agree after 32 steps). Whole topographic solves are
compared statistically in ``test_torch_topography.py``.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.models.dcr_scenarios import \
    _anomalous_conductivity as j_conductivity
from dcrmontecarlo_tpu.ops.pallas_walk import _geometry_size, \
    make_pallas_walk
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.problems.fields import gaussian_dipole as j_dipole
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import Polyline, queries
from dcrmontecarlo_tpu_torch.models import topographic_survey_problem
from dcrmontecarlo_tpu_torch.models.dcr_scenarios import \
    _anomalous_conductivity
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_walk_kernel import OPTS, SEED, _compare, numpy_planes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_SIZE = dict(half_width=100.0, depth=150.0)
N_PTS = 4096
STEPS = 16  # one launch: the Pallas kernel's exit-check chunk

# the JAX device functions on the same inputs, XLA capped at AVX (no FMA)
_JAX_SIDE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from dcrmontecarlo_tpu.geometry import Polyline, queries
from dcrmontecarlo_tpu.ops import pallas_walk as pw
z = dict(np.load(sys.argv[1]))
out = {}
fields = Polyline._fields
for res in (8, 4):
    neu, dirp = (Polyline(*(jnp.asarray(z[f"r{res}_{b}_{f}"])
                            for f in fields)) for b in ("neu", "dir"))
    px, py, dx, dy, r, tm = (jnp.asarray(z[k]) for k in
                             ("px", "py", "dx", "dy", "r", "tm"))
    k = f"r{res}_"
    segs, vert = pw._seg_table(neu), pw._vert_table(neu)
    dsegs = pw._seg_table(dirp)
    if res == 4:  # the table form
        res_ = {
            "cp_smem": pw._closest_point_smem(jnp.asarray(dsegs), len(dsegs),
                                              px, py),
            "fh_smem": pw._first_hit_smem(jnp.asarray(segs), len(segs), px,
                                          py, dx, dy, r, tm),
            "sil_smem": (pw._silhouette_smem(jnp.asarray(vert), len(vert),
                                             px, py),),
        }
    else:
        res_ = {
            "cp_unrolled": pw._closest_point_unrolled(
                pw._static_segments(dirp), px, py),
            "fh_unrolled": pw._first_hit_unrolled(pw._static_segments(neu),
                                                  px, py, dx, dy, r, tm),
            "sil_unrolled": (pw._silhouette_unrolled(
                pw._static_vertices(neu), px, py),),
        }
    res_ |= {
        "cf_smem": pw._chord_frame_smem(jnp.asarray(segs), len(segs), px,
                                        py),
        "is_sil": (queries.is_silhouette(neu, px, py),),
        "sil_dist": (queries.silhouette_distance(neu, px, py),),
        "ray": (queries.ray_intersection(neu, px, py, dx, dy),),
    }
    for name, vals in res_.items():
        for i, v in enumerate(vals):
            out[f"{k}{name}{i}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Seeded points below the terrain, directions, radii and per-lane
    ``t_min``, and the JAX functions' outputs on them."""
    rng = np.random.default_rng(0)
    _, h = topographic_survey_problem(resolution=4.0, **TEST_SIZE)
    px = rng.uniform(-100.0, 100.0, N_PTS).astype(np.float32)
    ang = rng.uniform(0.0, 2.0 * np.pi, N_PTS)
    inputs = dict(
        px=px, py=(h(px) - rng.exponential(3.0, N_PTS)).astype(np.float32),
        dx=np.cos(ang).astype(np.float32), dy=np.sin(ang).astype(np.float32),
        r=rng.uniform(0.5, 20.0, N_PTS).astype(np.float32),
        tm=np.where(rng.uniform(size=N_PTS) < 0.5, 1e-3, 0.0).astype(
            np.float32))
    polylines = {}
    for res in (8, 4):  # the port's boundaries, as they are
        prob, _ = topographic_survey_problem(resolution=float(res),
                                             **TEST_SIZE)
        for b, poly in (("neu", prob.neumann), ("dir", prob.dirichlet)):
            for f in poly._fields:
                polylines[f"r{res}_{b}_{f}"] = getattr(poly, f).numpy()
    d = tmp_path_factory.mktemp("jax_side")
    np.savez(d / "in.npz", **inputs, **polylines)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
               JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(d / "out.npz") as z:
        return inputs, {k: z[k] for k in z.files}


def _ulps(a, b):
    """Largest distance in float32 units in the last place."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _params(prob):
    return wk.make_walk_params(prob, eps=0.5, max_steps=10, t_min=1e-3,
                               rmin=0.25, project=True, rejection_rounds=2,
                               roulette_threshold=None, snap=False, seed=1)


# the plain loop, its extra inputs, its JAX reference's tag (at 8 m the
# static form, 52 rows; at 4 m the table form, 102 rows) and the outputs
# whose last operation is a square root (one ulp allowed)
LOOPS = {
    "closest_point": (wk._closest_point, (), "cp", (0,)),
    "first_hit": (wk._first_hit, ("dx", "dy", "r", "tm"), "fh", ()),
    "silhouette": (wk._silhouette, (), "sil", (0,)),
}


@pytest.mark.parametrize("res", [8.0, 4.0])
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_geometry_loop_matches_jax_device_function(jax_side, loop, res):
    inputs, out = jax_side
    prob, _ = topographic_survey_problem(resolution=res, **TEST_SIZE)
    params = _params(prob)
    assert params.table == (res == 4.0)
    fn, extra, tag, sqrt_outputs = LOOPS[loop]
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    args = [t[k] for k in extra]
    got = fn(params, t["px"], t["py"], *args)
    got = got if isinstance(got, tuple) else (got,)
    form = "smem" if params.table else "unrolled"
    for i, g in enumerate(got):
        want = out[f"r{int(res)}_{tag}_{form}{i}"]
        if i in sqrt_outputs:
            assert _ulps(g.numpy(), want) <= 1, (loop, i)
        else:
            np.testing.assert_array_equal(g.numpy(), want,
                                          err_msg=f"{loop} output {i}")
    if loop == "first_hit":
        assert 0.2 < float(got[5].double().mean()) < 0.8  # hits and misses


def test_chord_frame_matches_jax_device_function(jax_side):
    # one float32 arithmetic in both forms: the static form's host-formed
    # table equals the table form's per-step frame
    inputs, out = jax_side
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    for res in (8.0, 4.0):
        prob, _ = topographic_survey_problem(resolution=res, **TEST_SIZE)
        got = wk._chord_frame(_params(prob), t["px"], t["py"])
        for i, g in enumerate(got):
            np.testing.assert_array_equal(
                g.numpy(), out[f"r{int(res)}_cf_smem{i}"])


def test_silhouette_queries_match_jax(jax_side):
    inputs, out = jax_side
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    for res in (8.0, 4.0):
        prob, _ = topographic_survey_problem(resolution=res, **TEST_SIZE)
        k = f"r{int(res)}_"
        mask = queries.is_silhouette(prob.neumann, t["px"], t["py"])
        np.testing.assert_array_equal(mask.numpy(), out[k + "is_sil0"])
        assert 0.0 < float(mask.double().mean()) < 0.5
        d = queries.silhouette_distance(prob.neumann, t["px"], t["py"])
        assert _ulps(d.numpy(), out[k + "sil_dist0"]) <= 1
        ray = queries.ray_intersection(prob.neumann, t["px"], t["py"],
                                       t["dx"], t["dy"])
        np.testing.assert_array_equal(ray.numpy(), out[k + "ray0"])
    # a straight wall has no silhouette: +inf, as the JAX query gives
    flat = Polyline.from_points([[-5.0, 0.0], [5.0, 0.0]])
    assert torch.isinf(queries.silhouette_distance(
        flat, t["px"][:4], t["py"][:4])).all()


def test_polyline_facade_matches_jax():
    pts = [[-4.0, 0.0], [-1.0, 1.5], [0.0, 0.5], [2.0, 2.0], [4.0, 0.0]]
    tp, jp = Polyline.from_points(pts), JPolyline.from_points(pts)
    p = np.array([[0.3, -1.0], [-2.0, 3.0]], np.float32)
    d = np.array([[0.2, 1.0], [1.0, -1.0]], np.float32)
    for method in ("distance", "is_silhouette", "silhouette_distance"):
        got = getattr(tp, method)(p)
        want = np.asarray(getattr(jp, method)(jnp.asarray(p)))
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                                   err_msg=method)
        np.testing.assert_allclose(np.asarray(getattr(tp, method)(p[0])),
                                   want[0], rtol=1e-6)
    np.testing.assert_allclose(
        tp.ray_intersection(p[0], d[0]).numpy(),
        np.asarray(jp.ray_intersection(jnp.asarray(p[0]),
                                       jnp.asarray(d[0]))), rtol=1e-6)
    hp, nv, hit = tp.intersect(p[0], d[0], 10.0)
    jhp, jnv, jhit = jp.intersect(jnp.asarray(p[0]), jnp.asarray(d[0]), 10.0)
    assert hit and jhit
    np.testing.assert_allclose(hp.numpy(), np.asarray(jhp), rtol=1e-6)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), rtol=1e-6)


def _staircase_problems(step):
    """A terrain of 4 m steps every ``step`` metres (axis-aligned walls,
    integer corners: hit points lie exactly on their walls) over the
    test-size survey: the JAX package's problem and the port's."""
    pts = [[-100.0, 0.0]]
    x = -100.0
    while x < 100.0:
        x = min(x + step, 100.0)
        y = pts[-1][1]
        pts.append([x, y])
        if x < 100.0:
            pts.append([x, 4.0 - y])
    pts = np.array(pts, np.float32)
    box = [[-100.0, float(pts[0, 1])], [-100.0, -150.0], [100.0, -150.0],
           [100.0, float(pts[-1, 1])]]
    anomalies = (((-40.0, -50.0), 15.0, 1e1), ((50.0, -60.0), 15.0, 1e3))
    jprob = JProblem(
        dirichlet=JPolyline.from_points(box),
        neumann=JPolyline.from_points(pts),
        bc_dirichlet=lambda x, y: 0.0 * x,
        source=j_dipole((-20.0, -1.5), (20.0, -1.5), 1.0, 0.5),
        alpha=j_conductivity(1e2, anomalies, 0.5))
    tprob = Problem(
        dirichlet=Polyline.from_points(box), neumann=Polyline.from_points(pts),
        bc_dirichlet=fields.constant(0.0),
        source=fields.gaussian_dipole((-20.0, -1.5), (20.0, -1.5), 1.0, 0.5),
        alpha=_anomalous_conductivity(1e2, anomalies, 0.5))
    return tprob, jprob


# step width -> (geometry size, form)
STAIRS = {16.0: (52, False), 8.0: (100, True)}


def _heightmap_problem(n_seg):
    """A Neumann heightmap of ``n_seg`` segments over the survey's box."""
    x = np.linspace(-100.0, 100.0, n_seg + 1)
    box = [[-100.0, 0.0], [-100.0, -150.0], [100.0, -150.0], [100.0, 0.0]]
    return Problem(dirichlet=Polyline.from_points(box),
                   neumann=Polyline.from_points(
                       np.stack([x, np.sin(x / 9.0) * (1 - (x / 100) ** 2)],
                                1)),
                   source=fields.gaussian_dipole((-20.0, -1.5), (20.0, -1.5)),
                   alpha=fields.constant(1e2))


@pytest.mark.parametrize("n_seg,size,table", [
    (40, 82, False),    # 40 Neumann segments: more than 32 per boundary
    (47, 96, False),    # the static form's last size
    (48, 98, True),
    (300, 602, True),
])
def test_form_follows_the_jax_rule(n_seg, size, table):
    prob = _heightmap_problem(n_seg)
    assert wk.geometry_size(prob) == size
    params = _params(prob)
    assert params.table == table
    assert params.variant == (wk.ROBIN_OFF, False, False, False, table, True,
                              False, False, False)
    assert params.variant in wk.KERNEL_VARIANTS
    fp, ip = params.pack()
    assert ip[17:19].tolist() == [n_seg - 1, int(table)]
    # the static form carries its rows in the parameters; the table form
    # uploads them once per params, as float4 rows
    n_static = 5 * 3 + 14 * n_seg + 8 * (n_seg - 1)
    assert len(fp) == 11 + (0 if table else n_static) + 1 + 1 + 1 + 6
    if table:
        d, n, v = params.device_tables("cpu")
        assert (d.shape, n.shape, v.shape) == ((3, 4), (n_seg, 4),
                                               (n_seg - 1, 8))
        assert params.device_tables("cpu")[0] is d
    else:
        assert params.device_tables("cpu") == ()


def test_table_form_variant_not_compiled_raises():
    # the majorant on a table geometry packs, and its plain walk follows
    # the interpreted Pallas kernel on the staircase terrain (100 rows)
    from jax.experimental.pallas import tpu as pltpu

    from dcrmontecarlo_tpu.problems.majorant import \
        LocalMajorant as JLocalMajorant

    tprob, jprob = _staircase_problems(8.0)
    box = ((30.0, 70.0, -80.0, -40.0),)
    jprob.local_majorant = JLocalMajorant(boxes=box, sigma_bar_bg=1e-3)
    tprob.local_majorant = interop.local_majorant_from(jprob.local_majorant)
    points = np.stack([np.arange(-40.0, 41.0, 10.0), np.full(9, -0.7)],
                      1).astype(np.float32)
    eps = 0.5
    planes = numpy_planes(JSolver(jprob, JOptions(**OPTS)), points, 452, eps)
    common = dict(eps=eps, max_steps=600, t_min=1e-5 * jprob.diameter,
                  rmin=0.5 * eps, project=True, rejection_rounds=2,
                  roulette_threshold=0.05)
    plan = make_pallas_walk(jprob, n_inner=STEPS, block_rows=8,
                            snap_starts=True, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=STEPS)
    want = {k: np.asarray(v) for k, v in out.items()}
    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 **common)
    assert params.variant == (wk.ROBIN_OFF, True, False, False, True, True,
                              False, False, False)
    assert params.variant in wk.KERNEL_VARIANTS
    fp, ip = params.pack()
    assert ip[11] == 1 and ip[12] == 1 and ip[18] == 1  # majorant, table
    got = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), params, STEPS))
    _compare(got, want, state_planes(1))
    # the majorant acted: without it the radii change
    no_maj = interop.state_to_numpy(wk.walk_plain(
        interop.state_from_numpy(planes),
        dataclasses.replace(params, majorant=None), STEPS))
    assert ((no_maj["px"] != got["px"]).mean() >= 0.01)


def test_table_form_sees_trailing_rows():
    # tests/test_pallas_walk.py:198-234 on the port: a 100-segment square
    # whose right edge is the table's last three rows; walkers that missed
    # them would leave the domain and bank far-field values of x + 2y
    pts = []

    def edge(a, b, n, include_start):
        for k in range(0 if include_start else 1, n + 1):
            t = k / n
            pts.append([a[0] + t * (b[0] - a[0]), a[1] + t * (b[1] - a[1])])

    edge((1, 1), (-1, 1), 32, True)
    edge((-1, 1), (-1, -1), 32, False)
    edge((-1, -1), (1, -1), 33, False)
    edge((1, -1), (1, 1), 3, False)
    prob = Problem(dirichlet=Polyline.from_points(pts),
                   bc_dirichlet=lambda x, y: x + 2 * y,
                   alpha=fields.constant(1.0))
    assert prob.dirichlet.num_segments == 100
    solver = WoStSolver(prob, SolverOptions(target_slots=1024,
                                            pallas_block_rows=8),
                        device="cpu")
    state, params, _, _ = solver._setup(np.zeros((1, 2)), 128, 60, 1e-3, 0)
    assert params.table
    res = solver.solve(np.array([[0.0, 0.0]]), n_walks=128, max_steps=60,
                       eps=1e-3, seed=0)
    assert abs(float(res.mean[0])) < 4 * float(res.stderr[0]) + 0.05
    wk.walk_plain(state, params, 60)
    inside = 1.0 + 1e-5  # a ball touching the wall may round past it
    assert (state["px"].abs() <= inside).all()
    assert (state["py"].abs() <= inside).all()
