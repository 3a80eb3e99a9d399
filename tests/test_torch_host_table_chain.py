"""The table chain, run on the CPU, bit for bit.

``csrc/walk_kernel.cu``'s table chain ``<1,false,false,false,true,true,
false>`` (the Robin chain on a table geometry, ``chip_smoke.py`` phase
48's terrain over shallow bodies) takes its chord frame by chunks of the
Neumann rows, from the chunk of the least box distance outward, skipping a
chunk whose box proves that no row of it can win
(``walk_kernel.culled_chord``). The host compiler builds it
(``tests/host_cuda/``) as shipped and without that hook
(``host_walk.PLAIN_LOOP``: the full chord frame, the loop it ran
before). On phase 48's configuration at the test size of
``tests/test_topography.py`` (102 rows, Robin ``"auto"`` resolving to the
chain) and on a staircase terrain of 100 rows over a shallow conductor
(axis-aligned walls, integer corners: hit points lie exactly on their
walls), with quotas of 0, 1, 3 and 6 walks a lane: a launch that drains
every quota and launches of budgets that leave walks mid-way equal the
hookless build on every plane bit for bit, the shipped build's single
launch equals its own 64-step launches until drained, and on the
staircase a launch of a walk a lane follows ``walk_plain`` by
``compare_planes``. A probe holds
the culled chord frame to the full one on the chunk boxes' corners and
edges, the rows' ends and midpoints, each one float either way, and
random points, with the skip test as shipped and with every chunk visited
in the culled order (``FULL_SCANS``): tangent and chord extents bit for
bit, the first row on ties.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build

torch.set_num_threads(1)

_F, _T = False, True
CHAIN = (1, _F, _F, _F, _T, _T, _F, _F, _F)
QUOTAS = (0, 1, 3, 6)

# the culled chord frame against the full scan on chosen points: in[n x
# 2]; out[n x 8]: tx, ty, s_lo, s_hi of chord_frame<true>, of
# chord_frame_culled
PROBE = r"""
extern "C" int walk_chord_probe(int n, const float* in, float* out) {
  for (int k = 0; k < n; ++k) {
    float* o = out + 8 * k;
    chord_frame<true>(in[2 * k], in[2 * k + 1], o[0], o[1], o[2], o[3]);
    chord_frame_culled(in[2 * k], in[2 * k + 1], o[4], o[5], o[6], o[7]);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{kind: walk}``: the table chain as shipped ("own", with the
    probe), without its hook ("plain") and with every chunk visited
    ("full", with the probe)."""
    tmp = tmp_path_factory.mktemp("table_chain")
    started = {"own": start_build(tmp, CHAIN, False, extra=PROBE),
               "plain": start_build(tmp, CHAIN, False, plain_loop=True),
               "full": start_build(tmp, CHAIN, False, True, PROBE)}
    return {k: load(b, CHAIN) for k, b in started.items()}


def _staircase():
    """A terrain of 4 m steps every 8 m (100 rows, exact hit points) over
    a conductor 10 m down, ten times the background: the chain acts."""
    pts = [[-100.0, 0.0]]
    x = -100.0
    while x < 100.0:
        x = min(x + 8.0, 100.0)
        pts.append([x, pts[-1][1]])
        if x < 100.0:
            pts.append([x, 4.0 - pts[-1][1]])
    pts = np.array(pts, np.float32)
    box = [[-100.0, float(pts[0, 1])], [-100.0, -150.0], [100.0, -150.0],
           [100.0, float(pts[-1, 1])]]
    alpha = fields.bump_sum(1e-2, [(9e-2, fields.smooth_circle(
        (-12.0, -16.0), 8.0, 0.5))])
    return (Problem(dirichlet=Polyline.from_points(box),
                    neumann=Polyline.from_points(pts),
                    bc_dirichlet=fields.constant(0.0),
                    source=fields.gaussian_dipole((-20.0, -1.5),
                                                  (20.0, -1.5), 1.0, 0.5),
                    alpha=alpha),
            np.stack([np.arange(-40.0, 41.0, 10.0), np.full(9, -0.7)],
                     1).astype(np.float32),
            SolverOptions(target_slots=384, min_quota=1,
                          robin_correction="chain"))


CASES = {
    "shallow_terrain": lambda: cs.shallow_terrain_config(
        half_width=100.0, depth=150.0, resolution=4.0)[:2] + (
        SolverOptions(target_slots=384, min_quota=1),),
    "staircase": _staircase,
}


def _state(name, max_steps=60):
    """``(state, params)``: fresh lanes of ``name``'s case, quotas 0, 1, 3
    and 6 in turn."""
    prob, pts, options = CASES[name]()
    solver = WoStSolver(prob, options, device="cpu")
    assert solver._robin_enabled() == "chain"
    state, params, _, _ = solver._setup(pts, 64, max_steps, 0.5, 3)
    assert params.variant == CHAIN and params.table
    n = state["px"].numel()
    state["quota"] = torch.tensor(QUOTAS, dtype=torch.int32).repeat(
        n // len(QUOTAS) + 1)[:n].view_as(state["quota"]).clone()
    return state, params


def _equal(a, b, params, what):
    for k in state_planes(params.n_src):
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("name", list(CASES))
def test_draining_launch_equals_the_plain_loop(builds, name):
    state, params = _state(name)
    budget = int(state["quota"].max()) * (params.max_steps + 1)
    own, plain, drained, ref = (cs.clone_state(state) for _ in range(4))
    builds["own"](own, params, budget, float("inf"))
    builds["plain"](plain, params, budget, float("inf"))
    _equal(own, plain, params, "single launch")
    assert int(own["quota"].max()) == 0
    assert torch.equal(own["ndone"] - state["ndone"], state["quota"])
    launches = 0
    while bool((drained["quota"] > 0).any()):
        builds["own"](drained, params, 64, float("inf"))
        launches += 1
    assert launches > 1
    _equal(own, drained, params, "64-step launches")
    if name == "staircase":  # a walk a lane against the plain walk
        ref["quota"].clamp_(max=1)
        mine = cs.clone_state(ref)
        builds["own"](mine, params, params.max_steps + 1, float("inf"))
        wk.walk_plain(ref, params, params.max_steps + 1)
        frac, _, finite = wk.compare_planes(mine, ref,
                                            state_planes(params.n_src))
        assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("name,cut", [("shallow_terrain", 61),
                                      ("shallow_terrain", 17),
                                      ("staircase", 40), ("staircase", 5)])
def test_budgeted_launches_equal_the_plain_loop(builds, name, cut):
    state, params = _state(name)
    own, plain = cs.clone_state(state), cs.clone_state(state)
    for _ in range(3):
        builds["own"](own, params, cut, float("inf"))
        builds["plain"](plain, params, cut, float("inf"))
        _equal(own, plain, params, f"budget {cut}")
    assert int((own["life"] - state["life"]).sum()) > 0


def test_the_chain_acts_and_the_launch_takes_the_chunk_records():
    # the chain changes the walks of phase 48's configuration (Robin off
    # moves them), and its launches read the Neumann rows' chunk records
    state, params = _state("shallow_terrain", max_steps=20)
    assert wk.culled_chord(params.variant)
    assert not (wk.culled_scans(params.variant)
                or wk.culled_closest(params.variant))
    recs = params.chunk_table("cpu")
    assert recs is not None and tuple(recs.shape) == (
        -(-len(params.neu_table) // wk.CHUNK_ROWS), 8)
    state["quota"].clamp_(max=1)
    budget = params.max_steps + 1
    chain, off = cs.clone_state(state), cs.clone_state(state)
    wk.walk_plain(chain, params, budget)
    wk.walk_plain(off, dataclasses.replace(params, robin=wk.ROBIN_OFF),
                  budget)
    assert cs.lanes_differ(chain, off, ("asum0", "life")) > 0.01


def _probe(walk, params, state, points):
    """The probe on ``points`` after a zero-step launch on ``state`` has
    written ``params`` to the library's constant block."""
    walk(cs.clone_state(state), params, 0, float("inf"))
    points = np.ascontiguousarray(points, np.float32)
    out = np.zeros((len(points), 8), np.float32)
    walk.lib.walk_chord_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
    assert walk.lib.walk_chord_probe(len(points), points.ctypes.data,
                                     out.ctypes.data) == 0
    return out


def _points(params, rng):
    """Chunk boxes' corners and edge midpoints, the rows' ends and
    midpoints, each one float either way, and random points around the
    rows."""
    rec = wk.chunk_records(params.neu_table)
    rows = params.neu_table
    pts = [rec[:, [0, 1]], rec[:, [2, 3]], rec[:, [0, 3]], rec[:, [2, 1]],
           0.5 * (rec[:, [0, 1]] + rec[:, [2, 1]]), rows[:, :2], rows[:, 2:4],
           0.5 * (rows[:, :2] + rows[:, 2:4])]
    pts = np.concatenate(pts).astype(np.float32)
    near = [np.nextafter(pts, np.float32(np.inf)),
            np.nextafter(pts, np.float32(-np.inf))]
    lo, hi = rows[:, :4].reshape(-1, 2).min(0), rows[:, :4].reshape(
        -1, 2).max(0)
    rand = rng.uniform(lo - 20.0, hi + 20.0, (3000, 2)).astype(np.float32)
    below = pts + rng.uniform(-3.0, 3.0, pts.shape).astype(np.float32)
    return np.concatenate([pts, *near, below, rand]).astype(np.float32)


@pytest.mark.parametrize("kind", ["own", "full"])
@pytest.mark.parametrize("name", list(CASES))
def test_culled_chord_frame_is_the_full_scans(builds, name, kind):
    state, params = _state(name)
    points = _points(params, np.random.default_rng(11))
    out = _probe(builds[kind], params, state, points)
    # tangent and chord extents: the same bits
    assert np.array_equal(out[:, :4].view(np.uint32),
                          out[:, 4:].view(np.uint32)), name


def _tie_rows():
    """Rows whose first chunk ties with a later one of a nearer box: the
    top of the square [-1, 1]^2 in 8 rows (chunk 0, its box 1 from the
    centre), then the right side and the bottom in 4 rows each (chunk 1,
    its box holding the centre), then the left side in 8 (chunk 2)."""
    def side(a, b, n):
        return [[a[0] + k / n * (b[0] - a[0]), a[1] + k / n * (b[1] - a[1]),
                 a[0] + (k + 1) / n * (b[0] - a[0]),
                 a[1] + (k + 1) / n * (b[1] - a[1])] for k in range(n)]
    return np.asarray(side((-1, 1), (1, 1), 8) + side((1, 1), (1, -1), 4)
                      + side((1, -1), (-1, -1), 4)
                      + side((-1, -1), (-1, 1), 8), np.float32)


@pytest.mark.parametrize("kind", ["own", "full"])
def test_culled_chord_frame_takes_the_first_row_of_a_tie(builds, kind):
    # from the centre every side lies 1 away: chunk 1's box (distance 0)
    # is visited first and gives a row of d2 = 1, then chunk 0's row 3
    # (its foot (0, 1) at its end, t = 1) ties it and, the first in row
    # order, wins, as in the full scan: tangent (1, 0), extents [-0.25, 0]
    state, params = _state("staircase")
    params = dataclasses.replace(params, neu_table=_tie_rows())
    pts = np.array([[0.0, 0.0], [0.0, 0.25], [0.5, -0.5], [-0.5, 0.0]],
                   np.float32)
    got = _probe(builds[kind], params, state, pts)
    assert np.array_equal(got[:, :4].view(np.uint32),
                          got[:, 4:].view(np.uint32))
    assert tuple(got[0, 4:]) == (1.0, 0.0, -0.25, 0.0)


# a row from (-1, 0) to (BX, 0) whose foot at t = 1 rounds past BX: -1 +
# (BX + 1) is QX > BX in float32
BX, QX = np.float32(0.10012300312519073), np.float32(0.10012304782867432)


@pytest.mark.parametrize("kind", ["own", "full"])
def test_culled_chord_frame_holds_a_foot_rounded_past_its_rows(builds, kind):
    # chunk 0: eight copies of that row; chunk 1: eight copies of a
    # vertical row at x = 1 - QX. From (0.5, 0) both give d2 = (0.5 -
    # QX)^2 (every operation exact but the row's foot), and the full scan
    # keeps row 0. Chunk 1's box lies at that distance, chunk 0's rows' box
    # farther (0.5 - BX) but its foot nearer: only the box widened past
    # the rounded foot keeps chunk 0 from being skipped, so that row 0
    # wins the tie: tangent (1, 0), extents [-|u|, 0]
    assert np.float32(np.float32(-1.0) + np.float32(BX + np.float32(1.0))) \
        == QX > BX
    state, params = _state("staircase")
    x1 = np.float32(1.0) - QX
    rows = np.asarray([[-1.0, 0.0, BX, 0.0]] * 8 + [[x1, -1.0, x1, 1.0]] * 8,
                      np.float32)
    params = dataclasses.replace(params, neu_table=rows)
    got = _probe(builds[kind], params, state,
                 np.array([[0.5, 0.0]], np.float32))
    assert np.array_equal(got[:, :4].view(np.uint32),
                          got[:, 4:].view(np.uint32))
    assert (got[0, 4], got[0, 5], got[0, 7]) == (1.0, 0.0, 0.0)
