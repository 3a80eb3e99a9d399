"""The two builds without delta tracking, run on the CPU, bit for bit.

``csrc/walk_kernel.cu``'s static form without delta tracking
``<0,false,false,false,false,false,false>`` (``chip_smoke.py`` phase 25's
short walk, ``walk_kernel.one_sincos``) takes its step's direction from
one ``sincosf``; its table form ``<0,false,false,false,true,false,false>``
(phase 47's Poisson bubble, ``walk_kernel.culled_closest``)
runs its closest point by chunks of rows from the chunk of the least box
distance outward, skipping the chunks whose box proves no row can win. The
host compiler builds both (``tests/host_cuda/``) as shipped and without
those hooks (``host_walk.PLAIN_LOOP``: the loop they ran before). On the
harmonic square, the 256-segment bubble and a table-form square of 128
rows on a grid of exact floats, with quotas of 0, 1, 7 and 40 walks a lane
and walks that start at a vertex (distance 0 to two rows) and where rows
tie (the centre, a point on a corner's bisector): a launch that drains
every quota and launches of budgets that leave walks mid-way or banks to
the next launch give every plane of the hookless build bit for bit (so
``sincosf`` gives the host's ``cosf`` and ``sinf`` bits on these walks'
angles), the shipped build's single launch
equals its own 256-step launches until drained, and both follow
``walk_plain`` by ``compare_planes``. A probe holds the culled closest
point to the full scan on every chunk box's corners and edges, the rows'
ends and midpoints, tied points and random points, with the skip test as
shipped and with every chunk visited in the culled order (``FULL_SCANS``):
distance and foot bit for bit, the first row on ties.
"""

import ctypes

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
SHORT = (0, _F, _F, _F, _F, _F, _F, _F, _F)
BUBBLE = (0, _F, _F, _F, _T, _F, _F, _F, _F)
QUOTAS = (0, 1, 7, 40)

# the culled closest point against the full scan on chosen points: in[n x
# 2]; out[n x 6]: dD, cx, cy of closest_point<true>, of closest_point_culled
PROBE = r"""
extern "C" int walk_closest_probe(int n, const float* in, float* out) {
  for (int k = 0; k < n; ++k) {
    float* o = out + 6 * k;
    o[0] = closest_point<true>(in[2 * k], in[2 * k + 1], o[1], o[2]);
    o[3] = closest_point_culled(in[2 * k], in[2 * k + 1], o[4], o[5]);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{(variant, kind): walk}``: each build as shipped ("own"), without
    its hooks ("plain"), and the bubble's with every chunk visited
    ("full"), the last two of the bubble's with the probe."""
    tmp = tmp_path_factory.mktemp("nodelta")
    started = {(SHORT, "own"): start_build(tmp, SHORT, False),
               (SHORT, "plain"): start_build(tmp, SHORT, False,
                                             plain_loop=True),
               (BUBBLE, "own"): start_build(tmp, BUBBLE, False, extra=PROBE),
               (BUBBLE, "plain"): start_build(tmp, BUBBLE, False,
                                              plain_loop=True),
               (BUBBLE, "full"): start_build(tmp, BUBBLE, False, True,
                                             PROBE)}
    return {k: load(b, k[0]) for k, b in started.items()}


def _grid_square(per_side=32):
    """A square of 4 m with ``per_side`` rows a side, every vertex a
    multiple of 1/8 (exact in float32): the table form, and rows that tie
    exactly."""
    c = [(2.0, 2.0), (-2.0, 2.0), (-2.0, -2.0), (2.0, -2.0)]
    pts = [[a[0] + k / per_side * (b[0] - a[0]),
            a[1] + k / per_side * (b[1] - a[1])]
           for a, b in zip(c, c[1:] + c[:1]) for k in range(per_side)]
    return Problem(dirichlet=Polyline.from_points(pts + [list(c[0])]),
                   bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 2.0}),
                   source=fields.constant(1.0))


# (problem, start points, run) of each case: the one_sincos build on the
# harmonic square (the centre ties four rows, (1, 1) and (-1, 0.25) lie on
# the boundary, a vertex and a side), the culled_closest build on the
# bubble (a vertex, the centre, a vertex's bisector) and on the grid
# square (a vertex at a chunk's end, a corner's bisector, the centre)
CASES = {
    "short_square": (SHORT, lambda: cs.short_config()[0],
                     [[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6], [1.0, 1.0],
                      [-1.0, 0.25], [0.9, -0.99]], (16, 1e-3)),
    "bubble": (BUBBLE, lambda: cs.bubble_config()[0],
               [[0.0, 0.0], [0.5, 0.0], [0.0, -0.8], [1.0, 0.0],
                [-0.7, 0.7], [0.3, -0.2]], (300, 1e-3)),
    "grid_square": (BUBBLE, _grid_square,
                    [[0.0, 0.0], [1.5, 1.5], [2.0, 1.0], [-2.0, -2.0],
                     [-1.5, 0.5], [0.25, -1.875]], (40, 1e-3)),
}


def _state(name, n_walks=64, max_steps=None):
    """``(state, params)``: fresh lanes of ``name``'s case (at another
    ``max_steps``), quotas 0, 1, 7 and 40 in turn."""
    variant, make, pts, (steps, eps) = CASES[name]
    max_steps = steps if max_steps is None else max_steps
    solver = WoStSolver(make(), SolverOptions(target_slots=384, min_quota=1),
                        device="cpu")
    state, params, _, _ = solver._setup(np.asarray(pts, np.float32),
                                        n_walks, max_steps, eps, 3)
    assert params.variant == variant
    n = state["px"].numel()
    state["quota"] = torch.tensor(QUOTAS, dtype=torch.int32).repeat(
        n // len(QUOTAS) + 1)[:n].view_as(state["quota"]).clone()
    return state, params


def _budget(state, params):
    return int(state["quota"].max()) * (params.max_steps + 1)


def _equal(a, b, params, what):
    for k in state_planes(params.n_src):
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("name", list(CASES))
def test_draining_launch_equals_the_plain_loop(builds, name):
    variant = CASES[name][0]
    state, params = _state(name)
    budget = _budget(state, params)
    own, plain, drained, ref = (cs.clone_state(state) for _ in range(4))
    builds[(variant, "own")](own, params, budget, float("inf"))
    builds[(variant, "plain")](plain, params, budget, float("inf"))
    _equal(own, plain, params, "single launch")
    assert int(own["quota"].max()) == 0
    assert torch.equal(own["ndone"] - state["ndone"], state["quota"])
    assert int((own["tn"] > 0).sum()) > 0 or name == "bubble"
    launches = 0
    while bool((drained["quota"] > 0).any()):
        builds[(variant, "own")](drained, params, 256, float("inf"))
        launches += 1
    assert launches > 1
    _equal(own, drained, params, "256-step launches")
    wk.walk_plain(ref, params, budget)
    frac, _, finite = wk.compare_planes(own, ref, state_planes(params.n_src))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("name,max_steps,cut", [
    ("short_square", 16, 256), ("short_square", 16, 7 * 17),
    ("short_square", 16, 7 * 17 - 1), ("short_square", 16, 17),
    ("short_square", 16, 5), ("short_square", 2, 21), ("short_square", 2, 20),
    ("short_square", 2, 2), ("bubble", 300, 256), ("bubble", 300, 17),
    ("grid_square", 40, 5)])
def test_budgeted_launches_equal_the_plain_loop(builds, name, max_steps,
                                                cut):
    # three launches of ``cut`` iterations: at max_steps 16 a budget of 7 x
    # 17 can drain a lane of quota 7, one less cannot; at max_steps 2 most
    # walks take all 3 iterations, so a budget of 20 leaves a quota-7
    # lane's last bank to the next launch
    variant = CASES[name][0]
    state, params = _state(name, max_steps=max_steps)
    own, plain = cs.clone_state(state), cs.clone_state(state)
    for _ in range(3):
        builds[(variant, "own")](own, params, cut, float("inf"))
        builds[(variant, "plain")](plain, params, cut, float("inf"))
        _equal(own, plain, params, f"budget {cut}")
    assert int((own["life"] - state["life"]).sum()) > 0


def _probe(walk, params, state, points):
    """The probe on ``points`` after a zero-step launch on ``state`` has
    written ``params`` to the library's constant block."""
    walk(cs.clone_state(state), params, 0, float("inf"))
    points = np.ascontiguousarray(points, np.float32)
    out = np.zeros((len(points), 6), np.float32)
    walk.lib.walk_closest_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p]
    assert walk.lib.walk_closest_probe(len(points), points.ctypes.data,
                                       out.ctypes.data) == 0
    return out


def _points(params, rng):
    """Chunk boxes' corners and edge midpoints, the rows' ends and
    midpoints, each one float either way, and random points in and around
    the boundary."""
    rec = wk.chunk_records(params.dir_table)
    rows = params.dir_table
    pts = [rec[:, [0, 1]], rec[:, [2, 3]], rec[:, [0, 3]], rec[:, [2, 1]],
           0.5 * (rec[:, [0, 1]] + rec[:, [2, 1]]), rows[:, :2], rows[:, 2:4],
           0.5 * (rows[:, :2] + rows[:, 2:4]),
           [[0.0, 0.0], [1.5, 1.5], [-1.5, 0.5], [0.5, 0.0]]]
    pts = np.concatenate(pts).astype(np.float32)
    near = [np.nextafter(pts, np.float32(np.inf)),
            np.nextafter(pts, np.float32(-np.inf))]
    lo, hi = rows.min(), rows.max()
    rand = rng.uniform(1.2 * lo, 1.2 * hi, (2000, 2)).astype(np.float32)
    return np.concatenate([pts, *near, 0.5 * pts, rand]).astype(np.float32)


@pytest.mark.parametrize("kind", ["own", "full"])
@pytest.mark.parametrize("name", ["bubble", "grid_square"])
def test_culled_closest_point_is_the_full_scans(builds, name, kind):
    state, params = _state(name)
    points = _points(params, np.random.default_rng(7))
    out = _probe(builds[(BUBBLE, kind)], params, state, points)
    # distance, foot x and y: the same bits (NaN-free here)
    assert np.array_equal(out[:, :3].view(np.uint32),
                          out[:, 3:].view(np.uint32)), name
    if name == "grid_square":
        # the first row on ties: (1.5, 1.5) is 0.5 from the top and the
        # right side, (2, 1) a vertex of two rows; the foot is the first
        # row's own
        got = _probe(builds[(BUBBLE, kind)], params, state,
                     np.array([[1.5, 1.5], [2.0, 1.0]], np.float32))
        assert got[0, 3] == 0.5 and got[1, 3] == 0.0
        assert (got[0, 4], got[0, 5]) == (1.5, 2.0)  # the top, row 3
        assert (got[1, 4], got[1, 5]) == (2.0, 1.0)


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
def test_culled_closest_point_takes_the_first_row_of_a_tie(builds, kind):
    # from the centre every side lies 1 away: chunk 1's box (distance 0)
    # is visited first and gives a row of d2 = 1, then chunk 0's row 3
    # (its foot (0, 1) at its end) ties it and, the first in row order,
    # wins, as in the full scan
    import dataclasses

    state, params = _state("grid_square")
    params = dataclasses.replace(params, dir_table=_tie_rows())
    pts = np.array([[0.0, 0.0], [0.0, 0.25], [0.5, -0.5], [-0.5, 0.0]],
                   np.float32)
    got = _probe(builds[(BUBBLE, kind)], params, state, pts)
    assert np.array_equal(got[:, :3].view(np.uint32),
                          got[:, 3:].view(np.uint32))
    assert tuple(got[0, 3:]) == (1.0, 0.0, 1.0)


def test_rules_name_one_build_each():
    # the culled_closest build is one variant, the table form without
    # delta tracking; the one_sincos builds are the static form without it
    # and the same with MIS (phase 49's, tests/
    # test_torch_host_mis_nodelta_walks.py); all off the repack and dealt
    # loops
    mis = (0, _F, _T, _F, _F, _F, _F, _F, _F)
    got = {rule: {v for v in wk.KERNEL_VARIANTS if getattr(wk, rule)(v)}
           for rule in ("one_sincos", "culled_closest")}
    assert got == {"one_sincos": {SHORT, mis}, "culled_closest": {BUBBLE}}
    for v in (SHORT, mis, BUBBLE):
        assert not (wk.repacked(v) or wk.dealt(v) or wk.culled_scans(v)
                    or wk.culled_chord(v))
