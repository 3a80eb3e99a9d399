"""The culled table variant's large-table build, run on the CPU, bit for bit.

``csrc/walk_kernel.cu``'s large-table build (``WALK_LARGE``, which the
host asks for from ``walk_kernel.LARGE_TABLE_ROWS`` rows,
``walk_kernel.large_scans``) culls the silhouette by chunk and group
records (box distance against the running minimum, and an oriented cone:
``sil_skips``) and skips groups of the first hit's chunks
(``group_skips``). Here the host compiler builds it
(``tests/host_cuda/host_walk.py``) as shipped and with every skip test
replaced by ``false`` (``FULL_SCANS``: every row in row order, the
silhouette from 3e38), and the culled build beside them. Whole launches
on the comb terrain of 16,512 rows and on the topographic survey over a
5 cm DEM (16,002 rows) are equal in the three builds on every lane and
plane; on the comb, whose axis-aligned walls the CPU's math libraries
cross alike, the two large-table builds follow ``walk_plain`` by
``compare_planes`` (on the sloped DEM the two libraries'
transcendentals desynchronize walks, ``test_torch_silhouette.py``). A
probe of the scans on chosen lanes holds the shipped star radius, first
hit and its row to the full scans' bit for bit: points on the records'
box corners, on a vertex row's segment line and one float off it, rays
at the rows shared by two chunks and two groups, the Dirichlet distance
at a silhouette vertex's distance and one float either side.
"""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build
from test_torch_host_culled_scans import SURVEY
from test_torch_host_large_table import _comb

torch.set_num_threads(1)

LANES = 256

# the scans on chosen lanes: in[n x 7] (px, py, dx, dy, tmw, lim, and the
# Dirichlet distance the star radius takes, or -1 for the lane's own);
# out[n x 10]: dD, cx, cy, the star radius's min(dD, silhouette) by the
# build's scan and by the culled build's (silhouette<true>), the first
# hit's t within lim, its normal and hit point
PROBE = r"""
extern "C" int walk_large_probe(int n, const float* in, float* out) {
  for (int lane = 0; lane < n; ++lane) {
    const float* q = in + 7 * lane;
    float* o = out + 10 * lane;
    float cx, cy;
    const float dD = closest_point<true>(q[0], q[1], cx, cy);
    const float dS = q[6] >= 0.0f ? q[6] : dD;
    o[0] = dD, o[1] = cx, o[2] = cy;
    o[3] = C.n_vert > 0 ? fminf(dS, silhouette_large(q[0], q[1], dS)) : dS;
    o[4] = C.n_vert > 0 ? fminf(dS, silhouette<true>(q[0], q[1])) : dS;
    float fnx = 0.0f, fny = 0.0f, hxs = 0.0f, hys = 0.0f, t = 3e38f;
    if (C.n_neu > 0)
      t = first_hit<true>(q[0], q[1], q[2], q[3], q[4], q[5], fnx, fny, hxs,
                          hys);
    o[5] = t, o[6] = fnx, o[7] = fny, o[8] = hxs, o[9] = hys;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{name: walk}``: the large-table build as shipped and with full
    scans (both with the probe) and the culled build, compiled at once."""
    tmp = tmp_path_factory.mktemp("large_scans")
    started = dict(
        large=start_build(tmp, SURVEY, False, False, PROBE, large=True),
        full=start_build(tmp, SURVEY, False, True, PROBE, large=True),
        culled=start_build(tmp, SURVEY, False))
    return {k: load(b, SURVEY) for k, b in started.items()}


def _case(name):
    """``(state, params)``: ``LANES`` lanes at 9 points below the comb or
    the 5 cm DEM, 24 plain steps into their walks."""
    if name == "comb":
        prob = _comb()
        xs = [-63.8, -45.0, -30.0, -15.0, 0.0, 15.0, 30.0, 45.0, 63.8]
        pts = np.stack([xs, np.full(9, -0.7)], 1).astype(np.float32)
        args = (pts, LANES, 600, 0.5, 3)
    else:
        prob, h = topographic_survey_problem(resolution=0.05)
        pts = drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), nudge=0.5)
        args = (pts, LANES, 600, 0.5, 3)
    solver = WoStSolver(prob, SolverOptions(target_slots=LANES,
                                            pallas_block_rows=2),
                        device="cpu")
    state, params, _, _ = solver._setup(*args)
    assert state["px"].numel() == LANES
    wk.walk_plain(state, params, 24)
    return state, params


CASES = ("comb", "dem")


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


def test_the_large_tables_take_the_large_build(cases):
    for name, rows in (("comb", 16512), ("dem", 16002)):
        _, params = cases[name]
        n = len(params.dir_table) + len(params.neu_table) + len(
            params.vert_table)
        assert n == rows and params.variant == SURVEY
        assert params.large and wk.large_scans(
            params.variant, len(params.neu_table), len(params.vert_table))
        # the variant, its name and its launch counter stay the culled
        # build's; the library is the large-table build
        assert params.kernel_name == wk.kernel_name(SURVEY)
        assert params.build_name == wk.kernel_name(SURVEY) + " (large)"
        recs = params.chunk_table("cpu").numpy()
        np.testing.assert_array_equal(recs, wk.large_records(
            params.neu_table, params.vert_table))
        head = wk.chunk_records(params.neu_table).reshape(-1)
        np.testing.assert_array_equal(recs[:len(head)], head)


@pytest.mark.parametrize("name", CASES)
def test_large_launch_equals_full_scans_and_the_culled_build(builds, cases,
                                                             name):
    state, params = cases[name]
    out = {k: cs.clone_state(state) for k in builds}
    for k, walk in builds.items():
        walk(out[k], params, 48, float("inf"))
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(out["large"][k], out["full"][k]), k
        assert torch.equal(out["large"][k], out["culled"][k]), k
    assert int((out["large"]["life"] - state["life"]).sum()) > 0
    if name == "comb":
        plain = cs.clone_state(state)
        wk.walk_plain(plain, params, 48)
        for k in ("large", "full"):
            frac, _, finite = wk.compare_planes(out[k], plain, names)
            assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, \
                (k, frac)


def _probe(walk, params, state, lanes):
    """The probe on ``lanes`` (n x 7 float32) after a zero-step launch on
    ``state`` has written ``params`` to the library's constant block."""
    walk(cs.clone_state(state), params, 0, float("inf"))
    lanes = np.ascontiguousarray(lanes, np.float32)
    out = np.zeros((len(lanes), 10), np.float32)
    walk.lib.walk_large_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
    assert walk.lib.walk_large_probe(len(lanes), lanes.ctypes.data,
                                     out.ctypes.data) == 0
    return out


def _corners(boxes):
    """The four corners of each ``(x0, y0, x1, y1)`` box, ``(4 n, 2)``."""
    b = np.asarray(boxes, np.float32)
    return np.concatenate([b[:, [0, 1]], b[:, [2, 3]], b[:, [0, 3]],
                           b[:, [2, 1]]])


def adversarial(params, rng):
    """Lanes ``(px, py, dx, dy, tmw, lim, -1)``: on the corners of the
    records' boxes (the silhouette's chunks and groups, both boxes; the
    first hit's chunks and groups), on the lines of vertex rows' segments
    past their ends and one float off them, rays at the rows that open a
    chunk and a group, and random lanes by the boundary."""
    sil = wk.silhouette_records(params.vert_table)
    sil_g = wk.silhouette_records(params.vert_table,
                                  wk.SIL_ROWS * wk.GROUP_CHUNKS)
    hit = wk.chunk_records(params.neu_table)
    hit_g = wk.chunk_records(params.neu_table,
                             wk.CHUNK_ROWS * wk.GROUP_CHUNKS)
    # every group's corners and every seventh chunk's
    pts = [_corners(r[:, :4]) for r in (sil[::7], sil_g, hit[::7], hit_g)]
    pts += [_corners(r[:, 4:8]) for r in (sil[::7], sil_g)]
    # on the segment lines of every 37th vertex row, far past the
    # segment's ends, and one float off in x and in y
    vt = params.vert_table[::37].astype(np.float64)
    for s in (-40.0, -3.0, 2.5, 9.0):
        for a, b in ((vt[:, 0:2], vt[:, 2:4]), (vt[:, 2:4], vt[:, 4:6])):
            on = (a + s * (b - a)).astype(np.float32)
            pts += [on, np.nextafter(on, np.float32(np.inf)),
                    np.nextafter(on, np.float32(-np.inf)),
                    np.stack([on[:, 0], np.nextafter(
                        on[:, 1], np.float32(np.inf))], 1)]
    pts = np.concatenate(pts).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, len(pts))
    lanes = [np.stack([pts[:, 0], pts[:, 1], np.cos(ang), np.sin(ang),
                       np.where(np.arange(len(pts)) % 3 == 0, params.t_min,
                                0.0),
                       np.where(np.arange(len(pts)) % 2 == 0, 3e38,
                                rng.uniform(0.05, 60, len(pts))),
                       np.full(len(pts), -1.0)], 1)]
    # rays from random points at the first row of every third chunk and
    # every group (the shared endpoint of two chunks' rows: a tie the first
    # row wins)
    neu = params.neu_table
    starts = neu[::wk.CHUNK_ROWS * 3, :2].astype(np.float64)
    starts = np.concatenate([starts, neu[::wk.CHUNK_ROWS * wk.GROUP_CHUNKS,
                                         :2]]).astype(np.float64)
    src = starts + rng.uniform(-20, 20, starts.shape) - [0.0, 10.0]
    d = starts - src
    d /= np.hypot(d[:, 0], d[:, 1])[:, None]
    lanes.append(np.stack([src[:, 0], src[:, 1], d[:, 0], d[:, 1],
                           np.zeros(len(d)), np.full(len(d), 3e38),
                           np.full(len(d), -1.0)], 1))
    x = rng.uniform(neu[:, 0].min(), neu[:, 0].max(), 600)
    y = np.interp(x, neu[:, 0], neu[:, 1]) - rng.uniform(0.0, 30.0, 600)
    a = rng.uniform(0, 2 * np.pi, 600)
    lanes.append(np.stack([x, y, np.cos(a), np.sin(a), np.zeros(600),
                           rng.uniform(0.05, 80, 600), np.full(600, -1.0)],
                          1))
    return np.concatenate(lanes).astype(np.float32)


def hold(got, ref, lims, what):
    """The shipped scans against the full ones: closest point and star
    radius equal (and the star radius the culled build's); the first hit,
    its normal and hit point equal where the full one lies within the
    limit, past it otherwise."""
    for k in range(5):
        assert np.array_equal(got[:, k], ref[:, k]), (what, k)
    assert np.array_equal(got[:, 3], got[:, 4]), what
    hit = ref[:, 5] <= lims
    assert np.array_equal(got[hit, 5:], ref[hit, 5:]), what
    assert (got[~hit, 5] > lims[~hit]).all(), what


@pytest.mark.parametrize("name", CASES)
def test_scans_on_adversarial_lanes(builds, cases, name):
    state, params = cases[name]
    shipped, full = builds["large"], builds["full"]
    lanes = adversarial(params, np.random.default_rng(19))
    ref = _probe(full, params, state, lanes)
    hold(_probe(shipped, params, state, lanes), ref, lanes[:, 5], name)
    assert (ref[:, 5] < 1e30).sum() > 100
    # the star radius with the Dirichlet distance at the nearest
    # silhouette vertex's distance and one float either side
    far = lanes.copy()
    far[:, 6] = 3e38
    sil = _probe(full, params, state, far)[:, 4]
    seen = sil < 1e18
    assert seen.sum() > 100, name
    for dS in (sil, np.nextafter(sil, np.float32(0)),
               np.nextafter(sil, np.float32(np.inf))):
        sub = lanes[seen].copy()
        sub[:, 6] = dS[seen]
        got = _probe(shipped, params, state, sub)
        want = _probe(full, params, state, sub)
        hold(got, want, sub[:, 5], f"{name}: dD at the silhouette")
