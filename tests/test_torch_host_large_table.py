"""The table form past 8,192 rows and 1,024 chunks, run on the CPU.

``csrc/walk_kernel.cu``'s table form reads its rows from global memory at
any count (the JAX package's Pallas kernel stops at the 8,192 its SMEM
holds). A comb terrain of 1/32 m teeth 1/4 m high over 129 m (8,255
Neumann segments, 8,254 vertices: 16,512 rows, 1,032 chunks of
``CHUNK_ROWS``) goes through the host compiler's build of the survey's
culled table build (``tests/host_cuda/host_walk.py``) as shipped and with
the skip test replaced by ``false`` (``FULL_SCANS``: every row in row
order); whole launches of the two are equal on every lane and plane, and
both follow ``walk_plain`` by ``compare_planes``. The comb's walls are
axis-aligned, so hit points lie exactly on them and the CPU's math
libraries cross them alike (as the staircase of
``test_torch_host_culled_scans.py``). The probe of that file holds the
shipped scans to the full ones on lanes at chunk boxes' corners and rows'
endpoints up to the last chunk. ``walk_plain``'s scans run the rows in
blocks (``walk_kernel.SCAN_ELEMS`` lane-rows a block): on the comb and on
ties between rows of different blocks they equal the one-pass scans bit
for bit.
"""

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
from test_torch_host_culled_scans import PROBE, SURVEY, _adversarial, \
    _hold, _probe

torch.set_num_threads(1)

TOOTH, HEIGHT, HALF = 1.0 / 32, 0.25, 64.5
LANES = 256


def _comb():
    """A comb of teeth ``TOOTH`` wide and ``HEIGHT`` high over
    [-``HALF``, ``HALF``] (dyadic corners, axis-aligned walls) on a box 40
    m deep, a dipole 1.5 m down."""
    n = int(round(2 * HALF / TOOTH))
    pts = [[-HALF, 0.0]]
    for k in range(1, n + 1):
        y = pts[-1][1]
        pts.append([-HALF + k * TOOTH, y])
        if k < n:
            pts.append([-HALF + k * TOOTH, HEIGHT - y])
    pts = np.array(pts, np.float32)
    box = [[-HALF, float(pts[0, 1])], [-HALF, -40.0], [HALF, -40.0],
           [HALF, float(pts[-1, 1])]]
    return Problem(
        dirichlet=Polyline.from_points(box), neumann=Polyline.from_points(pts),
        bc_dirichlet=fields.constant(0.0),
        source=fields.gaussian_dipole((-20.0, -1.5), (20.0, -1.5), 1.0, 0.5),
        alpha=fields.constant(1e2))


@pytest.fixture(scope="module")
def case():
    """``(state, params)``: ``LANES`` lanes at 9 points below the comb
    (two by its ends, past its 1,024th chunk and before its first), 24
    plain steps into their walks."""
    prob = _comb()
    xs = [-63.8, -45.0, -30.0, -15.0, 0.0, 15.0, 30.0, 45.0, 63.8]
    pts = np.stack([xs, np.full(9, -0.7)], 1).astype(np.float32)
    solver = WoStSolver(prob, SolverOptions(target_slots=LANES,
                                            pallas_block_rows=2),
                        device="cpu")
    state, params, _, _ = solver._setup(pts, LANES, 600, 0.5, 3)
    assert state["px"].numel() == LANES
    wk.walk_plain(state, params, 24)
    return state, params


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{full: walk}``: the shipped and the full-scan host builds of the
    culled variant, with the scan probe, compiled at once."""
    tmp = tmp_path_factory.mktemp("large_table")
    started = {full: start_build(tmp, SURVEY, False, full, PROBE)
               for full in (False, True)}
    return {k: load(b, SURVEY) for k, b in started.items()}


def test_comb_is_past_the_budget(case):
    _, params = case
    rows = len(params.dir_table) + len(params.neu_table) + len(
        params.vert_table)
    assert rows == 16512 > wk.MAX_SMEM_SEGMENTS
    assert params.variant == SURVEY and wk.culled_scans(params.variant)
    assert len(wk.chunk_records(params.neu_table)) == 1032 > 1024
    fp, ip = params.pack()
    assert ip[9] == 8255 and ip[17] == 8254


def test_large_launch_equals_full_scans_and_follows_plain(builds, case):
    state, params = case
    culled, full, plain = (cs.clone_state(state) for _ in range(3))
    builds[False](culled, params, 48, float("inf"))
    builds[True](full, params, 48, float("inf"))
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(culled[k], full[k]), k
    assert int((culled["life"] - state["life"]).sum()) > 0
    # walkers stand by the comb's chunks past the 1,024th
    assert float(culled["px"].max()) > float(
        params.neu_table[1025 * wk.CHUNK_ROWS, 0])
    wk.walk_plain(plain, params, 48)
    frac, _, finite = wk.compare_planes(culled, plain, names)
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


def test_scans_on_adversarial_lanes_to_the_last_chunk(builds, case):
    state, params = case
    lanes = _adversarial(params, np.random.default_rng(11))
    # every eighth lane, and all lanes over the last 40 chunks
    last = lanes[:, 0] >= params.neu_table[-40 * wk.CHUNK_ROWS, 0]
    lanes = lanes[(np.arange(len(lanes)) % 8 == 0) | last]
    assert last.sum() > 100
    ref = _probe(builds[True], params, state, lanes)
    _hold(_probe(builds[False], params, state, lanes), ref, lanes[:, 5],
          "comb")


def _scans(params, px, py, dx, dy, r):
    """Every plain scan's outputs at these lanes."""
    out = [*wk._closest_point(params, px, py),
           *wk._first_hit(params, px, py, dx, dy, r, params.t_min),
           *wk._chord_frame(params, px, py)]
    if len(params.vert_table):
        out.append(wk._silhouette(params, px, py))
    return out


@pytest.mark.parametrize("rows_a_block", [1, 7, 1000])
def test_blockwise_scans_equal_one_pass_on_the_comb(case, monkeypatch,
                                                    rows_a_block):
    state, params = case
    px, py = state["px"].reshape(-1), state["py"].reshape(-1)
    ang = torch.rand(px.shape, generator=torch.Generator().manual_seed(2))
    dx, dy = torch.cos(6.2831853 * ang), torch.sin(6.2831853 * ang)
    r = torch.full_like(px, 30.0)
    one = _scans(params, px, py, dx, dy, r)
    assert len(wk._row_blocks(LANES, 16512)) == 1  # one pass
    monkeypatch.setattr(wk, "SCAN_ELEMS", LANES * rows_a_block)
    assert len(wk._row_blocks(LANES, 8255)) == -(-8255 // rows_a_block)
    for a, b in zip(one, _scans(params, px, py, dx, dy, r)):
        assert torch.equal(a, b)


def _tie_params(params, first_above):
    """Table rows with ties across blocks of 4 rows: two Dirichlet rows at
    y = +1 and y = -1 and two Neumann rows crossing at (1, 0) (a vertical
    one and a diagonal), each pair 5 rows apart, the rest far away."""
    far = np.array([[50.0 + k, 50.0, 51.0 + k, 50.0] for k in range(12)],
                   np.float32)
    up, down = [-1.0, 1.0, 1.0, 1.0], [-1.0, -1.0, 1.0, -1.0]
    vert, diag = [1.0, -1.0, 1.0, 1.0], [0.0, -1.0, 2.0, 1.0]
    dirt, neu = far.copy(), far.copy()
    dirt[2], dirt[7] = (up, down) if first_above else (down, up)
    neu[3], neu[8] = (vert, diag) if first_above else (diag, vert)
    return dataclasses.replace(params, dir_table=dirt, neu_table=neu,
                               vert_table=params.vert_table[:0])


@pytest.mark.parametrize("first_above", [True, False])
def test_blockwise_scans_keep_the_first_row_of_a_tie(case, monkeypatch,
                                                     first_above):
    _, params = case
    tie = _tie_params(params, first_above)
    px, py = torch.zeros(3), torch.zeros(3)
    dx, dy = torch.ones(3), torch.zeros(3)
    r = torch.full((3,), 5.0)
    one = _scans(tie, px, py, dx, dy, r)
    monkeypatch.setattr(wk, "SCAN_ELEMS", 3 * 4)  # 4 rows a block
    blocks = _scans(tie, px, py, dx, dy, r)
    for a, b in zip(one, blocks):
        assert torch.equal(a, b)
    dD, cx, cy = blocks[:3]
    assert torch.equal(dD, torch.ones(3)) and torch.equal(cx, torch.zeros(3))
    assert torch.equal(cy, torch.full((3,), 1.0 if first_above else -1.0))
    hx, hy, nx, ny, t_hit, hit = blocks[3:9]
    assert bool(hit.all()) and torch.equal(t_hit, torch.ones(3))
    assert torch.equal(hx, torch.ones(3)) and torch.equal(hy, torch.zeros(3))
    # the vertical row's normal faces the ray: (-1, 0); the diagonal's
    # (-1, 1) / sqrt(2)
    assert torch.equal(nx, torch.full((3,), -1.0)) == first_above
    tx, ty = blocks[9:11]
    assert bool((tx.abs() > 0).all())  # a tangent was taken
