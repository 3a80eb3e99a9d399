"""Streaming and adaptive solves of the port (``solver/stream.py``).

The seven tests of ``tests/test_stream.py`` on the port's CPU path, with
their configurations and bounds: batches of walks merged by their raw
``(sum, sumsq)`` moments, the seed stride ``seed + 1000003 * batch``, the
resume checks and the stop rules of ``solve_to_tolerance``. The harmonic
``x + 2y`` and the others run without delta tracking. One more test holds
a one-batch stream to the JAX package's stream on the same problem: the
same counter-hash streams, so equal total steps and means to 4e-6 of their
scale (float32 moments summed in another order). The last holds the
card's per-point moment sums (``solver/state.py::point_sums``: float64
prefix sums of the lanes sorted by point, without atomics, so one seed
gives one answer there) to lane-order sums on the CPU.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu import WoStSolver as JSolver
from dcrmontecarlo_tpu import square_loop as j_square
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import solve_stream as j_solve_stream
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, StreamState, \
    WoStSolver, solve_stream, solve_to_tolerance

torch.set_num_threads(1)

X_PLUS_2Y = {(1, 0): 1.0, (0, 1): 2.0}


def _solver(bc=X_PLUS_2Y, target_slots=2048):
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=fields.polynomial(bc))
    return WoStSolver(prob, SolverOptions(target_slots=target_slots),
                      device="cpu")


def test_stream_matches_single_solve_statistics():
    solver = _solver()
    pts = np.array([[0.0, 0.0], [0.4, -0.2]])
    res = solve_stream(solver, pts, n_walks_total=4000, batch_walks=1000,
                       max_steps=200, eps=1e-3, seed=0)
    assert res.n_walks == 4000
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    err = np.abs(res.mean - exact)
    assert (err < 4 * res.stderr + 5e-3).all(), (res.mean, exact, res.stderr)
    direct = solver.solve(pts, n_walks=4000, max_steps=200, eps=1e-3, seed=9)
    ratio = res.stderr / np.maximum(direct.stderr, 1e-12)
    assert (ratio > 0.5).all() and (ratio < 2.0).all(), ratio


def test_stream_callback_and_partial_results():
    solver = _solver()
    seen = []
    solve_stream(solver, np.array([[0.1, 0.1]]), n_walks_total=900,
                 batch_walks=300, max_steps=100, eps=1e-3, seed=1,
                 callback=lambda i, r: seen.append((i, r.n_walks)))
    assert seen == [(1, 300), (2, 600), (3, 900)]


def test_stream_resume():
    solver = _solver()
    pts = np.array([[0.2, -0.1]])
    solve_stream(solver, pts, n_walks_total=600, batch_walks=300,
                 max_steps=100, eps=1e-3, seed=2)
    state = solver._stream_state
    assert isinstance(state, StreamState)
    full = solve_stream(solver, pts, n_walks_total=1200, batch_walks=300,
                        max_steps=100, eps=1e-3, seed=2, state=state)
    assert full.n_walks == 1200
    assert full.iterations == 4  # 2 resumed + 2 new batches
    assert abs(full.mean[0] - 0.0) < 4 * full.stderr[0] + 5e-3
    # resuming at other points, or with another source count, raises
    with pytest.raises(ValueError, match="different evaluation points"):
        solve_stream(solver, np.array([[0.3, 0.0]]), n_walks_total=1500,
                     batch_walks=300, max_steps=100, eps=1e-3, seed=2,
                     state=state)
    bad = StreamState(sum=np.zeros((2, 1)), sumsq=np.zeros((2, 1)),
                      n_walks=300, batches=1, points=state.points)
    with pytest.raises(ValueError, match="moment shape"):
        solve_stream(solver, pts, n_walks_total=600, batch_walks=300,
                     max_steps=100, eps=1e-3, seed=2, state=bad)


def test_stream_single_batch_exactly_matches_direct_solve():
    solver = _solver()
    pts = np.array([[0.0, 0.0], [0.4, -0.2]])
    direct = solver.solve(pts, n_walks=1000, max_steps=200, eps=1e-3, seed=0)
    stream = solve_stream(solver, pts, n_walks_total=1000, batch_walks=1000,
                          max_steps=200, eps=1e-3, seed=0)
    np.testing.assert_array_equal(solver._stream_state.sum, direct.walk_sum)
    np.testing.assert_array_equal(solver._stream_state.sumsq,
                                  direct.walk_sumsq)
    np.testing.assert_allclose(stream.mean, direct.mean, rtol=2e-7)
    np.testing.assert_allclose(stream.stderr, direct.stderr, rtol=2e-6)


def test_solve_to_tolerance_reaches_target():
    solver = _solver(target_slots=4096)
    pts = np.array([[0.0, 0.0], [0.4, -0.2]], np.float32)
    seen = []
    res = solve_to_tolerance(solver, pts, target_stderr=8e-3,
                             batch_walks=1024, max_walks=1 << 17,
                             max_steps=300, eps=1e-3, seed=5,
                             callback=lambda i, r: seen.append(
                                 r.stderr.max()))
    assert res.stderr.max() <= 8e-3, res.stderr
    assert res.iterations > 1, res.iterations
    assert seen[0] > 8e-3
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    dev = np.abs(res.mean - exact) / np.maximum(res.stderr, 1e-12)
    assert (dev < 4.0).all(), (res.mean, exact, dev)


def test_solve_to_tolerance_relative_floor_terminates():
    solver = _solver(bc={(1, 0): 1.0}, target_slots=4096)
    res = solve_to_tolerance(solver, np.array([[0.0, 0.0]], np.float32),
                             target_stderr=0.05, relative=True,
                             relative_floor=1.0, batch_walks=512,
                             max_walks=1 << 16, max_steps=300, eps=1e-3,
                             seed=7)
    assert res.stderr.max() <= 0.05
    assert res.n_walks < (1 << 16)


def test_solve_to_tolerance_budget_cap_and_resume():
    solver = _solver(bc={(2, 0): 1.0, (0, 2): -1.0}, target_slots=4096)
    pts = np.array([[0.2, 0.1]], np.float32)
    res = solve_to_tolerance(solver, pts, target_stderr=1e-9,
                             batch_walks=1024, max_walks=2048,
                             max_steps=300, eps=1e-3, seed=3)
    assert res.n_walks == 2048
    st = solver._stream_state
    res2 = solve_to_tolerance(solver, pts, target_stderr=1.0,
                              batch_walks=1024, max_walks=2048,
                              max_steps=300, eps=1e-3, seed=3, state=st)
    assert res2.n_walks == 2048
    res3 = solve_to_tolerance(solver, pts,
                              target_stderr=res.stderr.max() * 0.7,
                              batch_walks=1024, max_walks=1 << 14,
                              max_steps=300, eps=1e-3, seed=3, state=st)
    assert res3.n_walks > 2048
    assert res3.stderr.max() <= res.stderr.max() * 0.7


def test_stream_matches_jax_stream():
    pts = np.array([[0.0, 0.0], [0.4, -0.2]], np.float32)
    opts = dict(target_slots=256, pallas_block_rows=8)
    jprob = JProblem(dirichlet=j_square(1.0),
                     bc_dirichlet=lambda x, y: x + 2.0 * y)
    want = j_solve_stream(JSolver(jprob, JOptions(backend="xla", **opts)),
                          pts, n_walks_total=128, batch_walks=64,
                          max_steps=60, eps=1e-3, seed=4)
    got = solve_stream(
        WoStSolver(Problem(dirichlet=square_loop(1.0),
                           bc_dirichlet=fields.polynomial(X_PLUS_2Y)),
                   SolverOptions(**opts), device="cpu"),
        pts, n_walks_total=128, batch_walks=64, max_steps=60, eps=1e-3,
        seed=4)
    scale = np.abs(np.asarray(want.mean)).max()
    np.testing.assert_allclose(got.mean, np.asarray(want.mean), rtol=0,
                               atol=4e-6 * scale)
    assert got.total_steps == float(want.total_steps)
    assert got.n_walks == want.n_walks == 128


def test_card_point_sums_match_lane_order_sums():
    # the card's per-point moment sums (float64 prefix sums) against
    # the CPU's index_add_ on seeded lanes: to float32 rounding of sums of
    # up to 65,536 terms (rel 1e-5 of the largest |sum|), empty points 0
    from dcrmontecarlo_tpu_torch.solver.state import _prefix_sums

    rng = np.random.default_rng(0)
    for n, m in ((3, 196608), (21, 5000), (652, 70000), (4, 0)):
        pid = torch.from_numpy(rng.integers(0, n - 1, m))
        v = torch.from_numpy((rng.standard_normal((2, m)) * 100).astype(
            np.float32))
        want = torch.zeros(2, n, dtype=torch.float64).index_add_(
            1, pid, v.double())
        got = _prefix_sums(torch.zeros(2, n), pid, v)
        scale = max(float(want.abs().max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale)
        assert (got[:, n - 1] == 0.0).all()
