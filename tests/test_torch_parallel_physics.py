"""The physics of the JAX package's sharded solver tests on the port.

``tests/test_parallel.py`` (analytic and Poisson solutions, agreement with
the single-device solver, mesh sizes 1, 2 and 4, several sources, common
random numbers tightening differences, the split unbiased, boundary-snap
starts on the wall, the progress callback) and the sharded truncation
count of ``tests/test_diagnostics.py:176-220``, on the port's plain walk
with CPU shards, at reduced walk counts and the JAX tests' own bounds.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, make_mesh
from dcrmontecarlo_tpu_torch.problems import Problem
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver

torch.set_num_threads(1)

LINEAR = lambda x, y: x + 2.0 * y


def _mesh(n):
    return make_mesh(n, device="cpu")


def _square(bc=LINEAR, side=1.0, **kw):
    return Problem(dirichlet=square_loop(side), bc_dirichlet=bc, **kw)


def test_sharded_matches_analytic():
    pts = np.array([[0.0, 0.0], [0.5, 0.3], [-0.7, -0.2]])
    res = ShardedWoStSolver(_square(LINEAR), _mesh(8), SolverOptions(
        target_slots=2048)).solve(pts, n_walks=1000, max_steps=200,
                                  eps=1e-3, seed=0)
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 5e-3).all()
    assert res.total_steps > 0


def test_sharded_poisson_source():
    prob = _square(lambda x, y: x * x + y * y, 2.0,
                   source=lambda x, y: -4.0 + 0.0 * x)
    pts = np.array([[0.0, 0.0], [1.0, 0.5]])
    res = ShardedWoStSolver(prob, _mesh(8), SolverOptions(
        target_slots=2048)).solve(pts, n_walks=1000, max_steps=300,
                                  eps=1e-3, seed=1)
    exact = pts[:, 0] ** 2 + pts[:, 1] ** 2
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 0.02).all()


def test_sharded_agrees_with_single_device():
    prob = _square(lambda x, y: x * x - y * y)
    pts = np.array([[0.2, 0.1], [-0.4, 0.5]])
    kw = dict(n_walks=1000, max_steps=200, eps=1e-3, seed=0)
    single = WoStSolver(prob, SolverOptions(target_slots=1024),
                        device="cpu").solve(pts, **kw)
    sharded = ShardedWoStSolver(prob, _mesh(8), SolverOptions(
        target_slots=1024)).solve(pts, **kw)
    err = np.abs(single.mean - sharded.mean)
    assert (err < 4.0 * np.sqrt(single.stderr ** 2 + sharded.stderr ** 2)
            + 1e-4).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_subset_sizes(n):
    mesh = _mesh(n)
    assert mesh.devices.size == n and mesh.axis_names == ("walkers",)
    assert mesh.local_shards == list(range(n))
    solver = ShardedWoStSolver(_square(lambda x, y: x + y), mesh,
                               SolverOptions(target_slots=512))
    res = solver.solve(np.array([[0.1, -0.1]]), n_walks=500, max_steps=100,
                       eps=1e-3, seed=0)
    assert np.isfinite(res.mean).all()
    assert len(solver.last_solve_stats["shard_launches"]) == n


def test_sharded_multi_source():
    prob = _square(lambda x, y: x * x + y * y, 2.0,
                   source=[lambda x, y: -4.0 + 0.0 * x,
                           lambda x, y: 0.0 * x])
    pts = np.array([[0.0, 0.0], [1.0, 0.5]])
    res = ShardedWoStSolver(prob, _mesh(8), SolverOptions(
        target_slots=2048)).solve(pts, n_walks=1000, max_steps=300,
                                  eps=1e-3, seed=0)
    assert res.mean.shape == (2, 2)
    exact = pts[:, 0] ** 2 + pts[:, 1] ** 2
    assert (np.abs(res.mean[0] - exact) < 4.0 * res.stderr[0] + 0.02).all()
    assert np.isfinite(res.mean[1]).all()


def test_sharded_crn_tightens_differences():
    pts = np.array([[0.3, 0.2], [0.31, 0.2]])
    res = ShardedWoStSolver(_square(), _mesh(8), SolverOptions(
        target_slots=2048, common_random_numbers=True)).solve(
        pts, n_walks=1000, max_steps=200, eps=1e-3, seed=0)
    exact = pts[:, 0] + 2 * pts[:, 1]
    assert (np.abs(res.mean - exact) < 4 * res.stderr + 5e-3).all()
    d_est, d_exact = res.mean[1] - res.mean[0], exact[1] - exact[0]
    quad = np.sqrt(res.stderr[0] ** 2 + res.stderr[1] ** 2)
    assert abs(d_est - d_exact) < max(0.7 * quad, 1e-3), (d_est, quad)


def test_sharded_split_threshold_unbiased():
    prob = _square(lambda x, y: 1.0 + x * y, 2.0,
                   alpha=lambda x, y: 1.0 + 3.0 * torch.exp(
                       -((x * x + y * y) / 0.18)))
    pts = np.array([[0.0, 0.0], [0.4, 0.2]], np.float32)
    res = {}
    for thr in (None, 1.5):
        s = ShardedWoStSolver(prob, _mesh(4), SolverOptions(
            target_slots=1024, pallas_inner_steps=16, pallas_block_rows=8,
            split_threshold=thr))
        res[thr] = s.solve(pts, n_walks=240, max_steps=200, eps=2e-2, seed=9)
        assert (s.last_solve_stats["clones"] > 0) == (thr is not None)
    a, b = res[None], res[1.5]
    dev = np.abs(a.mean - b.mean) / np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps


def test_sharded_boundary_snap_on_wall_starts():
    # near-wall points snap onto the Neumann wall and start on it; the
    # separable exact solution u = x/5 for alpha = exp(k y)
    corners = [[-5.0, 0.0], [-5.0, -10.0], [5.0, -10.0], [5.0, 0.0]]
    prob = Problem(dirichlet=Polyline.from_points(corners),
                   neumann=Polyline.from_points([[-5.0, 0.0], [5.0, 0.0]]),
                   bc_dirichlet=lambda x, y: x / 5.0,
                   alpha=lambda x, y: torch.exp(0.5 * y) + 0.0 * x)
    pts = np.array([[-3.0, -0.008], [3.0, -0.004]], np.float32)
    exact = pts[:, 0] / 5.0
    for seed, thr in ((5, None), (6, 4.0)):
        s = ShardedWoStSolver(prob, _mesh(4), SolverOptions(
            target_slots=2048, robin_correction="chain",
            split_threshold=thr))
        r = s.solve(pts, n_walks=200, max_steps=1500, eps=0.02, seed=seed)
        dev = np.abs(r.mean - exact) / np.maximum(r.stderr, 1e-12)
        assert (dev < 4.0).all(), (r.mean, exact, r.stderr, dev)


def test_sharded_progress_callback():
    solver = ShardedWoStSolver(_square(), _mesh(4), SolverOptions(
        target_slots=256, pallas_block_rows=1, pallas_inner_steps=16))
    seen = []
    res = solver.solve(np.array([[0.1, 0.1], [0.2, -0.3]]), n_walks=64,
                       max_steps=200, eps=1e-3,
                       progress=lambda d, t, i: seen.append((d, t, i)))
    assert np.isfinite(res.mean).all()
    done = [d for d, _, _ in seen]
    assert len(seen) == solver.last_solve_stats["launches"] >= 1
    assert done == sorted(done) and done[-1] == 128
    assert all(t == 128 for _, t, _ in seen)
    assert [i for _, _, i in seen] == [16 * (k + 1) for k in range(len(seen))]
    solver.solve(np.array([[0.1, 0.1], [0.2, -0.3]]), n_walks=64,
                 max_steps=200, eps=1e-3)
    assert len(seen) == solver.last_solve_stats["launches"]


def test_sharded_truncation_counter():
    solver = ShardedWoStSolver(_square(lambda x, y: x), _mesh(4),
                               SolverOptions(target_slots=256,
                                             pallas_block_rows=1,
                                             pallas_inner_steps=8))
    pts = np.array([[0.0, 0.0], [0.25, 0.1]])
    tight = solver.solve(pts, n_walks=16, max_steps=4, eps=0.01, seed=0)
    ample = solver.solve(pts, n_walks=16, max_steps=4000, eps=0.01, seed=0)
    assert tight.truncated_walks > 0
    assert tight.truncated_weight == tight.truncated_walks
    assert tight.max_weight == 1.0
    assert ample.truncated_walks == 0.0 and ample.truncated_weight == 0.0
