"""The reference's analytic-solution checks, on the port's CPU path.

The six tests of ``tests/test_solver_laplace.py``, the four of
``tests/test_solver_source.py`` and ``test_screened_constant_sigma_disk``,
``test_constant_alpha_reduces_to_wos``,
``test_manufactured_polynomial_solution`` and
``test_transport_sampler_solution_unbiased`` of
``tests/test_solver_varcoeff.py``, each with its own configuration
(points, walks, steps, eps, seed, solver options) and its own bounds, with
the fields written as the port's kernel field specs
(``test_torch_models.py`` holds each spec to its JAX lambda), and the
model tests of ``tests/test_models.py:17-73``. The same configurations
run on the card in ``chip_smoke.py`` phase 24.
"""

import numpy as np
import scipy.special as sp
import torch

from dcrmontecarlo_tpu_torch.geometry import Polyline, circle_loop, \
    square_loop
from dcrmontecarlo_tpu_torch.models import interior_grid, \
    poisson_solve_points, poisson_square, polynomial_manufactured, \
    trig_manufactured, varcoeff_solve_points, variable_coefficient_problem
from dcrmontecarlo_tpu_torch.problems import Problem
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_models import SPECS

torch.set_num_threads(1)


def _solver(prob, **opts):
    return WoStSolver(prob, SolverOptions(**opts), device="cpu")


def _spec(name):
    return SPECS[name][0]


# ---- tests/test_solver_laplace.py ------------------------------------------

def test_harmonic_linear_dirichlet():
    prob = Problem(dirichlet=square_loop(1.0), bc_dirichlet=_spec("x+2y"))
    pts = np.array([[0.0, 0.0], [0.5, 0.3], [-0.7, -0.2], [0.2, -0.8]])
    res = _solver(prob, target_slots=4096).solve(
        pts, n_walks=2000, max_steps=200, eps=1e-3, seed=0)
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 5e-3).all(), \
        (res.mean, exact, res.stderr)


def test_harmonic_saddle():
    prob = Problem(dirichlet=square_loop(1.0), bc_dirichlet=_spec("x2-y2"))
    pts = np.array([[0.0, 0.0], [0.4, 0.4], [-0.5, 0.1]])
    res = _solver(prob, target_slots=4096).solve(
        pts, n_walks=3000, max_steps=200, eps=1e-3, seed=1)
    exact = pts[:, 0] ** 2 - pts[:, 1] ** 2
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 5e-3).all(), \
        (res.mean, exact, res.stderr)


def test_constant_bc_zero_variance():
    prob = Problem(dirichlet=square_loop(1.0), bc_dirichlet=_spec("3.5"))
    res = _solver(prob, target_slots=512).solve(
        np.array([[0.1, 0.2]]), n_walks=64, max_steps=100, eps=1e-3)
    np.testing.assert_allclose(res.mean, [3.5], rtol=1e-6)
    np.testing.assert_allclose(res.stderr, [0.0], atol=1e-5)


def test_all_walks_complete():
    prob = Problem(dirichlet=square_loop(1.0))
    res = _solver(prob, target_slots=256).solve(
        np.array([[0.0, 0.0], [0.5, 0.5]]), n_walks=123, max_steps=100,
        eps=1e-3)
    assert res.n_walks == 123
    np.testing.assert_allclose(res.mean, 0.0, atol=1e-7)
    assert res.total_steps > 0


def test_reproducible_given_seed():
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=_spec("sin_cosh"))
    solver = _solver(prob, target_slots=512)
    pts = np.array([[0.2, -0.3]])
    r1 = solver.solve(pts, n_walks=500, max_steps=100, eps=1e-3, seed=7)
    r2 = solver.solve(pts, n_walks=500, max_steps=100, eps=1e-3, seed=7)
    r3 = solver.solve(pts, n_walks=500, max_steps=100, eps=1e-3, seed=8)
    assert r1.mean[0] == r2.mean[0]
    assert r1.mean[0] != r3.mean[0]


def test_harmonic_sin_sinh():
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=_spec("sin_sinh"))
    pts = np.array([[0.0, 0.5], [0.5, -0.5], [-0.3, 0.0]])
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=4000, max_steps=200, eps=1e-3, seed=3)
    exact = np.sin(pts[:, 0]) * np.sinh(pts[:, 1])
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 5e-3).all(), \
        (res.mean, exact, res.stderr)


# ---- tests/test_solver_source.py -------------------------------------------

def test_poisson_quadratic_source():
    prob = Problem(dirichlet=square_loop(2.0), bc_dirichlet=_spec("x2+y2"),
                   source=_spec("-4"))
    pts = np.array([[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]])
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=4000, max_steps=300, eps=1e-3, seed=0)
    exact = pts[:, 0] ** 2 + pts[:, 1] ** 2
    err = np.abs(res.mean - exact)
    assert (err < 4.0 * res.stderr + 0.02).all(), (res.mean, exact, err)


def test_poisson_bubble_zero_bc():
    # the 256-segment circle is the kernel's table form
    prob = Problem(dirichlet=circle_loop(1.0, n=256), bc_dirichlet=_spec("0"),
                   source=_spec("1"))
    pts = np.array([[0.0, 0.0], [0.5, 0.0], [0.0, -0.8]])
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=6000, max_steps=300, eps=1e-3, seed=1)
    exact = (1.0 - (pts[:, 0] ** 2 + pts[:, 1] ** 2)) / 4.0
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 5e-3).all(), \
        (res.mean, exact, res.stderr)


def test_mixed_neumann_strip():
    dirichlet = Polyline.concat([
        Polyline.from_points([[-1.0, 0.0], [1.0, 0.0]]),
        Polyline.from_points([[-1.0, 2.0], [1.0, 2.0]]),
    ])
    neumann = Polyline.concat([
        Polyline.from_points([[-1.0, 0.0], [-1.0, 2.0]]),
        Polyline.from_points([[1.0, 0.0], [1.0, 2.0]]),
    ])
    prob = Problem(dirichlet=dirichlet, neumann=neumann,
                   bc_dirichlet=_spec("y"))
    pts = np.array([[0.0, 1.0], [0.5, 0.5], [-0.8, 1.5]])
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=4000, max_steps=500, eps=1e-3, seed=2)
    assert (np.abs(res.mean - pts[:, 1]) < 4.0 * res.stderr + 0.02).all(), \
        (res.mean, pts[:, 1], res.stderr)


def test_neumann_circle_obstacle_runs():
    prob = Problem(dirichlet=square_loop(2.0),
                   neumann=circle_loop(0.5, n=32),
                   bc_dirichlet=_spec("x2+y2"))
    pts = np.array([[1.0, 1.0], [0.7, 0.0], [0.0, -1.5]])
    res = _solver(prob, target_slots=4096).solve(
        pts, n_walks=1000, max_steps=500, eps=1e-3, seed=3)
    assert np.isfinite(res.mean).all()
    assert (res.mean > 0.0).all() and (res.mean < 8.0).all()


# ---- tests/test_solver_varcoeff.py -----------------------------------------

def test_screened_constant_sigma_disk():
    sigma = 4.0
    prob = Problem(dirichlet=circle_loop(1.0, n=256),
                   bc_dirichlet=_spec("1"), sigma=_spec("4"))
    assert prob.use_delta_tracking
    pts = np.array([[0.0, 0.0], [0.5, 0.0], [0.0, 0.8]])
    res = _solver(prob, target_slots=16384).solve(
        pts, n_walks=8000, max_steps=1000, eps=1e-3, seed=0)
    r = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    exact = sp.i0(r * np.sqrt(sigma)) / sp.i0(np.sqrt(sigma))
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 0.01).all(), \
        (res.mean, exact, res.stderr)


def test_constant_alpha_reduces_to_wos():
    prob = Problem(dirichlet=square_loop(1.0), bc_dirichlet=_spec("x+2y"),
                   alpha=_spec("5"))
    assert prob.use_delta_tracking
    pts = np.array([[0.0, 0.0], [0.4, -0.2]])
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=6000, max_steps=1000, eps=1e-3, seed=1)
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    assert (np.abs(res.mean - exact) < 4.0 * res.stderr + 0.01).all(), \
        (res.mean, exact, res.stderr)


def _manufactured(sampler):
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=_spec("poly_u"), source=_spec("poly_f"),
                   alpha=_spec("2+0.5x+0.5y"), sigma=_spec("2+xy"))
    assert prob.use_delta_tracking and prob.sigma_bar > 0
    g = np.linspace(-0.7, 0.7, 4)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    res = _solver(prob, target_slots=16384, screened_sampler=sampler).solve(
        pts, n_walks=3000, max_steps=800, eps=1e-3, seed=2)
    exact = (1 - pts[:, 0] ** 2) * (1 - pts[:, 1] ** 2)
    err = np.abs(res.mean - exact)
    rmse = np.sqrt(np.mean((res.mean - exact) ** 2))
    return rmse, (err < 5.0 * res.stderr + 0.03).mean()


def test_manufactured_polynomial_solution():
    rmse, frac_ok = _manufactured("exact")
    assert rmse < 0.08, rmse
    assert frac_ok > 0.85, frac_ok


def test_transport_sampler_solution_unbiased():
    rmse, frac_ok = _manufactured("transport")
    assert rmse < 0.08, rmse
    assert frac_ok > 0.85, frac_ok


# ---- tests/test_models.py:17-73 -----------------------------------------

def test_polynomial_model():
    prob, u_exact = polynomial_manufactured()
    pts = interior_grid(n_points=3)
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=2000, max_steps=800, eps=1e-3, seed=0)
    rmse = np.sqrt(np.mean((res.mean - u_exact(pts)) ** 2))
    assert rmse < 0.08, rmse


def test_trig_model():
    prob, u_exact = trig_manufactured()
    pts = interior_grid(n_points=3)
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=2500, max_steps=800, eps=1e-3, seed=1)
    rmse = np.sqrt(np.mean((res.mean - u_exact(pts)) ** 2))
    assert rmse < 0.15, (rmse, res.mean, u_exact(pts))


def test_poisson_model():
    prob, u_exact = poisson_square()
    pts = poisson_solve_points(n=5)
    res = _solver(prob, target_slots=8192).solve(
        pts, n_walks=1500, max_steps=300, eps=1e-3, seed=2)
    err = np.abs(res.mean - u_exact(pts))
    assert (err < 4 * res.stderr + 0.03).mean() > 0.9


def test_varcoeff_model_runs():
    prob = variable_coefficient_problem()
    assert prob.use_delta_tracking and prob.neumann is not None
    pts = varcoeff_solve_points(n=5)
    res = _solver(prob, target_slots=4096, max_attenuation=50.0).solve(
        pts, n_walks=300, max_steps=500, eps=1e-3, seed=3)
    assert np.isfinite(res.mean).all()
    assert np.abs(res.mean).max() < 5.0


def test_varcoeff_uncapped_is_finite():
    prob = variable_coefficient_problem()
    pts = varcoeff_solve_points(n=3)
    res = _solver(prob, target_slots=2048).solve(
        pts, n_walks=200, max_steps=400, eps=1e-3, seed=3)
    assert np.isfinite(res.mean).all() and np.isfinite(res.stderr).all()
