"""The gridded Dirichlet field kind (``problems/fields.py::Grid``).

The cylinder oracle's Monte Carlo tier (``tests/test_cylinder_oracle.py``)
sets its Dirichlet data to the bilinear interpolant of a 257 x 257 grid,
``diagnostics/martingale.py::grid_continuation`` of the JAX package. The
port evaluates it as a field spec: in the plain walk as a callable on
tensors, in the CUDA kernel as a node table in global memory read when a
walk banks (``walk_kernel<...,grid>``). The JAX package solves such a
problem on its XLA step only (its Pallas kernel refuses a captured
table), so whole solves are held against ``backend="xla"``.

Tolerances: the interpolant equals ``grid_continuation``'s to 2e-6 of the
grid's largest value (measured: bit for bit on 20,000 points, clipped ones
among them; XLA may contract its corner sums into FMAs); solves within 4
combined standard errors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu.diagnostics import grid_continuation as j_grid
from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu.validation import cylinder_oracle_pins as j_pins
from dcrmontecarlo_tpu_torch.diagnostics import grid_continuation
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from dcrmontecarlo_tpu_torch.validation import FDMSolution, \
    cylinder_oracle_pins
from test_torch_nodelta import _compare

torch.set_num_threads(1)


def _small_grid():
    xs = np.linspace(-1.0, 1.0, 21)
    ys = np.linspace(-2.0, 0.0, 11)
    return xs, ys, np.add.outer(xs ** 2, 3.0 * ys)


def _pinned_grid():
    p = cylinder_oracle_pins()
    return p["gx"], p["gy"], p["bc_grid_conductor"]


def _points(xs, ys, n, seed):
    """``n`` seeded points over the grid and 10% past each side, with the
    last node lines and the float32 value just below them among them."""
    rng = np.random.default_rng(seed)
    lo = np.array([xs[0], ys[0]])
    span = np.array([xs[-1], ys[-1]]) - lo
    pts = (lo - 0.1 * span + rng.random((n, 2)) * 1.2 * span).astype(
        np.float32)
    pts[:50, 0] = xs[-1]
    pts[50:100, 1] = ys[-1]
    pts[100:150, 0] = np.nextafter(np.float32(xs[-1]), np.float32(-1e9))
    pts[150:200, 1] = np.nextafter(np.float32(ys[-1]), np.float32(-1e9))
    return pts


@pytest.mark.parametrize("which", ["small", "pinned_257"])
def test_grid_matches_jax_grid_continuation(which):
    xs, ys, U = _small_grid() if which == "small" else _pinned_grid()
    pts = _points(xs, ys, 20000, 3)
    want = np.asarray(j_grid(xs, ys, U)(jnp.asarray(pts[:, 0]),
                                         jnp.asarray(pts[:, 1])))
    g = grid_continuation(xs, ys, U)
    assert isinstance(g, fields.Grid) and g.kind == fields.GRID
    got = g(torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(U).max())
    # the clip bound n - 1.000001 rounds to float32: to n - 1 itself for
    # n = 257, below it for n = 21
    assert g.params[4] == np.float32(len(xs) - 1.000001)


def test_grid_continuation_matches_bilinear():
    # tests/test_martingale_audit.py::test_grid_continuation_matches_bilinear
    # on the port, against the port's FDMSolution
    xs, ys, U = _small_grid()
    cont = grid_continuation(xs, ys, U)
    pts = np.array([[-0.63, -1.17], [0.5, -0.05], [0.98, -1.99]], np.float32)
    got = cont(torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]))
    ref = FDMSolution(xs, ys, U)(pts)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_grid_is_dirichlet_data_only():
    # no derivatives: a conductivity raises where sigma' is formed, a
    # source where the walk's parameters are
    xs, ys, U = _small_grid()
    g = grid_continuation(xs, ys, U + 10.0)
    x = torch.zeros(3)
    with pytest.raises(NotImplementedError, match="bc_dirichlet"):
        g.value_grad_lap(x, x)
    with pytest.raises(NotImplementedError, match="bc_dirichlet"):
        Problem(dirichlet=square_loop(1.0), alpha=g)
    for kw in (dict(source=g), dict(sigma=g)):
        solver = WoStSolver(Problem(dirichlet=square_loop(1.0), **kw),
                            SolverOptions(), device="cpu")
        with pytest.raises(NotImplementedError,
                           match="Dirichlet data only"):
            solver._setup(np.zeros((1, 2), np.float32), 8, 10, 1e-2, 0)
    with pytest.raises(ValueError, match="2-D table"):
        fields.Grid(0.0, 1.0, 0.0, 1.0, np.zeros(5))


def _square(bc):
    return Problem(dirichlet=square_loop(1.0), bc_dirichlet=bc,
                   source=fields.constant(1.0))


def test_plain_walk_on_a_grid_equals_the_terms_field():
    # x + 2y is bilinear, so its grid interpolant is the field up to
    # rounding: the walks are the same, the banked sums agree to rel 1e-4
    xs = np.linspace(-1.0, 1.0, 9)
    ys = np.linspace(-1.0, 1.0, 17)
    grid = grid_continuation(xs, ys, np.add.outer(xs, 2.0 * ys))
    poly = fields.polynomial({(1, 0): 1.0, (0, 1): 2.0})
    pts = np.array([[0.2, 0.1], [-0.5, 0.3]], np.float32)
    states = []
    for bc in (grid, poly):
        solver = WoStSolver(_square(bc), SolverOptions(target_slots=1024),
                            device="cpu")
        state, params, _, _ = solver._setup(pts, 2048, 200, 1e-3, 5)
        assert params.grid == (bc is grid)
        wk.walk_plain(state, params, 64)
        states.append(state)
    frac, _, finite = wk.compare_planes(*states, state_planes(1))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    assert torch.equal(states[0]["px"], states[1]["px"])
    assert int(states[0]["ndone"].sum()) > 500


def test_grid_solve_matches_jax_xla():
    # a curved Dirichlet field on a grid, Laplace in the unit square: the
    # port's plain solve against the JAX XLA backend's, within 4 sigma
    xs = np.linspace(-1.2, 1.2, 49)
    ys = np.linspace(-1.1, 1.1, 45)
    U = np.sin(2.0 * xs)[:, None] * np.cosh(2.0 * ys)[None, :]
    pts = np.array([[0.0, 0.0], [0.5, -0.3], [-0.6, 0.6]], np.float32)
    kw = dict(n_walks=2000, max_steps=300, eps=1e-3, seed=2)
    jprob = JProblem(dirichlet=j_square(1.0), bc_dirichlet=j_grid(xs, ys, U))
    want = JSolver(jprob, JOptions(backend="xla", target_slots=4096)).solve(
        pts, **kw)
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=grid_continuation(xs, ys, U))
    got = WoStSolver(prob, SolverOptions(target_slots=4096),
                     device="cpu").solve(pts, **kw)
    se = np.hypot(got.stderr, want.stderr)
    assert (np.abs(got.mean - want.mean) < 4.0 * se).all(), (
        got.mean, want.mean, se)
    assert (got.stderr > 0).all()


def test_cylinder_grid_takes_the_grid_instantiation():
    # the cylinder MC tier's problem launches the flagship switches with the
    # grid; its pack names the grid kind, and its node table uploads once
    from chip_smoke import cylinder_problem

    prob, pins = cylinder_problem()
    solver = WoStSolver(prob, SolverOptions(split_threshold=4.0,
                                            target_slots=1024), device="cpu")
    el = pins["electrodes"].astype(np.float32)
    _, params, _, _ = solver._setup(el, 64, 6000, 1.0, 0)
    assert params.variant == (wk.ROBIN_CHAIN, True, True, True, False, True,
                              False, False, True)
    assert params.variant in wk.KERNEL_VARIANTS and params.grid
    assert params.kernel_name == \
        "walk_kernel<1,true,true,true,false,true,false,false,true>"
    assert wk.variant_code(params.variant) == 122 + 512
    fp, ip = params.pack()
    assert ip[21] == fields.GRID and ip[22] == 8
    tab = params.grid_table("cpu")
    assert tab.shape == (257, 257) and tab.dtype == torch.float32
    assert params.grid_table("cpu") is tab
    np.testing.assert_array_equal(tab.numpy(), pins["bc_grid_conductor"])
    # the JAX package's pins are the port's
    for k, v in j_pins().items():
        np.testing.assert_array_equal(pins[k], v)


def test_grid_on_an_instantiation_without_it_raises():
    # a grid on the survey's switches packs, and its plain walk follows
    # the interpreted Pallas kernel, which banks in closed form the
    # bilinear field the grid holds exactly (it refuses the node table)
    from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
    from test_torch_nodelta import one_launch

    # wide of the domain: a walk cut at max_steps may bank off it
    xs, ys = np.linspace(-160.0, 160.0, 33), np.linspace(-260.0, 60.0, 33)
    U = 0.5 + np.add.outer(3e-3 * xs, -2e-3 * ys) + 1e-5 * np.outer(xs, ys)
    survey, electrodes = geophysical_scenario()
    prob = survey.build_problem()
    prob.set_boundary_conditions(grid_continuation(xs, ys, U))
    jprob = j_geo()[0].build_problem()
    jprob.set_boundary_conditions(
        lambda x, y: 0.5 + (3e-3 * x + -2e-3 * y) + 1e-5 * x * y)
    pts = np.asarray(electrodes, np.float32)
    got, want, params, _ = one_launch(prob, jprob, pts, 1024, 0.9, 12,
                                      jopts=dict(roulette_threshold=0.05))
    assert params.grid and params.variant == (
        wk.ROBIN_OFF, False, False, False, False, True, False, False, True)
    assert params.variant in wk.KERNEL_VARIANTS
    fp, ip = params.pack()
    assert ip[21] == fields.GRID and ip[22] == 8
    frac = _compare(got, want, state_planes(1))
    assert frac["asum0"] >= wk.PLANE_MIN_FRAC
    assert (want["ndone"] > 0).sum() > 100  # walks banked the grid
