"""The author-independent validation path on the port: the cylinder-series
oracle, the finite-element oracle, the pinned reference numbers, and the
cylinder oracle's Monte Carlo tier.

The oracles are numpy and scipy code the port copies (it imports nothing
of the JAX package): each copy is held to the original to 1e-12. The
series self-certifies as ``tests/test_cylinder_oracle.py`` tier 1 has it
do, and reproduces the pins. The Monte Carlo tier (tier 3) runs the
flagship switches with the gridded Dirichlet field; at a cut size (6
electrodes x 32 walks, ``max_steps=120``) the port's plain solve lies
within 4 combined standard errors of the JAX package's XLA backend, the
one backend of the JAX package that solves it (its Pallas kernel refuses
the captured grid). At the test's own size the tier runs on the card
(``chip_smoke.py`` phase 33).
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.validation import cylinder as j_cyl
from dcrmontecarlo_tpu.validation import fem as j_fem
from dcrmontecarlo_tpu.validation import pins as j_pins
from dcrmontecarlo_tpu_torch import validation
from dcrmontecarlo_tpu_torch.validation import cylinder, fem, pins

torch.set_num_threads(1)

CENTER, RADIUS, SIGMA0, SURFACE_Y = (-120.0, -80.0), 60.0, 1e-2, 1.0
SOURCES = [((-200.0, -9.0), 1.0), ((200.0, -9.0), -1.0)]
WIDTH = 5.0
PROBES = np.array([[50.0, -300.0], [-300.0, -500.0], [-120.0, -80.0],
                   [200.0, -40.0], [-150.0, -60.0], [0.0, 0.5]])


def _electrodes():
    return np.stack([np.arange(-400.0, 401.0, 40.0), np.full(21, -0.1)], 1)


def _series(mod, sigma1, sources=SOURCES):
    return mod.CylinderHalfspace(CENTER, RADIUS, SIGMA0, sigma1, SURFACE_Y,
                                 sources)


@pytest.mark.parametrize("sigma1", [1e-1, 1e-3])
def test_series_copy_matches_jax(sigma1):
    got, want = _series(cylinder, sigma1), _series(j_cyl, sigma1)
    pts = np.concatenate([PROBES, _electrodes()])
    np.testing.assert_allclose(got(pts), want(pts), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.interface_residuals(),
                               want.interface_residuals(), rtol=1e-12)
    reg = [m.regularize_sources(lambda s, m=m: _series(m, sigma1, s),
                                SOURCES, WIDTH, SURFACE_Y)(_electrodes())
           for m in (cylinder, j_cyl)]
    np.testing.assert_allclose(reg[0], reg[1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("sigma1", [1e-1, 1e-3])
def test_series_self_certifies(sigma1):
    # tests/test_cylinder_oracle.py::test_series_self_certifies on the copy
    sol = _series(cylinder, sigma1)
    ru, rf = sol.interface_residuals()
    assert ru < 1e-4
    assert rf < 1e-3
    xs = np.linspace(-450.0, 450.0, 41)
    assert sol.surface_flux(xs).max() < 1e-3
    assert sol.laplacian_residual(PROBES[:4]).max() < 1e-6


def test_series_pins_match():
    # the pins the port reads are what the port's series produces
    p = pins.cylinder_oracle_pins()
    el = _electrodes()
    np.testing.assert_allclose(p["electrodes"], el, atol=1e-9)
    for name, s1 in (("conductor", 1e-1), ("resistor", 1e-3)):
        u_reg = cylinder.regularize_sources(
            lambda s, s1=s1: _series(cylinder, s1, s), SOURCES, WIDTH,
            SURFACE_Y)
        np.testing.assert_allclose(u_reg(el), p[f"ref_{name}"], rtol=0,
                                   atol=1e-6)


def test_pins_load_as_the_jax_package_loads_them():
    for port_fn, jax_fn, keys in (
            (pins.cylinder_oracle_pins, j_pins.cylinder_oracle_pins,
             {"electrodes", "gx", "gy", "bc_grid_conductor",
              "ref_conductor", "delta_smooth_conductor"}),
            (pins.notebook_oracle_pins, j_pins.notebook_oracle_pins,
             {"electrodes", "fdm_401", "dv_401"})):
        got, want = port_fn(), jax_fn()
        assert keys <= set(got) and set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert port_fn() is got   # loaded once


def test_fem_copy_matches_jax():
    def alpha(X, Y):
        return np.where((X - 0.3) ** 2 + (Y + 0.6) ** 2 < 0.1, 0.1, 1.0)

    def source(X, Y):
        return np.exp(-((X + 0.2) ** 2 + (Y + 0.3) ** 2) / 0.02)

    kw = dict(bounds=((-1.0, 1.0), (-2.0, 0.0)), alpha=alpha, source=source,
              neumann_top=True, nx=41, ny=41)
    pts = np.array([[0.0, -0.1], [0.4, -0.7], [-0.5, -1.5]])
    want = j_fem.fem_solve(**kw)
    got = fem.fem_solve(**kw)
    assert isinstance(got, validation.FDMSolution)
    np.testing.assert_allclose(got.u, want.u, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got(pts), want(pts), rtol=1e-12, atol=0)
    assert np.abs(want(pts)).max() > 0


def test_validation_names_match_jax():
    import dcrmontecarlo_tpu.validation as j_validation

    assert sorted(validation.__all__) == sorted(j_validation.__all__)
    for name in validation.__all__:
        assert callable(getattr(validation, name)), name


def test_mc_tier_matches_jax_xla_at_a_cut_size():
    # tests/test_cylinder_oracle.py::test_mc_matches_cylinder_series's
    # configuration (the flagship switches, the split at 4, the grid as
    # Dirichlet data) at 6 electrodes x 32 walks and max_steps 120: the
    # port's plain solve against the JAX XLA backend's, within 4 sigma
    import jax.numpy as jnp  # noqa: F401  (the JAX fields are jnp code)

    from chip_smoke import cylinder_problem
    from dcrmontecarlo_tpu.diagnostics import grid_continuation
    from dcrmontecarlo_tpu.problems import Problem
    from dcrmontecarlo_tpu.problems.fields import GaussianMixture, \
        gaussian_dipole, smooth_circle
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
    from dcrmontecarlo_tpu.survey.dcr import halfspace_domain
    from dcrmontecarlo_tpu.survey.dcr import survey_default_options as jsdo
    from dcrmontecarlo_tpu_torch.solver import WoStSolver
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    p = pins.cylinder_oracle_pins()
    bump = smooth_circle(CENTER, RADIUS, 0.1)
    dirichlet, neumann = halfspace_domain(500.0, 1001.0, SURFACE_Y)
    jprob = Problem(
        dirichlet=dirichlet, neumann=neumann,
        bc_dirichlet=grid_continuation(p["gx"], p["gy"],
                                       p["bc_grid_conductor"]),
        source=gaussian_dipole(SOURCES[0][0], SOURCES[1][0], 1.0, WIDTH),
        alpha=lambda x, y: SIGMA0 + (1e-1 - SIGMA0) * bump(x, y),
        source_importance=GaussianMixture.from_components(
            [(SOURCES[0][0], WIDTH, 0.5), (SOURCES[1][0], WIDTH, 0.5)]),
        local_majorant="auto")
    el = _electrodes()[::4].astype(np.float32)
    kw = dict(n_walks=32, max_steps=120, eps=1.0, seed=0)
    want = JSolver(jprob, jsdo(backend="xla", target_slots=16384,
                               split_threshold=4.0)).solve(el, **kw)
    prob, _ = cylinder_problem()
    solver = WoStSolver(prob, survey_default_options(
        target_slots=16384, split_threshold=4.0, pallas_block_rows=1),
        device="cpu")
    got = solver.solve(el, **kw)
    assert solver._robin_enabled() == "chain"
    assert solver.last_solve_stats["clones"] > 0
    se = np.hypot(got.stderr, want.stderr)
    assert np.isfinite(got.mean).all() and (se > 0).all()
    assert (np.abs(got.mean - want.mean) < 4.0 * se).all(), (
        got.mean, want.mean, se)
