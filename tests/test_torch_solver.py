"""Whole solves of the PyTorch port against the JAX package.

``DCRSurvey.run`` with the survey defaults (9 electrodes x 256 walks)
against the JAX package's XLA backend at the same seed: per electrode
``|dmean| <= 4 sqrt(se_port^2 + se_jax^2)``, total steps within 3%. The
physics gate against the finite-volume oracle is in
``test_torch_fdm_gate.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
from dcrmontecarlo_tpu.survey import dcr as jdcr
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.survey import dcr as tdcr

torch.set_num_threads(1)

N_WALKS, MAX_STEPS, EPS, SEED = 256, 500, 0.9, 0


@pytest.fixture(scope="module")
def paired_runs():
    jsurvey, electrodes = j_geo()
    want = jsurvey.run(electrodes, n_walks=N_WALKS, max_steps=MAX_STEPS,
                       eps=EPS, seed=SEED,
                       options=jdcr.survey_default_options(backend="xla"))
    tsurvey, t_electrodes = geophysical_scenario()
    np.testing.assert_array_equal(t_electrodes, electrodes)
    got = tsurvey.run(t_electrodes, n_walks=N_WALKS, max_steps=MAX_STEPS,
                      eps=EPS, seed=SEED, device="cpu")
    return got, want


def test_solve_matches_jax_xla(paired_runs):
    got, want = paired_runs
    g, w = got.solve, want.solve
    lim = 4.0 * np.sqrt(np.asarray(g.stderr) ** 2
                        + np.asarray(w.stderr) ** 2)
    assert (np.abs(np.asarray(g.mean) - np.asarray(w.mean)) <= lim).all(), \
        (g.mean, w.mean, lim)
    assert abs(g.total_steps - w.total_steps) <= 0.03 * w.total_steps
    assert g.n_walks == w.n_walks == N_WALKS
    for k in ("truncated_walks", "truncated_weight", "max_weight",
              "max_banked"):
        assert np.isfinite(getattr(g, k)), k


def test_survey_run_defaults(paired_runs):
    got, want = paired_runs
    assert got.potentials.shape == (9,) and got.voltages.shape == (8,)
    assert np.isfinite(got.potentials).all()
    assert np.isfinite(got.potentials_stderr).all()
    assert (got.potentials_stderr > 0).all()
    np.testing.assert_array_equal(got.voltages,
                                  tdcr.dipole_voltages(got.potentials))
    np.testing.assert_allclose(
        got.voltages_stderr,
        np.sqrt(got.potentials_stderr[:-1] ** 2
                + got.potentials_stderr[1:] ** 2))
    # the same conversion as the JAX package on the same voltages
    e = got.electrodes
    a, b = np.array([-10.0, 0.0]), np.array([10.0, 0.0])
    for conv in ("apparent_resistivity_2d", "apparent_resistivity_halfspace"):
        np.testing.assert_array_equal(
            getattr(tdcr, conv)(got.voltages, 1.0, a, b, e[:-1], e[1:]),
            getattr(jdcr, conv)(got.voltages, 1.0, a, b, e[:-1], e[1:]))
    np.testing.assert_array_equal(
        np.isfinite(got.apparent_resistivity),
        np.isfinite(want.apparent_resistivity))


def test_survey_layer_matches_jax():
    for kw in ({}, {"rejection_rounds": 8}):
        t, j = tdcr.survey_default_options(**kw), \
            jdcr.survey_default_options(**kw)
        for field in ("common_random_numbers", "compaction",
                      "roulette_threshold", "rejection_rounds",
                      "target_slots", "min_quota", "boundary_snap"):
            assert getattr(t, field) == getattr(j, field), field
    for args in (((-40, 40), 10.0), ((-40, 44), 10.0), ((-4.5, 4.5), 0.3)):
        np.testing.assert_array_equal(tdcr.surface_electrode_line(*args),
                                      jdcr.surface_electrode_line(*args))
    ts, _ = geophysical_scenario()
    js, _ = j_geo()
    for pos in ((-10.0, 0.0), (3.0, -0.6), (0.0, -5.0)):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            t_pos = ts._bury_source(pos)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            j_pos = js._bury_source(pos)
        assert t_pos == j_pos and len(tw) == len(jw)


def test_make_solver_reuse():
    survey, electrodes = geophysical_scenario()
    solver = survey.make_solver(device="cpu")
    assert isinstance(solver, WoStSolver) and solver.device.type == "cpu"
    r1 = survey.run(electrodes[:3], n_walks=16, max_steps=50, seed=4,
                    solver=solver)
    r2 = survey.run(electrodes[:3], n_walks=16, max_steps=50, seed=4,
                    solver=solver)
    np.testing.assert_array_equal(r1.potentials, r2.potentials)
