"""The dipole-dipole pseudosection, port against the JAX package.

``run_pseudosection`` sweeps every source dipole of a line from one walker
ensemble. On the scenario line (9 electrodes, 6 source dipoles: the
kernel's wide form on the card), at a cut size, the port's plain walk and
the JAX package's XLA backend draw the same counter-hash streams from the
same seed: total steps are EQUAL, the measurement indices and
pseudo-coordinates are equal, and potentials, voltages, apparent
resistivities and their error bars agree to 1e-3 of each array's largest
magnitude. Not closer: walk weights reach ~130 here and XLA's CPU backend
contracts ``a*b+c`` into FMAs, so one-ulp differences of a heavy walk
show in the means; measured, the largest difference is 2.5e-4 of the
scale, and the single-source ``DCRSurvey.run`` of the same line, seed and
size (which this slice does not touch) differs from the JAX package's by
1.2e-4 of its scale. The single-source line (4 electrodes, one dipole:
the solve's squeezed output) is held the same way. The public names of
the top level and of ``geometry``, ``problems``, ``survey``,
``diagnostics``, ``validation``, ``solver``, ``sampling`` and ``parallel``
are the JAX package's.
"""

import numpy as np
import pytest
import torch

import dcrmontecarlo_tpu as j_top
import dcrmontecarlo_tpu.diagnostics as j_diagnostics
import dcrmontecarlo_tpu.geometry as j_geometry
import dcrmontecarlo_tpu.parallel as j_parallel
import dcrmontecarlo_tpu.problems as j_problems
import dcrmontecarlo_tpu.sampling as j_sampling
import dcrmontecarlo_tpu.solver as j_solver
import dcrmontecarlo_tpu.survey as j_survey
import dcrmontecarlo_tpu.validation as j_validation
from dcrmontecarlo_tpu.models import geophysical_scenario as j_scenario
from dcrmontecarlo_tpu.survey import dcr as jdcr
import dcrmontecarlo_tpu_torch as t_top
import dcrmontecarlo_tpu_torch.diagnostics as t_diagnostics
import dcrmontecarlo_tpu_torch.geometry as t_geometry
import dcrmontecarlo_tpu_torch.parallel as t_parallel
import dcrmontecarlo_tpu_torch.problems as t_problems
import dcrmontecarlo_tpu_torch.sampling as t_sampling
import dcrmontecarlo_tpu_torch.solver as t_solver
import dcrmontecarlo_tpu_torch.survey as t_survey
import dcrmontecarlo_tpu_torch.validation as t_validation
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.survey import dcr as tdcr

torch.set_num_threads(1)

REL = 1e-3  # of each array's largest magnitude
FIELDS = ("potentials", "potentials_stderr", "voltage", "voltage_stderr",
          "apparent_resistivity")
EXACT = ("src_index", "a_index", "b_index", "m_index", "n_index",
         "pseudo_x", "pseudo_z")


@pytest.mark.parametrize("n,r", [(4, 2), (6, 10), (9, 3), (21, 8), (12, 1)])
def test_dipole_dipole_pairs_match_jax(n, r):
    assert t_survey.dipole_dipole_pairs(n, r) == \
        j_survey.dipole_dipole_pairs(n, r)


@pytest.mark.parametrize("port,ref", [(t_geometry, j_geometry),
                                      (t_problems, j_problems),
                                      (t_survey, j_survey),
                                      (t_diagnostics, j_diagnostics),
                                      (t_validation, j_validation),
                                      (t_solver, j_solver),
                                      (t_sampling, j_sampling),
                                      (t_parallel, j_parallel),
                                      (t_top, j_top)])
def test_public_names_match_jax(port, ref):
    # every name the JAX subpackage exports, the port's exports too
    missing = sorted(set(ref.__all__) - set(port.__all__))
    assert missing == []
    for name in ref.__all__:
        assert getattr(port, name) is not None, name
    if ref is j_survey:
        assert len(port.__all__) == 18


def _recording(monkeypatch, module, log):
    """Make ``module.WoStSolver`` record each solve's result in ``log``."""
    base = module.WoStSolver

    class Recording(base):
        def solve(self, *args, **kwargs):
            out = super().solve(*args, **kwargs)
            log.append(out)
            return out

    monkeypatch.setattr(module, "WoStSolver", Recording)


def _paired(monkeypatch, electrodes, rx, n_walks, max_steps):
    jlog, tlog = [], []
    _recording(monkeypatch, jdcr, jlog)
    _recording(monkeypatch, tdcr, tlog)
    js, _ = j_scenario()
    want = jdcr.run_pseudosection(
        js, electrodes, num_rx_per_src=rx, n_walks=n_walks,
        max_steps=max_steps, eps=0.9, seed=1,
        options=jdcr.survey_default_options(backend="xla", target_slots=2048))
    ts, _ = geophysical_scenario()
    got = tdcr.run_pseudosection(
        ts, electrodes, num_rx_per_src=rx, n_walks=n_walks,
        max_steps=max_steps, eps=0.9, seed=1,
        options=tdcr.survey_default_options(target_slots=2048),
        device="cpu")
    return got, want, tlog[-1], jlog[-1]


def _assert_same(got, want):
    for k in EXACT:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for k in FIELDS:
        g, w = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=REL * np.abs(w).max(), err_msg=k)


def test_scenario_pseudosection_matches_jax_xla(monkeypatch):
    _, electrodes = geophysical_scenario()
    got, want, gsolve, wsolve = _paired(monkeypatch, electrodes, 3, 32, 300)
    assert got.potentials.shape == (6, 9)
    assert len(got.voltage) == sum(
        len(r) for r in tdcr.dipole_dipole_pairs(9, 3)[1])
    _assert_same(got, want)
    assert gsolve.total_steps == float(wsolve.total_steps)
    assert (got.pseudo_z < 0).all()


def test_single_source_line_matches_jax_xla(monkeypatch):
    # a 4-electrode line yields one source dipole: the solve squeezes its
    # output to (n_elec,), run_pseudosection restores (1, n_elec)
    electrodes = np.stack([np.linspace(-15.0, 15.0, 4), np.zeros(4)], 1)
    got, want, gsolve, wsolve = _paired(monkeypatch, electrodes, 2, 32, 200)
    assert got.potentials.shape == (1, 4) and len(got.voltage) == 1
    _assert_same(got, want)
    assert gsolve.total_steps == float(wsolve.total_steps)


def test_pseudosection_sets_sources_and_mixture_with_setters(monkeypatch):
    # the line's dipoles and one mixture over its electrodes go in through
    # the version-bumping setters, as in the JAX package
    seen = []
    base = tdcr.WoStSolver

    class Capture(base):
        def solve(self, *args, **kwargs):
            seen.append(self.problem)
            return super().solve(*args, **kwargs)

    monkeypatch.setattr(tdcr, "WoStSolver", Capture)
    survey, electrodes = geophysical_scenario()
    survey.source_mis = True
    tdcr.run_pseudosection(survey, electrodes[:6], num_rx_per_src=2,
                           n_walks=4, max_steps=20, device="cpu")
    prob = seen[-1]
    assert prob.version == 2 and len(prob.source_fields) == 3
    assert prob.source_importance.cx.shape == (4,)
    np.testing.assert_allclose(prob.source_importance.weight.numpy(), 0.25)
