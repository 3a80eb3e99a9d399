"""The terrain with the flagship's estimator (``chip_smoke.py`` phase 41).

``topographic_survey_problem()`` with MIS toward the survey's
two-component mixture at the buried current electrodes,
``local_majorant="auto"`` and the split at 4
(``chip_smoke.py::terrain_flagship_problem``): the table form with the
majorant, MIS and the freeze,
``walk_kernel<0,true,true,true,true,true,false>`` (Robin ``"auto"``
resolves off on the terrain). Both packages build it the same way and
derive the same majorant; at the test size (102 rows, 9 draped
electrodes x 64 walks) the port's whole solve must lie within 4 combined
standard errors of the JAX package's (its XLA backend, which splits
in-graph) and hold ``tests/test_topography.py``'s physics.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu.models import drape_electrodes as j_drape
from dcrmontecarlo_tpu.models import topographic_survey_problem as j_topo
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.problems.fields import GaussianMixture as JMixture
from dcrmontecarlo_tpu.survey import survey_default_options as j_options
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch.models import drape_electrodes
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.survey import survey_default_options

torch.set_num_threads(1)

TEST_SIZE = dict(half_width=100.0, depth=150.0, resolution=4.0)
N_WALKS = 64


def jax_terrain_flagship_problem(**size):
    """The JAX package's problem, built as ``terrain_flagship_problem``
    builds the port's."""
    prob, h = j_topo(**size)
    a, b = ((x, float(h(np.asarray(x))) - 1.5) for x in (-20.0, 20.0))
    return JProblem(
        dirichlet=prob.dirichlet, neumann=prob.neumann,
        bc_dirichlet=prob.bc_dirichlet, source=prob.source, alpha=prob.alpha,
        source_importance=JMixture.from_components(
            [(a, 0.5, 0.5), (b, 0.5, 0.5)]),
        local_majorant="auto"), h


@pytest.fixture(scope="module")
def paired_runs():
    tprob, h = cs.terrain_flagship_problem(**TEST_SIZE)
    jprob, jh = jax_terrain_flagship_problem(**TEST_SIZE)
    el = drape_electrodes(h, cs.TOPO_XS, nudge=0.5)
    np.testing.assert_array_equal(el, j_drape(jh, cs.TOPO_XS, 0.5))
    kw = dict(n_walks=N_WALKS, max_steps=cs.P2_MAX_STEPS, eps=cs.P2_EPS,
              seed=0)
    solver = WoStSolver(tprob, survey_default_options(
        target_slots=2048, split_threshold=cs.P2_SPLIT), device="cpu")
    got = solver.solve(el, **kw)
    stats = solver.last_solve_stats
    want = JSolver(jprob, j_options(
        backend="xla", target_slots=2048,
        split_threshold=cs.P2_SPLIT)).solve(el, **kw)
    return tprob, jprob, solver, el, got, stats, want


def test_built_the_same_way(paired_runs):
    tprob, jprob, solver, _, _, _, _ = paired_runs
    tm, jm = tprob.local_majorant, jprob.local_majorant
    assert len(tm.boxes) == len(jm.boxes) == 2 and not tm.bands
    np.testing.assert_allclose(np.asarray(tm.boxes), np.asarray(jm.boxes),
                               rtol=1e-6, atol=1e-6)
    assert tm.sigma_bar_bg == pytest.approx(jm.sigma_bar_bg, rel=1e-4)
    np.testing.assert_array_equal(tprob.source_importance.cx.numpy(),
                                  np.asarray(jprob.source_importance.cx))
    np.testing.assert_array_equal(tprob.source_importance.cy.numpy(),
                                  np.asarray(jprob.source_importance.cy))
    assert solver._robin_enabled() is False
    assert JSolver(jprob)._robin_enabled() is False


def test_terrain_flagship_runs_its_variant(paired_runs):
    _, _, solver, el, _, stats, _ = paired_runs
    _, params, _, _ = solver._setup(el, N_WALKS, cs.P2_MAX_STEPS,
                                    cs.P2_EPS, 0)
    assert params.variant == (wk.ROBIN_OFF, True, True, True, True, True,
                              False, False, False)
    assert params.kernel_name == \
        "walk_kernel<0,true,true,true,true,true,false>"
    fp, ip = params.pack()
    assert ip[11] == 1 and ip[12] == 2 and ip[15] == 2  # majorant, 2 mix
    assert ip[16] == 1 and ip[18] == 1                  # freeze, table
    assert stats["launches"] > 1 and stats["clones"] > 0


def test_terrain_flagship_matches_jax_xla(paired_runs):
    _, _, _, _, got, _, want = paired_runs
    se = np.hypot(got.stderr, want.stderr)
    assert np.isfinite(got.mean).all() and (got.stderr > 0).all()
    assert (np.abs(got.mean - want.mean) < 4.0 * se).all(), (
        got.mean, want.mean, se)


def test_terrain_flagship_physics(paired_runs):
    # tests/test_topography.py::test_topographic_survey_solves's gate
    got = paired_runs[4]
    i_pos = int(np.argmin(np.abs(cs.TOPO_XS + 20)))
    i_neg = int(np.argmin(np.abs(cs.TOPO_XS - 20)))
    assert got.mean[i_pos] > 0 and got.mean[i_neg] < 0, got.mean
    assert np.abs(got.mean).max() < 1.0
