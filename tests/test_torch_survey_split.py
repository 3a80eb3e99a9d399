"""The survey with the high-weight split (``chip_smoke.py`` phase 40).

Phase 6's configuration with ``split_threshold=4.0`` runs the survey's
freeze build (``walk_kernel<0,false,false,true,false,true,false>``)
through the single-device host launch loop. Here, at a cut size (9 points
x 256 walks, one walk per slot), the port's whole solve must lie within 4
combined standard errors of the JAX package's with the same options (its
XLA backend, which splits in-graph; off a TPU ``backend="auto"`` is XLA),
and a problem without delta tracking must leave the split inert, as the
reference does (``solver/wost.py:1780-1812``).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.models import geophysical_scenario
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver

torch.set_num_threads(1)

N_WALKS = 256
CUT = dict(target_slots=4096, min_quota=1)


@pytest.fixture(scope="module")
def paired_runs():
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    pts = cs.survey_points(electrodes, -0.5)
    solver = WoStSolver(survey.build_problem(),
                        cs.survey_split_options(**CUT), device="cpu")
    kw = dict(n_walks=N_WALKS, max_steps=cs.P1_MAX_STEPS, eps=cs.P1_EPS,
              seed=0)
    got = solver.solve(pts, **kw)
    stats = solver.last_solve_stats
    jsurvey, _ = j_geo(sharpness=0.5)
    want = JSolver(jsurvey.build_problem(), JOptions(
        backend="xla", rejection_rounds=1, split_threshold=cs.P1_SPLIT,
        **CUT)).solve(pts, **kw)
    return solver, pts, got, stats, want


def test_survey_split_matches_jax_xla(paired_runs):
    _, _, got, _, want = paired_runs
    se = np.hypot(got.stderr, want.stderr)
    assert np.isfinite(got.mean).all() and (got.stderr > 0).all()
    assert (np.abs(got.mean - want.mean) < 4.0 * se).all(), (
        got.mean, want.mean, se)


def test_survey_split_runs_the_freeze_build(paired_runs):
    solver, pts, _, stats, _ = paired_runs
    _, params, _, _ = solver._setup(pts, N_WALKS, cs.P1_MAX_STEPS,
                                    cs.P1_EPS, 0)
    assert params.variant == (wk.ROBIN_OFF, False, False, True, False, True,
                              False, False, False)
    assert params.kernel_name == \
        "walk_kernel<0,false,false,true,false,true,false>"
    assert wk.variant_code(params.variant) == 10 and params.freeze
    fp, ip = params.pack()
    assert ip[16] == 1 and ip[15] == 0  # the freeze, no mixture
    # the host loop split heavy walks
    assert stats["launches"] > 1 and stats["clones"] > 0


def test_split_is_inert_without_delta_tracking():
    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                   (0, 1): 2.0}))
    pts = np.array([[0.0, 0.0], [0.5, 0.3]], np.float32)
    kw = dict(n_walks=256, max_steps=100, eps=1e-3, seed=0)
    split = WoStSolver(prob, SolverOptions(target_slots=256,
                                           split_threshold=0.5),
                       device="cpu")
    _, params, _, _ = split._setup(pts, 256, 100, 1e-3, 0)
    assert not params.freeze and wk.valid_variant(params.variant)
    with pytest.warns(UserWarning, match="split_threshold is inert"):
        got = split.solve(pts, **kw)
    assert split.last_solve_stats["clones"] == 0
    assert split.last_solve_stats["launches"] == 1  # the single launch
    want = WoStSolver(prob, SolverOptions(target_slots=256),
                      device="cpu").solve(pts, **kw)
    assert np.isfinite(got.mean).all()
    se = np.hypot(got.stderr, want.stderr)
    assert (np.abs(got.mean - want.mean) < 4.0 * se + 1e-6).all()
