"""Whole solves through the survey build's dealt loop against the JAX package.

The host compiler builds ``csrc/walk_kernel.cu``'s survey build
``<0,false,false,false,false,true,false>`` (``tests/host_cuda/``), and
``WoStSolver._solve_raw`` runs its adaptive single launch through it as
the card's wrapper launches it (``walk_kernel.launch_loop``): the launch
covers every quota from fresh walks, so its walks are dealt to the
threads (``walk_dealt``) and folded in walk order. The geophysical survey
(9 electrodes x 256 walks) agrees with the JAX package's XLA backend at
the same seed within 4 sigma per electrode, total steps within 3%; a bump
conductivity on a square walks the JAX package's Pallas kernel's walks in
interpret mode (axis-aligned walls keep them in step across math
libraries): equal total steps, sums to rel 1e-5. The survey's transport
and MIS builds go through the same cases in
``test_torch_host_dealt_walks_tm_jax.py``.
"""

import dataclasses


import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from host_cuda.host_walk import load, start_build
from test_torch_host_dealt_walks import SURVEY

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def survey_walk(tmp_path_factory):
    """The survey build's host library (``host_walk.load``)."""
    return load(start_build(tmp_path_factory.mktemp("host_dealt_jax"),
                            SURVEY, False), SURVEY)


def _dealt_walk(host):
    """``walk(state, params, n)`` for ``_solve_raw``: the host build's
    launch as the card's wrapper makes it, its loops recorded."""
    loops = []

    def walk(state, params, n, thr=None):
        loops.append(host.loop(state, params, n, thr))
        return state

    walk.loops = loops
    return walk


def survey_solve_case(host, build="survey"):
    """The geophysical survey (9 electrodes x 256 walks, the survey
    defaults; ``build`` "transport" with the transport sampler, "mis" with
    the survey's MIS mixture) through ``host``'s dealt loop against the JAX
    package's XLA backend at the same seed: within 4 sigma per electrode,
    total steps within 3%."""
    from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
    from dcrmontecarlo_tpu.survey import dcr as jdcr
    from dcrmontecarlo_tpu_torch.models import geophysical_scenario
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    extra = ({"screened_sampler": "transport"} if build == "transport"
             else {})
    jsurvey, electrodes = j_geo()
    tsurvey, t_electrodes = geophysical_scenario()
    jsurvey.source_mis = tsurvey.source_mis = build == "mis"
    want = jsurvey.run(electrodes, n_walks=256, max_steps=500, eps=0.9,
                       seed=0, options=jdcr.survey_default_options(
                           backend="xla", **extra))
    solver = tsurvey.make_solver(survey_default_options(**extra),
                                 device="cpu")
    pts = np.asarray(t_electrodes, np.float32).copy()
    on_surface = np.abs(pts[:, 1] - tsurvey.surface_y) < \
        tsurvey.electrode_nudge
    pts[on_surface, 1] = tsurvey.surface_y - tsurvey.electrode_nudge
    walk = _dealt_walk(host)
    got = solver._solve_raw(pts, 256, 500, 0.9, 0, walk=walk)
    assert walk.loops == ["dealt"]
    w = want.solve
    lim = 4.0 * np.sqrt(got.stderr[0] ** 2 + np.asarray(w.stderr) ** 2)
    assert (np.abs(got.mean[0] - np.asarray(w.mean)) <= lim).all(), \
        (got.mean, w.mean, lim)
    assert abs(got.total_steps - w.total_steps) <= 0.03 * w.total_steps


def test_survey_solve_through_the_dealt_loop_matches_jax_xla(survey_walk):
    survey_solve_case(survey_walk)


def square_solve_case(host, mis=False):
    """A bump conductivity on a square (``test_torch_split._bump_problems``;
    with ``mis`` a Gaussian dipole inside it, its two-component MIS
    mixture and a constant boundary value) through ``host``'s dealt loop against the JAX package's
    Pallas kernel in interpret mode, walk for walk: equal total steps,
    sums to rel 1e-5."""
    from jax.experimental.pallas import tpu as pltpu

    from dcrmontecarlo_tpu.problems import fields as jf
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
    from test_torch_split import _bump_problems

    if mis:  # a constant, not a TERMS field: the build evaluates no TERMS
        _, jprob = _bump_problems(lambda x, y: 1.0 + 0.0 * x)
        tprob, _ = _bump_problems(fields.constant(1.0))
    else:
        _, jprob = _bump_problems(lambda x, y: 1.0 + x * y)
        tprob, _ = _bump_problems(fields.polynomial({(0, 0): 1.0,
                                                     (1, 1): 1.0}))
    if mis:
        a, b, width = (-0.5, -0.3), (0.4, 0.5), 0.2
        parts = [(a, width, 0.5), (b, width, 0.5)]
        jprob = dataclasses.replace(
            jprob, source=jf.gaussian_dipole(a, b, 1.0, width),
            source_importance=jf.GaussianMixture.from_components(parts))
        tprob = dataclasses.replace(
            tprob, source=fields.gaussian_dipole(a, b, 1.0, width),
            source_importance=fields.GaussianMixture.from_components(parts))
    pts = np.array([[0.0, 0.0], [0.4, 0.2], [-0.9, 0.7]], np.float32)
    kw = dict(target_slots=512, pallas_block_rows=2)
    with pltpu.force_tpu_interpret_mode():
        want = JSolver(jprob, JOptions(backend="pallas", **kw)).solve(
            pts, n_walks=128, max_steps=150, eps=2e-2, seed=9)
    solver = WoStSolver(tprob, SolverOptions(**kw), device="cpu")
    walk = _dealt_walk(host)
    got = solver._solve_raw(pts, 128, 150, 2e-2, 9, walk=walk)
    assert walk.loops == ["dealt"]
    assert got.total_steps == want.total_steps
    np.testing.assert_allclose(got.walk_sum[0], np.asarray(want.walk_sum),
                               rtol=1e-5)
    np.testing.assert_allclose(got.walk_sumsq[0],
                               np.asarray(want.walk_sumsq), rtol=1e-5)
    return got


def test_square_solve_through_the_dealt_loop_matches_jax_pallas(
        survey_walk):
    square_solve_case(survey_walk)
