"""The pole-pole line's pole records against the JAX package.

The host compiler builds ``csrc/walk_kernel.cu``'s wide survey in its
general rows build
``<0,false,false,false,false,true,false,true,false,false,true>``
(``tests/host_cuda/``), where every source of ``chip_smoke.py``'s
pole-pole line (nine unit poles at the scenario's buried electrodes,
``fields.gaussian_bump``) is marked and evaluated from its pole record
(``walk_kernel.pole_record``). The solver's adaptive single launch runs
through it as the card's wrapper launches it (the walks dealt to the
threads), with the survey defaults (common random numbers, roulette, two
rejection rounds, boundary-snap starts), and agrees with the JAX
package's ``WoStSolver`` on its XLA backend at the same seed and options:
every potential within 4 sigma, the two errors in quadrature.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.survey import survey_default_options
from test_torch_host_dealt_walks import WIDE, host_builds
from test_torch_host_dealt_walks_jax import _dealt_walk

torch.set_num_threads(1)

ROWS = WIDE + (False, True)


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, (ROWS,))


def test_pole_records_line_matches_jax_xla(host_walks):
    from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
    from dcrmontecarlo_tpu.problems import fields as jf
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
    from dcrmontecarlo_tpu.survey import \
        survey_default_options as j_options

    survey, electrodes, tprob, _ = cs.pole_config()
    pts = cs.survey_points(electrodes, -0.5)
    jsurvey, j_electrodes = j_geo(sharpness=0.5)
    w = jsurvey.source_width
    jprob = jsurvey.build_problem()
    jprob.set_source_term([
        jf.gaussian_bump(jsurvey._bury_source(e),
                         1.0 / (2.0 * math.pi * w * w), w)
        for e in j_electrodes])
    want = JSolver(jprob, j_options(backend="xla", target_slots=4096)).solve(
        pts, n_walks=128, max_steps=500, eps=0.9, seed=6)
    solver = WoStSolver(tprob, survey_default_options(target_slots=4096),
                        device="cpu")
    params = solver._setup(pts, 128, 500, 0.9, 6)[1]
    assert params.variant == ROWS and params.poles == tuple(range(9))
    _, ip = params.pack()
    kinds = ip[len(ip) - 2 * len(params.specs) + 6::2]  # the sources'
    assert (kinds == wk.POLE_KIND).all()
    walk = _dealt_walk(host_walks[ROWS])
    got = solver._solve_raw(pts, 128, 500, 0.9, 6, walk=walk)
    assert walk.loops == ["dealt"]
    w_mean, w_se = np.asarray(want.mean), np.asarray(want.stderr)
    assert got.mean.shape == w_mean.shape == (9, 9)
    lim = 4.0 * np.hypot(got.stderr, w_se)
    assert (np.abs(got.mean - w_mean) <= lim).all(), (got.mean, w_mean,
                                                      lim)
    assert (got.stderr > 0).sum() > 70
