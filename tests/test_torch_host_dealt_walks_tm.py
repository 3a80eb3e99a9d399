"""The dealt loop of the survey's transport and MIS builds, run on the CPU.

``csrc/walk_variant.h::dealt`` also names the survey's build with the
transport sampler ``<0,false,false,false,false,true,true>`` and with MIS
``<0,false,true,false,false,true,false>``. Their host builds
(``tests/host_cuda/``) go through the cases of
``test_torch_host_dealt_walks.py``: on ``chip_smoke.py``'s sweep box, with
quotas of 0, 1, 7 and 40 walks, common random numbers, with boundary-snap
starts and without, the dealt launch equals the one-thread loop run in
256-step launches until drained, bit for bit on every plane, and
``walk_plain`` by ``compare_planes``; the MIS build's dealt loop takes the
ball's interior probability once a step and the Box-Muller pair from one
``sincosf``, the one-thread loop anew and by ``cosf`` and ``sinf``. The
box's ``z = r sqrt(sigma_bar)`` stays under the transport map's switch
(11.5), so a dealt launch of the geophysical survey (200 m box, every
walk's first star past the switch) is held to the drained one-thread loop
too. The solves against the JAX package are in
``test_torch_host_dealt_walks_tm_jax.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_host_dealt_walks import NAMES, SURVEY_MIS, TRANSPORT, \
    _clone, _drained, dealt_launch_case, host_builds

torch.set_num_threads(1)

HERE = (TRANSPORT, SURVEY_MIS)  # this file's builds
Z_SW = 11.5  # the transport map's switch to the free density


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, HERE)


@pytest.mark.parametrize("snap", ["auto", None], ids=["snap", "no_snap"])
@pytest.mark.parametrize("variant", HERE, ids=[NAMES[v] for v in HERE])
def test_dealt_launch_equals_drained_one_thread_loop(host_walks, variant,
                                                     snap):
    _, dealt = dealt_launch_case(host_walks[variant], variant, snap)
    if variant == SURVEY_MIS:  # MIS banks at its samples
        assert int((dealt["asum0"] != 0).sum()) > 0


def test_transport_dealt_launch_on_the_survey_equals_drained_loop(
        host_walks):
    walk = host_walks[TRANSPORT]
    survey, electrodes, options = cs.survey_config("transport")
    solver = WoStSolver(survey.build_problem(), dataclasses.replace(
        options, target_slots=256, min_quota=1), device="cpu")
    state, params, _, bound = solver._setup(
        cs.survey_points(electrodes, -0.5), 64, 500, 0.9, 5)
    assert params.variant == TRANSPORT
    # a walk's first star reaches past the switch from every start, and
    # later stars near a wall fall under it
    d0, _, _ = wk._closest_point(params, state["p0x"].reshape(-1),
                                 state["p0y"].reshape(-1))
    z0 = d0 * np.sqrt(params.sigma_bar)
    assert float(z0.min()) > Z_SW
    dealt, one = _clone(state), _clone(state)
    assert walk.loop(dealt, params, bound, None) == "dealt"
    assert _drained(walk, one, params) >= 1
    for k in state_planes(params.n_src):
        assert torch.equal(dealt[k], one[k]), k
    assert int(dealt["quota"].max()) == 0
    assert int((dealt["life"] - state["life"]).sum()) > 10 * int(
        state["quota"].sum())
