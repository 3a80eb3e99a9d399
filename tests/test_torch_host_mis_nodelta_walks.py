"""MIS without delta tracking, run on the CPU, bit for bit.

``csrc/walk_kernel.cu``'s static form without delta tracking with MIS
``<0,false,true,false,false,false,false>`` (``chip_smoke.py`` phase 49's
narrow source: ``tests/test_pseudosection.py:150-176``'s unit Gaussian of
width 0.05 on ``square_loop(2.0)`` with its one-component mixture) takes
its step's direction and its Box-Muller pair from one ``sincosf`` each
(``walk_kernel.one_sincos``). The host compiler builds it
(``tests/host_cuda/``) as shipped and without that hook
(``host_walk.PLAIN_LOOP``: ``cosf`` and ``sinf``, the loop it ran before).
On the narrow source's square and on phase 27's Neumann box with the
Gaussian near its wall (MIS's star test acts), with quotas of 0, 1, 7 and
40 walks a lane and walks that start at the source's centre, next to it
and across the domain: a launch that drains every quota and launches of budgets that
leave walks mid-way equal the hookless build on every plane bit for bit
(so ``sincosf`` gives the host's ``cosf`` and ``sinf`` bits on these
walks' angles), the shipped build's single launch equals its own 256-step
launches until drained, and both follow ``walk_plain`` by
``compare_planes``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build
from test_torch_nodelta import BOX, WALL

torch.set_num_threads(1)

_F, _T = False, True
MIS_ND = (0, _F, _T, _F, _F, _F, _F, _F, _F)
QUOTAS = (0, 1, 7, 40)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{kind: walk}``: the build as shipped ("own") and without its hook
    ("plain")."""
    tmp = tmp_path_factory.mktemp("mis_nodelta")
    started = {"own": start_build(tmp, MIS_ND, False),
               "plain": start_build(tmp, MIS_ND, False, plain_loop=True)}
    return {k: load(b, MIS_ND) for k, b in started.items()}


def _box():
    """Phase 27's Neumann box with the narrow Gaussian at (0, -0.3)."""
    w = cs.NARROW_WIDTH
    return Problem(dirichlet=Polyline.from_points(BOX),
                   neumann=Polyline.from_points(WALL),
                   bc_dirichlet=fields.constant(0.0),
                   source=fields.gaussian_bump((0.0, -0.3),
                                               1.0 / (2 * np.pi * w * w), w),
                   source_importance=fields.GaussianMixture.from_components(
                       [((0.0, -0.3), w, 1.0)]))


# (problem, start points): the square of half-width 2 (the source's
# centre, the test's two points, points across the square and one next to
# the source), the box (the source, points under the wall and near a
# corner)
CASES = {
    "narrow_square": (lambda: cs.narrow_source_config()[0],
                      [[0.0, 0.0], [0.5, 0.0], [1.0, 1.0], [-1.0, 0.25],
                       [0.03, -0.02], [0.9, -0.99]]),
    "narrow_box": (_box, [[0.0, -0.3], [0.2, -0.5], [-0.6, -0.1],
                          [0.5, -0.9], [0.0, -0.05], [-0.9, -0.9]]),
}


def _state(name, max_steps=300):
    """``(state, params)``: fresh lanes of ``name``'s case, quotas 0, 1, 7
    and 40 in turn."""
    make, pts = CASES[name]
    solver = WoStSolver(make(), SolverOptions(target_slots=384, min_quota=1),
                        device="cpu")
    state, params, _, _ = solver._setup(np.asarray(pts, np.float32), 64,
                                        max_steps, 1e-3, 3)
    assert params.variant == MIS_ND and wk.one_sincos(params.variant)
    n = state["px"].numel()
    state["quota"] = torch.tensor(QUOTAS, dtype=torch.int32).repeat(
        n // len(QUOTAS) + 1)[:n].view_as(state["quota"]).clone()
    return state, params


def _equal(a, b, params, what):
    for k in state_planes(params.n_src):
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("name", list(CASES))
def test_draining_launch_equals_the_plain_loop(builds, name):
    state, params = _state(name)
    budget = int(state["quota"].max()) * (params.max_steps + 1)
    own, plain, drained, ref = (cs.clone_state(state) for _ in range(4))
    builds["own"](own, params, budget, float("inf"))
    builds["plain"](plain, params, budget, float("inf"))
    _equal(own, plain, params, "single launch")
    assert int(own["quota"].max()) == 0
    assert torch.equal(own["ndone"] - state["ndone"], state["quota"])
    launches = 0
    while bool((drained["quota"] > 0).any()):
        builds["own"](drained, params, 256, float("inf"))
        launches += 1
    assert launches > 1
    _equal(own, drained, params, "256-step launches")
    wk.walk_plain(ref, params, budget)
    frac, _, finite = wk.compare_planes(own, ref, state_planes(params.n_src))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("name,max_steps,cut", [
    ("narrow_square", 300, 256), ("narrow_square", 16, 7 * 17),
    ("narrow_square", 16, 7 * 17 - 1), ("narrow_square", 2, 20),
    ("narrow_box", 300, 17), ("narrow_box", 16, 5)])
def test_budgeted_launches_equal_the_plain_loop(builds, name, max_steps,
                                                cut):
    state, params = _state(name, max_steps)
    own, plain = cs.clone_state(state), cs.clone_state(state)
    for _ in range(3):
        builds["own"](own, params, cut, float("inf"))
        builds["plain"](plain, params, cut, float("inf"))
        _equal(own, plain, params, f"budget {cut}")
    assert int((own["life"] - state["life"]).sum()) > 0


def test_the_mixture_acts(builds):
    # the mixture's samples reach the accumulators: without it the walks
    # (positions, steps) stay and the banked sums move
    import dataclasses

    state, params = _state("narrow_square")
    budget = int(state["quota"].max()) * (params.max_steps + 1)
    mis, plain = cs.clone_state(state), cs.clone_state(state)
    builds["own"](mis, params, budget, float("inf"))
    wk.walk_plain(plain, dataclasses.replace(params, mis_table=None),
                  budget)
    assert torch.equal(mis["life"], plain["life"])
    assert cs.lanes_differ(mis, plain, ("asum0",)) > 0.2
