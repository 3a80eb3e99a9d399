"""The dealt loop of the survey builds, run on the CPU.

A launch of ``csrc/walk_variant.h::dealt``'s builds (the survey's
``<0,false,false,false,false,true,false>`` and the wide survey with MIS
``<0,false,true,false,false,true,false,true>`` here; the survey's build
with the transport sampler and with MIS in
``test_torch_host_dealt_walks_tm.py``, through the same cases) that holds
one shard,
whose budget covers every quota (``quota * (max_steps + 1)``) and whose
lanes with quota stand at a walk's start deals walks, not lanes, to the
threads (``walk_dealt``) and folds each lane's records in walk order
(``walk_fold``). Here the host compiler builds both with
``tests/host_cuda/cuda_runtime.h``. On ``chip_smoke.py``'s sweep box
(axis-aligned walls keep walks in step across math libraries), with
uneven quotas (0, 1, 7 and 40 walks), common random numbers, and with
boundary-snap starts and without: the dealt launch equals the one-thread
loop run in 256-step launches until drained, bit for bit on every plane,
and ``walk_plain`` by ``compare_planes``. A launch that misses any of the
three conditions runs the build's own loop and equals it. The whole
solves against the JAX package are in ``test_torch_host_dealt_walks_jax.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build

torch.set_num_threads(1)

SURVEY = (wk.ROBIN_OFF, False, False, False, False, True, False, False,
          False)
WIDE_MIS = (wk.ROBIN_OFF, False, True, False, False, True, False, True,
            False)
TRANSPORT = (wk.ROBIN_OFF, False, False, False, False, True, True, False,
             False)
SURVEY_MIS = (wk.ROBIN_OFF, False, True, False, False, True, False, False,
              False)
WIDE = (wk.ROBIN_OFF, False, False, False, False, True, False, True, False)
SHORT = (wk.ROBIN_OFF, False, False, False, False, False, False, False,
         False)
# the dealt builds, each with its sweep case's build and its test id
BUILDS = {SURVEY: {}, WIDE_MIS: dict(mis=True, n_src=5),
          TRANSPORT: dict(sampler="transport"), SURVEY_MIS: dict(mis=True),
          WIDE: dict(n_src=5)}
NAMES = {SURVEY: "survey", WIDE_MIS: "wide_mis", TRANSPORT: "transport",
         SURVEY_MIS: "survey_mis", WIDE: "wide", SHORT: "short"}
HERE = (SURVEY, WIDE_MIS)  # this file's builds
QUOTAS = (0, 1, 7, 40)
MAX_STEPS = 16


def host_builds(tmp_path_factory, variants):
    """``{variant: walk}``: the host builds of ``variants``
    (``host_walk.load``; ``walk.loop`` launches as the card's wrapper)."""
    tmp = tmp_path_factory.mktemp("host_dealt")
    builds = {v: start_build(tmp, v, False) for v in variants}
    return {v: load(b, v) for v, b in builds.items()}


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, HERE)


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _box_state(variant, snap, n_walks=4096, max_steps=MAX_STEPS, crn=True,
               case=None, sources=None):
    """512 fresh lanes of ``variant`` on the sweep box (its sweep ``case``,
    by default ``BUILDS``'; ``sources`` in place of its own; CRN unless
    ``crn`` is false, roulette, ``boundary_snap=snap``), quotas 0, 1, 7,
    40 in turn."""
    spec = cs.sweep_spec(("dealt", variant,
                          BUILDS[variant] if case is None else case))
    problem = cs.sweep_problem(spec)
    if sources is not None:
        problem.set_source_term(sources)
    solver = WoStSolver(problem, dataclasses.replace(cs.sweep_options(
        spec, target_slots=512, pallas_block_rows=1, boundary_snap=snap),
        common_random_numbers=crn), device="cpu")
    state, params, _, _ = solver._setup(cs.SWEEP_POINTS, n_walks,
                                        max_steps, cs.SWEEP_EPS, 3)
    assert params.variant == variant and params.snap == (snap is not None)
    n = state["px"].numel()
    state["quota"] = torch.tensor(QUOTAS, dtype=torch.int32).repeat(
        n // len(QUOTAS) + 1)[:n].view_as(state["quota"]).clone()
    return state, params


def _drained(walk, state, params):
    """The one-thread loop in 256-step launches until every quota is
    drained; returns the launches."""
    launches = 0
    while bool((state["quota"] > 0).any()):
        walk(state, params, 256, float("inf"))
        launches += 1
    return launches


def _budget(state, params):
    return int(state["quota"].max()) * (params.max_steps + 1)


def dealt_launch_case(walk, variant, snap):
    """The dealt launch of ``variant``'s host build ``walk`` from the box
    state with or without snap starts: every plane equal to the drained
    one-thread loop's, bit for bit, and to ``walk_plain``'s by
    ``compare_planes``; returns the start and the dealt launch's end."""
    state, params = _box_state(variant, snap)
    if snap is not None:
        assert 0 < int(state["ob0"].sum()) < state["ob0"].numel()
    dealt, one, plain = _clone(state), _clone(state), _clone(state)
    assert walk.loop(dealt, params, _budget(state, params), None) == "dealt"
    assert _drained(walk, one, params) > 1
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(dealt[k], one[k]), k
    assert int(dealt["quota"].max()) == 0
    assert torch.equal(dealt["ndone"] - state["ndone"], state["quota"])
    assert int((dealt["tn"] > 0).sum()) > 0  # some walks hit max_steps
    wk.walk_plain(plain, params, _budget(state, params))
    frac, _, finite = wk.compare_planes(dealt, plain, names)
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    return state, dealt


@pytest.mark.parametrize("snap", ["auto", None], ids=["snap", "no_snap"])
@pytest.mark.parametrize("variant", HERE, ids=[NAMES[v] for v in HERE])
def test_dealt_launch_equals_drained_one_thread_loop(host_walks, variant,
                                                     snap):
    dealt_launch_case(host_walks[variant], variant, snap)


@pytest.mark.parametrize("case", ["budget_short", "mid_walk", "shards",
                                  "below_one_walk"])
def test_launch_off_the_rule_runs_the_one_thread_loop(host_walks, case):
    walk = host_walks[SURVEY]
    state, params = _box_state(SURVEY, "auto")
    budget = _budget(state, params)
    if case == "budget_short":
        budget -= 1
    elif case == "mid_walk":
        # lanes a step into their walks: not at a walk's start
        walk(state, params, 1, float("inf"))
        assert int(((state["quota"] > 0) & (state["steps"] > 0)).sum()) > 0
        budget = _budget(state, params)
    elif case == "shards":
        seeds, _ = params.shard_table(state["px"].numel())
        params = dataclasses.replace(
            params, shard_seeds=(int(seeds[0]), int(seeds[0]) ^ 0x5A5A),
            shard_lanes=state["px"].numel() // 2)
    else:
        budget = params.max_steps
    got, one = _clone(state), _clone(state)
    loop = walk.loop(got, params, budget, None)
    assert loop == ("shards" if case == "shards" else "lanes")
    walk(one, params, budget, float("inf"))
    for k in state_planes(params.n_src):
        assert torch.equal(got[k], one[k]), k
    assert int((got["life"] - state["life"]).sum()) > 0


def test_dealt_rule_names_the_four_builds():
    # the survey's four builds, and since the wide survey without MIS: the
    # five of BUILDS, and the general rows builds of its two wide ones
    assert all(wk.dealt(v) for v in BUILDS)
    dealt = [v for v in wk.KERNEL_VARIANTS if wk.dealt(v)]
    assert sorted(dealt) == sorted(list(BUILDS) + [
        v + (False, True) for v in BUILDS if v[7]])
    assert not any(wk.repacked(v) for v in dealt)
    # the transport builds with MIS or the wide form, and the builds
    # without delta tracking (the short walk's static form ran slower
    # dealt) stay on their own loops
    assert not any(wk.dealt(v) for v in (
        (*TRANSPORT[:2], True, *TRANSPORT[3:]),
        (*TRANSPORT[:7], True, False), (*WIDE_MIS[:6], True, True, False),
        SHORT, (*SHORT[:2], True, *SHORT[3:]), (*SHORT[:7], True, False)))
