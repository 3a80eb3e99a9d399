"""The dealt loop of the wide survey without MIS, run on the CPU; the
short walk's build keeps its own loop.

``csrc/walk_variant.h::dealt`` also names the wide survey without MIS
``<0,false,false,false,false,true,false,true>`` (the scenario
pseudosection, ``chip_smoke.py`` phase 44). Its host build
(``tests/host_cuda/``) goes through the cases of
``test_torch_host_dealt_walks.py``: on ``chip_smoke.py``'s sweep box
(axis-aligned walls keep walks in step across math libraries), with quotas
of 0, 1, 7 and 40 walks, with common random numbers and
without, with boundary-snap starts and without, the dealt launch equals
the one-thread loop run in 256-step launches until drained, bit for bit on
every plane, and ``walk_plain`` by ``compare_planes``; with 5, 6 (the
scenario line's count) and 32 sources, each accumulating. A launch that
misses any of the dealt loop's three conditions runs the build's own loop
and equals it. The static form without delta tracking
``<0,false,false,false,false,false,false>`` (the short walk, phase 25) ran
slower dealt on the card and stays off the rule: its launch that drains
every quota from fresh walks runs the one-thread loop, equal to the plain
walk. The solves against the JAX package are in
``test_torch_host_dealt_walks_wide_jax.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import fields
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_host_dealt_walks import BUILDS, SHORT, WIDE, _budget, \
    _clone, _drained, host_builds
from test_torch_host_dealt_walks import _box_state as box_state

torch.set_num_threads(1)

HERE = (WIDE, SHORT)  # this file's builds
# each build's sweep case (chip_smoke.sweep_spec): the short walk's without
# a conductivity, with x + y on the walls and a dipole source
SPECS = {WIDE: BUILDS[WIDE], SHORT: dict(alpha=None, bc="poly")}


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, HERE)


def _dipoles(n_src):
    """``n_src`` Gaussian dipoles inside the sweep box, their ends drawn
    from a seeded numpy generator."""
    rng = np.random.default_rng(16)
    ends = rng.uniform((-1.8, -3.8), (1.8, -0.3), size=(n_src, 2, 2))
    return [fields.gaussian_dipole(tuple(a), tuple(b), 1.0, cs.SWEEP_WIDTH)
            for a, b in ends.astype(np.float32).tolist()]


def _box_state(variant, snap, crn, n_src=None):
    """``test_torch_host_dealt_walks._box_state``'s 512 lanes of
    ``variant`` (with ``n_src`` dipoles of ``_dipoles`` in the wide form;
    ``common_random_numbers=crn``)."""
    state, params = box_state(variant, snap, crn=crn, case=SPECS[variant],
                              sources=None if n_src is None
                              else _dipoles(n_src))
    assert params.n_src == (SPECS[variant].get("n_src", 1)
                            if n_src is None else n_src)
    return state, params


def dealt_launch_case(walk, snap, crn, n_src):
    """The dealt launch of the wide survey's host build ``walk`` from the
    box state with ``n_src`` sources: every plane equal to the drained
    one-thread loop's, bit for bit; then on its first 128 lanes at quotas
    of at most 7 (the plain walk's CPU time) a dealt launch equal to
    ``walk_plain``'s by ``compare_planes``."""
    state, params = _box_state(WIDE, snap, crn, n_src)
    assert wk.dealt(params.variant)
    if snap is not None:
        assert 0 < int(state["ob0"].sum()) < state["ob0"].numel()
    dealt, one = _clone(state), _clone(state)
    assert walk.loop(dealt, params, _budget(state, params), None) == "dealt"
    assert _drained(walk, one, params) > 1
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(dealt[k], one[k]), k
    assert int(dealt["quota"].max()) == 0
    assert torch.equal(dealt["ndone"] - state["ndone"], state["quota"])
    assert int((dealt["tn"] > 0).sum()) > 0  # some walks hit max_steps
    for i in range(params.n_src):  # every source banked
        assert int((dealt[f"asum{i}"] != 0).sum()) > 0, i
    small = {k: v.reshape(-1)[:128].clone() for k, v in state.items()}
    small["quota"].clamp_(max=7)
    got, plain = _clone(small), _clone(small)
    assert walk.loop(got, params, _budget(small, params), None) == "dealt"
    wk.walk_plain(plain, params, _budget(small, params))
    frac, _, finite = wk.compare_planes(got, plain, names)
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("crn", [True, False], ids=["crn", "no_crn"])
@pytest.mark.parametrize("snap", ["auto", None], ids=["snap", "no_snap"])
def test_dealt_launch_equals_drained_one_thread_loop(host_walks, snap, crn):
    dealt_launch_case(host_walks[WIDE], snap, crn, 6)


@pytest.mark.parametrize("n_src", [5, 32])
def test_wide_dealt_launch_with_5_and_32_sources(host_walks, n_src):
    dealt_launch_case(host_walks[WIDE], "auto", True, n_src)


@pytest.mark.parametrize("crn", [True, False], ids=["crn", "no_crn"])
@pytest.mark.parametrize("snap", ["auto", None], ids=["snap", "no_snap"])
def test_short_walk_launch_keeps_the_one_thread_loop(host_walks, snap, crn):
    # a launch that drains every quota from fresh walks, which the dealt
    # builds deal: the short walk's runs its own loop, equal to one
    # launch of the one-thread loop, and to walk_plain
    walk = host_walks[SHORT]
    state, params = _box_state(SHORT, snap, crn)
    assert not wk.dealt(params.variant)
    got, one = _clone(state), _clone(state)
    assert walk.loop(got, params, _budget(state, params), None) == "lanes"
    walk(one, params, _budget(state, params), float("inf"))
    names = state_planes(params.n_src)
    for k in names:
        assert torch.equal(got[k], one[k]), k
    assert int(got["quota"].max()) == 0
    assert int((got["asum0"] != 0).sum()) > 0
    small = {k: v.reshape(-1)[:128].clone() for k, v in state.items()}
    small["quota"].clamp_(max=7)
    ks, plain = _clone(small), _clone(small)
    assert walk.loop(ks, params, _budget(small, params), None) == "lanes"
    wk.walk_plain(plain, params, _budget(small, params))
    frac, _, finite = wk.compare_planes(ks, plain, names)
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("case", ["budget_short", "mid_walk", "shards",
                                  "below_one_walk"])
def test_launch_off_the_rule_runs_the_one_thread_loop(host_walks, case):
    walk = host_walks[WIDE]
    state, params = _box_state(WIDE, "auto", True)
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
