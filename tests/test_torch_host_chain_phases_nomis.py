"""The Robin-chain builds without MIS, their wall work queued, on the CPU.

``csrc/walk_kernel.cu`` steps the variants of ``walk_variant.h::
chain_phases`` (the Robin chain without the freeze) in the repack loop,
and runs their chain's wall work (the chord mass, the wall-arrival
factor, the chord branch) from a queue in the block's shared memory, one
entry a thread (``walk_step_chain``); without MIS the next-event estimate
is the one-thread loop's, and where the rejection sampler runs more than
two rounds, the redraw rounds of a lane that rejected its round-0 draw go
through a queue too. Here the host
compiler builds the two such variants the paths launch without MIS, the
accuracy path's chain + majorant ``<1,true,false,false,false,true,false>``
and the chain with ``TERMS`` fields compiled in
``<1,false,false,false,false,true,false>`` (on a ``TERMS`` alpha, as the
variable-coefficient model runs it), from the shipped source and with the
one-thread-per-lane loop in place of the repack loop
(``tests/host_cuda/host_walk.py``). On a 1,024-lane state of
``chip_smoke.py``'s sweep box with a Robin wall, at the accuracy path's 2
rejection rounds (the redraw round on its lane) and at the variable
coefficients' 64 (the redraw rounds queued), each launch is held to the
one-thread build bit for bit on every lane and
to ``walk_plain`` by ``compare_planes``: with a block whose every lane
stands on the wall, one in which none does, one with a single wall lane,
and at budgets around a round's length; and 16 one-step launches equal
one 16-step launch, bit for bit.
"""

import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build

torch.set_num_threads(1)

_F, _T = False, True
# name: (variant, sweep case, rejection rounds)
BUILDS = {
    "accuracy": ((1, _T, _F, _F, _F, _T, _F, _F, _F),
                 dict(robin="chain", majorant=True), 2),
    "chain_terms_fields": ((1, _F, _F, _F, _F, _T, _F, _F, _F),
                           dict(robin="chain", alpha="terms"), 64),
}


def make_build(tmp, name):
    """``(walk, one_thread_walk, state, params)`` of the build ``name``:
    its host build from the shipped source and with the one-thread loop
    (the two compile at once), and its state: 1,024 lanes (four blocks),
    40 plain steps into their walks."""
    variant, case, rounds = BUILDS[name]
    started = [start_build(tmp, variant, one) for one in (False, True)]
    spec = cs.sweep_spec((name, variant, case))
    solver = WoStSolver(cs.sweep_problem(spec), cs.sweep_options(
        spec, target_slots=1024, pallas_block_rows=1,
        rejection_rounds=rounds),
        device="cpu")
    state, params, _, _ = solver._setup(
        cs.SWEEP_POINTS, 4096, cs.SWEEP_MAX_STEPS, cs.SWEEP_EPS, 3)
    assert params.variant == variant and wk.chain_phases(variant)
    assert params.mis_table is None and params.rejection_rounds == rounds
    walk, one_thread = (load(b, variant) for b in started)
    assert state["px"].numel() == 4 * walk.schedule[0]
    wk.walk_plain(state, params, 40)
    return walk, one_thread, state, params


@pytest.fixture(scope="module", params=sorted(BUILDS))
def build(request, tmp_path_factory):
    return make_build(tmp_path_factory.mktemp("host_chain_nomis"),
                      request.param)


@pytest.mark.parametrize("case", cs.CHAIN_CASES)
def test_chain_nomis_matches_one_thread_and_plain(build, case):
    walk, one_thread, state, params = build
    block, steps, _ = walk.schedule
    start, budget = cs.chain_case(state, case, block, steps)
    ob0 = start["ob"].view(-1)[:block][start["quota"].view(-1)[:block] > 0]
    want = {"every_lane_on_wall": int(ob0.numel()), "no_lane_on_wall": 0,
            "one_wall_lane": 1}.get(case)
    assert want is None or int(ob0.sum()) == want
    kern, one, plain = (cs.clone_state(start) for _ in range(3))
    walk(kern, params, budget, float("inf"))
    # the same arithmetic with one thread a lane: equal on every lane
    one_thread(one, params, budget, float("inf"))
    for k in state_planes(params.n_src):
        assert torch.equal(kern[k], one[k]), k
    wk.walk_plain(plain, params, budget)
    frac, _, finite = wk.compare_planes(kern, plain,
                                        state_planes(params.n_src))
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    moved = (kern["life"] - start["life"]) + (kern["ndone"] - start["ndone"])
    assert int(moved.max()) <= budget
    assert int(moved.view(-1)[:block].sum()) > 0
    # the sources took next-event estimates
    assert bool((kern["acc0"] != start["acc0"]).any())


def test_chain_nomis_one_step_launches_equal_one_launch(build):
    # a lane's iterations count per lane, never per round
    walk, _, state, params = build
    one, many = cs.clone_state(state), cs.clone_state(state)
    walk(one, params, 16, float("inf"))
    for _ in range(16):
        walk(many, params, 1, float("inf"))
    for k in state_planes(params.n_src):
        assert torch.equal(one[k], many[k]), k
    assert int((one["life"] - state["life"]).sum()) > 0
