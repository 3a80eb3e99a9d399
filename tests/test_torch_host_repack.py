"""The freeze builds' repack loop, run on the CPU.

``csrc/walk_kernel.cu`` steps the lanes of a freeze build (the host
loop's split) in rounds of ``REPACK_STEPS`` iterations and packs a
block's live lanes into its lowest threads between rounds
(``walk_repacked``). Here the host compiler builds the flagship's freeze
variant (chain + majorant + MIS + freeze) with
``tests/host_cuda/cuda_runtime.h``: one host thread per CUDA thread, the
block's barriers and ``__syncthreads_count`` emulated, a block at a time.
On a 1,024-lane state of ``chip_smoke.py``'s sweep box (axis-aligned
walls keep walks in step across math libraries) the launch is held to
``walk_plain`` by ``compare_planes``, and to the same variant built with
one thread a lane for the whole launch bit for bit on every lane, at
budgets around a round's length, with a block whose every lane is heavy,
a block with one steppable lane and without a threshold; and 16 one-step
launches equal one 16-step launch, bit for bit.
"""

import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver import WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build

torch.set_num_threads(1)

FLAGSHIP = (wk.ROBIN_CHAIN, True, True, True, False, True, False, False,
            False)
SPEC = cs.sweep_spec(("flagship", FLAGSHIP, dict(
    robin="chain", majorant=True, mis=True, split=4.0)))
THR = 4.0


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """``walk(state, params, budget, thr)``: one launch of the host-built
    flagship variant on CPU planes, in place."""
    return load(start_build(tmp_path_factory.mktemp("host_repack"),
                            FLAGSHIP, False), FLAGSHIP)


@pytest.fixture(scope="module")
def one_thread_walk(tmp_path_factory):
    """The same with one thread a lane for the whole launch."""
    return load(start_build(tmp_path_factory.mktemp("host_one_thread"),
                            FLAGSHIP, True), FLAGSHIP)


@pytest.fixture(scope="module")
def box_state(host_walk):
    """1,024 lanes (768 working, four blocks) of the flagship's switches
    on the sweep box, 40 plain steps into their walks: some lanes heavy,
    some recycled."""
    solver = WoStSolver(cs.sweep_problem(SPEC), cs.sweep_options(
        SPEC, target_slots=1024, pallas_block_rows=1), device="cpu")
    state, params, _, _ = solver._setup(cs.SWEEP_POINTS, 4096,
                                        cs.SWEEP_MAX_STEPS, cs.SWEEP_EPS, 3)
    assert params.variant == FLAGSHIP and state["px"].numel() == \
        4 * host_walk.schedule[0]
    wk.walk_plain(state, params, 40, freeze_thr=THR)
    heavy = state["atten"].abs() > THR
    assert 0 < int((heavy & (state["quota"] > 0)).sum()) < 700
    return state, params


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("case", cs.REPACK_CASES)
def test_repacked_loop_matches_plain(host_walk, one_thread_walk, box_state,
                                     case):
    state, params = box_state
    start, budget, thr = cs.repack_case(state, case, THR, host_walk.schedule)
    kern, plain, one = _clone(start), _clone(start), _clone(start)
    host_walk(kern, params, budget, thr)
    # the same arithmetic with one thread a lane: equal on every lane
    one_thread_walk(one, params, budget, thr)
    for k in state_planes(params.n_src):
        assert torch.equal(kern[k], one[k]), k
    wk.walk_plain(plain, params, budget, freeze_thr=thr)
    frac, _, finite = wk.compare_planes(kern, plain,
                                        state_planes(params.n_src))
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    moved = (kern["life"] - start["life"]) + (kern["ndone"] - start["ndone"])
    assert int(moved.max()) <= budget
    if case == "one_steppable_lane":
        # the lone lane walked on; the block's lanes without quota did not
        b0 = slice(0, host_walk.schedule[0])
        assert int(moved.view(-1)[b0].sum()) > 0
        q0 = start["quota"].view(-1)[b0] <= 0
        for k in state_planes(params.n_src):
            assert torch.equal(kern[k].view(-1)[b0][q0],
                               start[k].view(-1)[b0][q0]), k
    if case == "every_lane_heavy":
        # heavy lanes only bank a walk that is due, then walk on light
        b0 = slice(0, host_walk.schedule[0])
        banked = (kern["ndone"] - start["ndone"]).view(-1)[b0] > 0
        still = ~banked & (start["quota"].view(-1)[b0] > 0)
        assert torch.equal(kern["px"].view(-1)[b0][still],
                           start["px"].view(-1)[b0][still])
        assert int(still.sum()) > 0


def test_one_step_launches_equal_one_launch(host_walk, box_state):
    # a lane's iterations count per lane, never per round: 16 launches of
    # one iteration give one 16-iteration launch bit for bit
    state, params = box_state
    one, many = _clone(state), _clone(state)
    host_walk(one, params, 16, THR)
    for _ in range(16):
        host_walk(many, params, 1, THR)
    for k in state_planes(params.n_src):
        assert torch.equal(one[k], many[k]), k
    assert int((one["life"] - state["life"]).sum()) > 0
