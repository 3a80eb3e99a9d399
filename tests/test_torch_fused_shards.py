"""The sharded launch loop's fused launch, run on the CPU.

``parallel/mesh.py`` keeps the planes of the shards that share a device
in one buffer, shard after shard, and launches once over it per loop
step; the kernel's shard table (``WalkParams.shard_table``) gives each
lane its shard's seed. Here a 4-shard mesh of ``chip_smoke.py``'s sweep
box (128 lanes a shard, so a repack block holds two shards) is launched
fused and shard by shard, bit for bit on every lane and plane: with
``walk_plain`` (which walks a table's shards one after another, in the
batches of a one-shard launch), and with the kernel built by the host
compiler
(``tests/host_cuda/host_walk.py``) for the survey's build (the one-thread
loop), the sharded flagship's chain + MIS build and the chain at 64
rejection rounds, whose redraw rounds go through the block's queue with
their lane's seed (both the repack loop). Lane packing in place equals
the rebinding pack it replaced, and the shard table refuses what does
not fit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, make_mesh
from dcrmontecarlo_tpu_torch.parallel import mesh as mesh_mod
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build

torch.set_num_threads(1)

_F, _T = False, True
N_SHARDS = 4
# name: (variant, sweep case, rejection rounds)
BUILDS = {
    "survey": ((0, _F, _F, _F, _F, _T, _F, _F, _F), {}, 1),
    "sharded_flagship": ((1, _T, _T, _F, _F, _T, _F, _F, _F),
                         dict(robin="chain", majorant=True, mis=True), 2),
    "chain_redraw_queue": ((1, _F, _F, _F, _F, _T, _F, _F, _F),
                           dict(robin="chain", alpha="terms"), 64),
}


def _fused(name):
    """``(group, shards, params)``: the build's 4-shard mesh on the CPU,
    each shard 128 lanes, its planes one buffer, 30 plain steps into their
    walks (fused)."""
    variant, case, rounds = BUILDS[name]
    spec = cs.sweep_spec((name, variant, case))
    solver = ShardedWoStSolver(
        cs.sweep_problem(spec), make_mesh(N_SHARDS, device="cpu"),
        dataclasses.replace(cs.sweep_options(
            spec, target_slots=512, pallas_block_rows=1,
            rejection_rounds=rounds), split_threshold=None))
    plan = solver._plan(cs.SWEEP_POINTS, 4096, cs.SWEEP_MAX_STEPS,
                        cs.SWEEP_EPS, 3)
    shards = [solver._shard(plan, d) for d in range(N_SHARDS)]
    group = mesh_mod._Group(shards, plan.rows)
    assert plan.rows == 1 and group.params.variant == variant
    assert group.params.shard_seeds == tuple(s.params.seed for s in shards)
    assert len(set(group.params.shard_seeds)) == N_SHARDS
    wk.walk_plain(group.state, group.params, 30)
    return group, shards, group.params


def _one_by_one(walk, group, shards, budget):
    """Each shard's segment launched alone with its own seed, on copies:
    the planes of the whole buffer, in shard order."""
    out = []
    for s in shards:
        seg = cs.clone_state(s.state)
        walk(seg, s.params, budget)
        out.append(seg)
    return {k: torch.cat([seg[k].reshape(-1) for seg in out]).view(
        group.state[k].shape) for k in group.state}


def _assert_equal(a, b, names):
    for k in names:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_plain_fused_launch_equals_one_shard_launches(name):
    group, shards, params = _fused(name)
    fused = cs.clone_state(group.state)
    wk.walk_plain(fused, params, 24)
    alone = _one_by_one(lambda st, p, n: wk.walk_plain(st, p, n), group,
                        shards, 24)
    _assert_equal(fused, alone, state_planes(params.n_src))
    moved = fused["life"] - group.state["life"]
    for i in range(N_SHARDS):  # every shard walked
        assert int(moved.view(N_SHARDS, -1)[i].sum()) > 0


@pytest.fixture(scope="module", params=sorted(BUILDS))
def host_build(request, tmp_path_factory):
    variant = BUILDS[request.param][0]
    walk = load(start_build(tmp_path_factory.mktemp("fused"), variant,
                            False), variant)
    return request.param, walk


def test_kernel_fused_launch_equals_one_shard_launches(host_build):
    name, walk = host_build
    group, shards, params = _fused(name)
    assert wk.repacked(params.variant) == (name != "survey")
    run = lambda st, p, n: walk(st, p, n, float("inf"))
    fused = cs.clone_state(group.state)
    run(fused, params, 24)
    _assert_equal(fused, _one_by_one(run, group, shards, 24),
                  state_planes(params.n_src))
    # and the fused launch follows the plain walk
    plain = cs.clone_state(group.state)
    wk.walk_plain(plain, params, 24)
    frac, _, finite = wk.compare_planes(fused, plain,
                                        state_planes(params.n_src))
    assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


def test_drained_shard_is_left_as_it_is():
    # a shard without quota in the buffer: the fused launch changes none
    # of its lanes, and the others walk as they would alone
    group, shards, params = _fused("survey")
    shards[1].state["quota"].zero_()
    before = cs.clone_state(group.state)
    wk.walk_plain(group.state, params, 16)
    for k in state_planes(params.n_src):
        assert torch.equal(group.state[k].view(N_SHARDS, -1)[1],
                           before[k].view(N_SHARDS, -1)[1]), k
    assert group.live_counts()[1] == 0
    assert all(c > 0 for i, c in enumerate(group.live_counts()) if i != 1)


def _rebinding_pack(state, pid):
    """The pack before the shared buffer: new tensors bound in the dict."""
    perm = torch.argsort((state["quota"].reshape(-1) <= 0).to(torch.int8),
                         stable=True)
    for k, v in state.items():
        state[k] = v.reshape(-1)[perm].reshape(v.shape)
    return pid[perm]


def test_pack_in_place_equals_rebinding_pack():
    group, shards, params = _fused("survey")
    s = shards[2]
    gen = torch.Generator().manual_seed(0)
    s.state["quota"].view(-1)[torch.rand(128, generator=gen) < 0.4] = 0
    ref_state = cs.clone_state(s.state)
    ref_pid = _rebinding_pack(ref_state, s.pid.clone())
    ptrs = {k: v.data_ptr() for k, v in s.state.items()}
    mesh_mod._pack(s.state, s.pid)
    for k in s.state:
        assert torch.equal(s.state[k], ref_state[k]), k
        assert s.state[k].data_ptr() == ptrs[k]  # still the buffer's view
    assert torch.equal(s.pid, ref_pid)
    seg = slice(2 * 128, 3 * 128)
    assert torch.equal(group.state["quota"].view(-1)[seg],
                       ref_state["quota"].view(-1))
    q = s.state["quota"].view(-1) > 0
    assert bool(q[:int(q.sum())].all())  # active lanes first


def test_shard_table_refuses_what_does_not_fit():
    group, shards, params = _fused("survey")
    seeds, per = params.shard_table(512)
    assert per == 128 and list(seeds) == [s.params.seed for s in shards]
    one, n = shards[0].params.shard_table(128)
    assert n == 128 and list(one) == [shards[0].params.seed]
    with pytest.raises(ValueError, match="do not fit"):
        params.shard_table(513)
    many = dataclasses.replace(params, shard_seeds=tuple(
        range(wk.MAX_SHARDS + 1)))
    with pytest.raises(NotImplementedError, match="groups"):
        many.shard_table(128 * (wk.MAX_SHARDS + 1))


def test_groups_split_a_device_above_the_table():
    # more shards on a device than one table holds launch in groups
    spec = cs.sweep_spec(("survey", BUILDS["survey"][0], {}))
    solver = ShardedWoStSolver(
        cs.sweep_problem(spec), make_mesh(wk.MAX_SHARDS + 2, device="cpu"),
        cs.sweep_options(spec, target_slots=128 * (wk.MAX_SHARDS + 2),
                         pallas_block_rows=1))
    plan = solver._plan(cs.SWEEP_POINTS[:1], 64 * (wk.MAX_SHARDS + 2), 50,
                        cs.SWEEP_EPS, 0)
    shards = [solver._shard(plan, d) for d in range(wk.MAX_SHARDS + 2)]
    groups = solver._groups(plan, shards)
    assert [len(g.shards) for g in groups] == [wk.MAX_SHARDS, 2]
    assert np.all([g.params.shard_table(g.state["px"].numel())[0].size
                   == len(g.shards) for g in groups])
