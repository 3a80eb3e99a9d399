"""The fused sharded launch on a 4-shard mesh against the JAX package.

``ShardedWoStSolver`` on ``make_mesh(4)`` (CPU shards, so one launch a
loop step runs all four) walks the JAX package's
``ShardedWoStSolver(backend="pallas")`` walks in interpret mode on four of
the conftest's virtual CPU devices: the square of
``tests/test_pallas_walk.py:278-297`` with and without common random
numbers, and the bump-alpha split of ``:327-355`` (every shard clones,
shards 2 and 3 from negative int32 ranges) give equal total steps and
clone counts, and sums to rel 1e-5 (float32 sums of identical walks in
another order, as ``test_torch_parallel.py`` holds two shards). The fused
loop's rows (moments, steps, ``max_banked``, launches and clones per
shard) equal those of each shard run alone, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu import square_loop as j_square_loop
from dcrmontecarlo_tpu.parallel import ShardedWoStSolver as JSharded
from dcrmontecarlo_tpu.parallel import make_mesh as j_make_mesh
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, make_mesh
from dcrmontecarlo_tpu_torch.solver import SolverOptions
from test_torch_parallel import LINEAR, SQUARE_PTS, _same_walks, _square
from test_torch_split import _bump_problems

torch.set_num_threads(1)

N = 4


def _pair(jprob, tprob, pts, n_walks, max_steps, eps, seed, **opts):
    from jax.experimental.pallas import tpu as pltpu

    js = JSharded(jprob, j_make_mesh(N), JOptions(backend="pallas", **opts))
    with pltpu.force_tpu_interpret_mode():
        want = js.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                        seed=seed)
    ts = ShardedWoStSolver(tprob, make_mesh(N, device="cpu"),
                           SolverOptions(**opts))
    got = ts.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                   seed=seed)
    return got, want, ts


@pytest.mark.parametrize("crn", [False, True])
def test_square_on_4_shards_matches_jax(crn):
    got, want, ts = _pair(
        JProblem(dirichlet=j_square_loop(1.0), bc_dirichlet=LINEAR),
        _square(), SQUARE_PTS, 256, 60, 1e-3, 0, target_slots=256,
        pallas_inner_steps=16, pallas_block_rows=4,
        common_random_numbers=crn)
    _same_walks(got, want)
    np.testing.assert_allclose(got.stderr, np.asarray(want.stderr),
                               rtol=1e-4)
    stats = ts.last_solve_stats
    assert len(stats["shard_launches"]) == N and stats["launches"] > 1


def test_bump_split_on_4_shards_matches_jax():
    import dcrmontecarlo_tpu.solver.split as jsplit_mod

    tprob, jprob = _bump_problems(lambda x, y: 1.0 + x * y)
    original, clones = jsplit_mod.make_launch_split, []

    def counting(*args):
        inner = original(*args)

        def split(state, pid, sid_base):
            out = inner(state, pid, sid_base)
            jax.debug.callback(lambda n: clones.append(int(n)), out[2])
            return out

        return split

    jsplit_mod.make_launch_split = counting
    try:
        got, want, ts = _pair(
            jprob, tprob, np.array([[0.0, 0.0], [0.4, 0.2]], np.float32),
            128, 150, 2e-2, 9, target_slots=512, pallas_inner_steps=16,
            pallas_block_rows=2, split_threshold=1.5)
    finally:
        jsplit_mod.make_launch_split = original
    _same_walks(got, want)
    stats = ts.last_solve_stats
    assert stats["clones"] == sum(clones) > 0
    assert min(stats["shard_clones"]) > 0  # every shard cloned


def test_fused_rows_equal_each_shard_alone():
    tprob, _ = _bump_problems(lambda x, y: 1.0 + x * y)
    ts = ShardedWoStSolver(tprob, make_mesh(N, device="cpu"), SolverOptions(
        target_slots=512, pallas_inner_steps=16, pallas_block_rows=2,
        split_threshold=1.5))
    plan = ts._plan(np.array([[0.0, 0.0], [0.4, 0.2]], np.float32), 128,
                    150, 2e-2, 9)
    fused = ts._run_shards(plan, range(N))
    alone = torch.cat([ts._run_shards(plan, [d]) for d in range(N)])
    assert torch.equal(fused, alone)
    assert bool((fused[:, -1] > 0).all())  # every shard cloned
