"""The sharded solve of the PyTorch port against the JAX package.

* ``sampling/rng.py::shard_seed`` is ``jax.random.fold_in`` of the solve's
  key with the global shard index, then the JAX shard body's seed
  expression (``parallel/mesh.py:492-496``), bit for bit on 1,000 seeded
  ``(seed, d)`` pairs; ``threefry_2x32`` is the folded key's two words.
* A shard's planes are the JAX shard body's (``mesh.py:479-535``):
  slot-major start points, quotas, stream ids with and without common
  random numbers, snap planes and point ids, and the slot layout.
* Walk for walk against ``ShardedWoStSolver(backend="pallas")`` in
  interpret mode on the conftest's virtual CPU devices (``make_mesh(2)``):
  the square of ``tests/test_pallas_walk.py:278-297`` (with and without
  CRN) and the bump-alpha split of ``:327-355`` at 128 walks (split off,
  and on at 1.5: the launch loop with the split and no freeze, shard 1's
  clone range negative as an int32) give EQUAL total steps and clone
  counts, and sums to rel 1e-5 (float32 sums of identical walks in
  another order: the port combines the shards in float64 and rounds once,
  JAX psums in float32; measured ~4e-7). ``compaction="pack"`` against
  unpacked (``:300-324``): equal steps, sums to 1e-5.
* The options the sharded path refuses, and its kernel instantiation on
  the flagship configuration. The physics of ``tests/test_parallel.py`` is
  ``test_torch_parallel_physics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu import square_loop as j_square_loop
from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.ops.pallas_walk import stream_ids as j_stream_ids
from dcrmontecarlo_tpu.parallel import ShardedWoStSolver as JSharded
from dcrmontecarlo_tpu.parallel import make_mesh as j_make_mesh
from dcrmontecarlo_tpu.sampling.rng import mix32 as j_mix32
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
    initialize_distributed, make_mesh
from dcrmontecarlo_tpu_torch.problems import Problem
from dcrmontecarlo_tpu_torch.sampling.rng import shard_seed, threefry_2x32
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_split import _bump_problems

torch.set_num_threads(1)

LINEAR = lambda x, y: x + 2.0 * y
SQUARE_PTS = np.array([[0.0, 0.0], [0.5, 0.3]])


def _mesh(n):
    return make_mesh(n, device="cpu")


def _square(bc=LINEAR, side=1.0, **kw):
    return Problem(dirichlet=square_loop(side), bc_dirichlet=bc, **kw)


# ---- seeds, layout ----------------------------------------------------

def test_shard_seed_matches_jax_fold_in():
    rng = np.random.default_rng(8)
    seeds = rng.integers(0, 2**31, 1000)
    seeds[:3] = (0, 1, 2**31 - 1)
    ds = rng.integers(0, 256, 1000)
    ds[:3] = (0, 255, 255)

    def jax_seed(seed, d):
        kd = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        return kd, jax.lax.bitcast_convert_type(kd[0] ^ j_mix32(kd[-1]),
                                                jnp.int32)

    keys, want = jax.vmap(jax_seed)(jnp.asarray(seeds, jnp.uint32),
                                    jnp.asarray(ds, jnp.uint32))
    k0, k1 = threefry_2x32((0, seeds), 0, ds)
    np.testing.assert_array_equal(k0, np.asarray(keys)[:, 0])
    np.testing.assert_array_equal(k1, np.asarray(keys)[:, 1])
    got = [shard_seed(int(s), int(d)) for s, d in zip(seeds, ds)]
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(got)) == 1000


@pytest.mark.parametrize("n_dev,n_points,n_walks,target,thr", [
    (2, 2, 256, 256, None), (4, 3, 1000, 4096, 1.5), (8, 9, 64, 512, 4.0),
    (3, 5, 100, 64, None)])
def test_slot_layout_matches_jax(n_dev, n_points, n_walks, target, thr):
    opts = dict(target_slots=target, split_threshold=thr)
    j = JSharded(JProblem(dirichlet=j_square_loop(1.0),
                          bc_dirichlet=LINEAR), j_make_mesh(n_dev),
                 JOptions(**opts))
    t = ShardedWoStSolver(_square(), _mesh(n_dev), SolverOptions(**opts))
    (jk, jq), (tk, tq) = (s._slot_layout(n_points, n_walks) for s in (j, t))
    assert jk == tk and jk % n_dev == 0
    np.testing.assert_array_equal(jq, tq)


def _neumann_box():
    """A box with a Neumann top, so near-wall points snap onto it."""
    corners = [[-5.0, 0.0], [-5.0, -10.0], [5.0, -10.0], [5.0, 0.0]]
    top = [[-5.0, 0.0], [5.0, 0.0]]
    alpha = lambda x, y: 1.0 + 0.0 * x
    j = JProblem(dirichlet=JPolyline.from_points(corners),
                 neumann=JPolyline.from_points(top), bc_dirichlet=LINEAR,
                 alpha=alpha)
    t = Problem(dirichlet=Polyline.from_points(corners),
                neumann=Polyline.from_points(top), bc_dirichlet=LINEAR,
                alpha=alpha)
    return j, t


@pytest.mark.parametrize("crn", [False, True])
def test_shard_planes_match_jax_shard_body(crn):
    # the JAX shard body's arrays (mesh.py:479-535), formed as it forms
    # them: tile over the shard's slots, zero padding, its stream ids
    jprob, tprob = _neumann_box()
    pts = np.array([[-3.0, -0.008], [3.0, -0.004], [0.0, -5.0]], np.float32)
    n_dev, n_walks, eps = 4, 96, 0.02
    opts = dict(target_slots=512, pallas_block_rows=2,
                common_random_numbers=crn)
    js = JSharded(jprob, j_make_mesh(n_dev), JOptions(**opts))
    ts = ShardedWoStSolver(tprob, _mesh(n_dev), SolverOptions(**opts))
    K, quota_row = js._slot_layout(3, n_walks)
    k_local = K // n_dev
    w_local = 3 * k_local
    rows_local = max(2, -(-w_local // 256) * 2)
    w_pad = rows_local * 128
    tol = js._boundary_snap_tol(eps)
    snapped = [np.asarray(v) for v in js._snap_points(jnp.asarray(pts), tol)]
    assert snapped[2].any()  # two points start on the wall

    def tile1(a, dt):
        return np.concatenate([np.tile(a.astype(dt), k_local),
                               np.zeros(w_pad - w_local, dt)]
                              ).reshape(rows_local, 128)

    plan = ts._plan(pts, n_walks, 100, eps, seed=3)
    assert plan.rows == rows_local and plan.k_local == k_local
    sid = np.asarray(j_stream_ids(rows_local,
                                  ("repeat", K, 3) if crn else None))
    quotas_km = np.tile(quota_row[:, None], (1, 3)).astype(np.int32)
    for d in range(n_dev):
        shard = ts._shard(plan, d)
        got = {k: v.numpy() for k, v in shard.state.items()}
        want = {"p0x": tile1(snapped[0], np.float32),
                "p0y": tile1(snapped[1], np.float32), "sid": sid,
                "quota": np.concatenate([
                    quotas_km[d * k_local:(d + 1) * k_local].reshape(-1),
                    np.zeros(w_pad - w_local, np.int32)]
                ).reshape(rows_local, 128),
                "ob0": tile1(snapped[2], np.int32),
                "n0x": tile1(snapped[3], np.float32),
                "n0y": tile1(snapped[4], np.float32)}
        want.update(px=want["p0x"], py=want["p0y"], ob=want["ob0"],
                    nx=want["n0x"], ny=want["n0y"])
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        pid = np.zeros(w_pad, np.int64)
        pid[:w_local] = np.tile(np.arange(3), k_local)
        np.testing.assert_array_equal(shard.pid.numpy(), pid)
        assert shard.params.seed == shard_seed(3, d)
        assert shard.params.freeze is False


def test_clone_ranges_wrap_to_the_jax_bit_pattern():
    ts = ShardedWoStSolver(_square(alpha=lambda x, y: 1.0 + x * x),
                           _mesh(4), SolverOptions(target_slots=64,
                                                   split_threshold=1.5))
    plan = ts._plan(SQUARE_PTS, 64, 50, 0.02, seed=0)
    bases = [ts._shard(plan, d).nsid for d in range(4)]
    stride = (2**32 - 2**30) // 4
    want = [np.array(2**30 + d * stride, np.uint32).view(np.int32)
            for d in range(4)]
    assert bases == [int(v) for v in want]
    assert bases[2] < 0 and bases[3] < 0


# ---- walk for walk against the JAX package's sharded Pallas path -------

def _pair(jprob, tprob, pts, n_walks, max_steps, eps, seed, **opts):
    from jax.experimental.pallas import tpu as pltpu

    js = JSharded(jprob, j_make_mesh(2), JOptions(backend="pallas", **opts))
    with pltpu.force_tpu_interpret_mode():
        want = js.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                        seed=seed)
    ts = ShardedWoStSolver(tprob, _mesh(2), SolverOptions(**opts))
    got = ts.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                   seed=seed)
    return got, want, ts.last_solve_stats


def _same_walks(got, want):
    assert got.total_steps == want.total_steps
    for k in ("walk_sum", "walk_sumsq"):
        np.testing.assert_allclose(getattr(got, k),
                                   np.asarray(getattr(want, k)), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("crn", [False, True])
def test_square_matches_jax_sharded_pallas(crn):
    got, want, stats = _pair(
        JProblem(dirichlet=j_square_loop(1.0), bc_dirichlet=LINEAR),
        _square(), SQUARE_PTS, 256, 60, 1e-3, 0, target_slots=256,
        pallas_inner_steps=16, pallas_block_rows=8,
        common_random_numbers=crn)
    _same_walks(got, want)
    exact = SQUARE_PTS[:, 0] + 2 * SQUARE_PTS[:, 1]
    assert (np.abs(got.mean - exact) < 4 * got.stderr + 5e-3).all()
    assert stats["launches"] > 1 and len(stats["shard_launches"]) == 2


@pytest.fixture(scope="module")
def bump_split():
    import dcrmontecarlo_tpu.solver.split as jsplit_mod

    tprob, jprob = _bump_problems(lambda x, y: 1.0 + x * y)
    original = jsplit_mod.make_launch_split
    runs = {}
    for thr in (None, 1.5):
        clones = []

        def counting(*args):
            inner = original(*args)

            def split(state, pid, sid_base):
                out = inner(state, pid, sid_base)
                jax.debug.callback(lambda n: clones.append(int(n)), out[2])
                return out

            return split

        jsplit_mod.make_launch_split = counting
        try:
            got, want, stats = _pair(
                jprob, tprob, np.array([[0.0, 0.0], [0.4, 0.2]], np.float32),
                128, 150, 2e-2, 9, target_slots=512, pallas_inner_steps=16,
                pallas_block_rows=8, split_threshold=thr)
        finally:
            jsplit_mod.make_launch_split = original
        runs[thr] = (got, want, stats, sum(clones))
    return runs


@pytest.mark.parametrize("thr", [None, 1.5])
def test_bump_split_matches_jax_sharded_pallas(bump_split, thr):
    got, want, stats, j_clones = bump_split[thr]
    _same_walks(got, want)
    assert stats["clones"] == j_clones
    assert (j_clones > 0) == (thr is not None)
    if thr is not None:
        # both shards cloned, shard 1 from its negative int32 range
        assert min(stats["shard_clones"]) > 0
    se = np.sqrt(got.stderr ** 2 + np.asarray(want.stderr) ** 2)
    assert (np.abs(got.mean - np.asarray(want.mean)) < 4 * se).all()


def test_split_on_agrees_with_split_off(bump_split):
    a, b = bump_split[None][0], bump_split[1.5][0]
    comb = np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    dev = np.abs(a.mean - b.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps  # the clones walked


def test_compaction_pack_matches_unpacked():
    res = {}
    for comp in (False, "pack"):
        s = ShardedWoStSolver(_square(), _mesh(2), SolverOptions(
            target_slots=256, pallas_inner_steps=8, pallas_block_rows=8,
            compaction=comp))
        res[comp] = s.solve(SQUARE_PTS, n_walks=256, max_steps=60, eps=1e-3,
                            seed=0)
    a, b = res[False], res["pack"]
    assert a.total_steps == b.total_steps  # identical walks, re-ordered
    np.testing.assert_allclose(a.walk_sum, b.walk_sum, rtol=1e-5)
    np.testing.assert_allclose(a.walk_sumsq, b.walk_sumsq, rtol=1e-5)
    # the single-device solver still refuses it
    with pytest.raises(NotImplementedError, match="pack"):
        WoStSolver(_square(), SolverOptions(compaction="pack"),
                   device="cpu").solve(SQUARE_PTS, n_walks=8, max_steps=10)


# ---- what the sharded path refuses --------------------------------------

def test_xla_backend_raises():
    s = ShardedWoStSolver(_square(), _mesh(2), SolverOptions(backend="xla"))
    with pytest.raises(NotImplementedError,
                       match="_build_solve_fn_xla_sharded"):
        s.solve(SQUARE_PTS, n_walks=8, max_steps=10)


def test_inert_split_warns():
    s = ShardedWoStSolver(_square(), _mesh(2), SolverOptions(
        target_slots=64, split_threshold=1.5))
    with pytest.warns(UserWarning, match="inert"):
        s.solve(SQUARE_PTS, n_walks=16, max_steps=20, eps=1e-2)
    assert s.last_solve_stats["clones"] == 0


def test_mesh_entry_points_default_to_the_card():
    import inspect

    for fn in (make_mesh, initialize_distributed):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert not torch.cuda.is_available()
    for attempt in (make_mesh, lambda: make_mesh(4),
                    lambda: initialize_distributed("127.0.0.1:1", 1, 0)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            attempt()
    assert not torch.distributed.is_initialized()
    assert make_mesh(device="cpu").devices.size == 1
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_kernel_variant_of_the_sharded_flagship():
    # the flagship configuration on a mesh splits without the freeze: the
    # instantiation chain + majorant + MIS without freeze
    from dcrmontecarlo_tpu_torch.models import notebook_survey
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    survey, _ = notebook_survey()
    survey.local_majorant = "auto"
    survey.source_mis = True
    opts = survey_default_options(target_slots=1 << 12, split_threshold=4.0)
    prob = survey.build_problem()
    sharded = ShardedWoStSolver(prob, _mesh(2), opts)
    single = WoStSolver(prob, opts, device="cpu")
    p_mesh = sharded._walk_params(1.0, 100, 0, True)
    p_one = single._walk_params(1.0, 100, 0, True)
    assert p_mesh.variant == (wk.ROBIN_CHAIN, True, True, False, False, True,
                              False, False, False)
    assert p_mesh.variant in wk.KERNEL_VARIANTS
    assert p_one.variant == p_mesh.variant[:3] + (True,) + p_mesh.variant[4:]
