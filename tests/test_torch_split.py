"""The high-weight split, the in-launch freeze and the host launch loop of
the port against the JAX package.

* ``solver/split.py::make_launch_split`` on one numpy state with heavy and
  idle lanes over three points: equal integer planes, point ids and clone
  count, bit-equal float planes, and the banked destination sums to rel
  1e-6 (the two sum in another order).
* The freeze: one launch of the plain walk against the interpreted Pallas
  kernel built with ``freeze_split=True`` (the flagship notebook variant),
  at a threshold that leaves >= 1% of lanes frozen; a launch at
  ``thr = +inf`` equals a build without the freeze, bit for bit.
* ``max_attenuation``: one launch against the interpreted Pallas kernel,
  with a cap that clips >= 1% of lanes.
* Whole host-loop solves against the JAX package's Pallas host loop in
  interpret mode, at the size of ``tests/test_pallas_walk.py:524-550``
  (``square_loop(2.0)``, a ``bump_sum`` of one ``smooth_circle`` as the
  conductivity, 1024 lanes, 16-step launches): equal total steps and clone
  counts, means to ``1e-3 (|mean| + stderr)``; split-on against split-off
  within 4 combined sigma; the cross-point banking case
  (``test_pallas_walk.py:611-636``); the progress callback's calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.geometry import square_loop as j_square_loop
from dcrmontecarlo_tpu.models import notebook_survey as j_nb
from dcrmontecarlo_tpu.ops.pallas_walk import make_pallas_walk
from dcrmontecarlo_tpu.problems import Problem as JProblem
from dcrmontecarlo_tpu.problems import fields as jf
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu.solver.split import make_launch_split as j_split
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import square_loop
from dcrmontecarlo_tpu_torch.models import notebook_survey
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.split import make_launch_split
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_walk_kernel import OPTS, SEED, STEPS, _compare, numpy_planes

torch.set_num_threads(1)


def _split_state(rng, rows=4, n_src=2):
    """Planes with active, heavy and drained lanes, snap planes included."""
    n = rows * 128
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    quota = rng.integers(0, 3, n).astype(np.int32)
    quota[rng.random(n) < 0.3] = 0
    atten = f(-3.0, 3.0)
    atten[rng.random(n) < 0.2] *= 40.0
    planes = {"p0x": f(-1, 1), "p0y": f(-1, 1),
              "sid": np.arange(n, dtype=np.int32), "px": f(-1, 1),
              "py": f(-1, 1), "nx": f(-1, 1), "ny": f(-1, 1), "atten": atten,
              "quota": quota, "steps": rng.integers(0, 50, n, np.int32),
              "ndone": rng.integers(0, 5, n, np.int32),
              "ob": rng.integers(0, 2, n, np.int32),
              "life": rng.integers(0, 500, n, np.int32), "tn": f(0, 2),
              "tw": f(0, 2), "wmax": f(0, 9), "bmax": f(0, 9),
              "ob0": rng.integers(0, 2, n, np.int32), "n0x": f(-1, 1),
              "n0y": f(-1, 1)}
    for i in range(n_src):
        planes[f"acc{i}"] = f(-1, 1)
        planes[f"asum{i}"] = f(-5, 5)
        planes[f"asq{i}"] = f(0, 25)
    return {k: v.reshape(rows, 128) for k, v in planes.items()}


@pytest.mark.parametrize("threshold", [4.0, 1.0])
def test_launch_split_matches_jax(threshold):
    rng = np.random.default_rng(11)
    planes = _split_state(rng)
    pid = rng.integers(0, 3, 512).astype(np.int32)
    js, jpid, jn, jdsum, jdsq = j_split(threshold, 2, 3)(
        {k: jnp.asarray(v) for k, v in planes.items()}, jnp.asarray(pid),
        np.int32(1 << 30))
    state = interop.state_from_numpy(planes)
    tpid = torch.from_numpy(pid.astype(np.int64))
    n, dsum, dsq = make_launch_split(threshold, 2, 3)(state, tpid, 1 << 30)
    heavy = ((planes["quota"] > 0) & (np.abs(planes["atten"]) > threshold))
    assert n == int(jn) == min(heavy.sum(), (planes["quota"] <= 0).sum()) > 0
    got = interop.state_to_numpy(state)
    for k, v in js.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tpid.numpy(), np.asarray(jpid))
    np.testing.assert_allclose(dsum.numpy(), np.asarray(jdsum), rtol=1e-6)
    np.testing.assert_allclose(dsq.numpy(), np.asarray(jdsq), rtol=1e-6)
    assert (np.asarray(jdsum) != 0).all()
    # fresh stream ids above every lane id, in pairing order
    new = got["sid"] != planes["sid"]
    assert new.sum() == n and (got["sid"][new] >= 1 << 30).all()


@pytest.fixture(scope="module")
def flagship():
    """The flagship notebook problem on both sides (the port walks the JAX
    package's majorant and mixture) and 1024 planes after 48 steps."""
    from jax.experimental.pallas import tpu as pltpu

    js, je = j_nb()
    js.local_majorant = "auto"
    js.source_mis = True
    jprob = js.build_problem()
    ts, _ = notebook_survey()
    ts.source_mis = True
    ts.local_majorant = interop.local_majorant_from(jprob.local_majorant)
    tprob = ts.build_problem()
    tprob.set_source_importance(
        interop.gaussian_mixture_from(jprob.source_importance))
    jsolver = JSolver(jprob, JOptions(robin_correction="chain", **OPTS))
    planes = numpy_planes(jsolver, np.asarray(je, np.float32), 1024, 1.0)
    common = dict(eps=1.0, max_steps=6000, t_min=1e-5 * jprob.diameter,
                  rmin=0.5, project=True, rejection_rounds=2,
                  roulette_threshold=0.05)
    plan = make_pallas_walk(jprob, n_inner=48, block_rows=8,
                            snap_starts=True, robin_correction="chain",
                            robin_arrival_clamp=0.02, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED))
    return tprob, jprob, {k: np.asarray(v) for k, v in out.items()}, common


def _pallas_launch(jprob, planes, common, thr=None, **kw):
    from jax.experimental.pallas import tpu as pltpu

    plan = make_pallas_walk(jprob, n_inner=STEPS, block_rows=8,
                            snap_starts=True, robin_correction="chain",
                            robin_arrival_clamp=0.02, **common, **kw)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), freeze_thr=thr)
    return {k: np.asarray(v) for k, v in out.items()}


FREEZE_THR = 1.05


def test_freeze_one_launch_matches_pallas(flagship):
    tprob, jprob, planes, common = flagship
    want = _pallas_launch(jprob, planes, common, thr=np.float32(FREEZE_THR),
                          freeze_split=True)
    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 robin_correction="chain", freeze_split=True,
                                 **common)
    assert params.variant == (wk.ROBIN_CHAIN, True, True, True, False, True,
                              False, False, False)
    assert params.variant in wk.KERNEL_VARIANTS
    got = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), params, STEPS,
        freeze_thr=FREEZE_THR))
    _compare(got, want, state_planes(1))
    frozen = (got["quota"] > 0) & (np.abs(got["atten"]) > FREEZE_THR)
    assert frozen.mean() >= 0.01, frozen.mean()
    # a frozen lane is a fixed point: frozen at the start and with no walk
    # to bank, it stays put
    stay = ((planes["quota"] > 0) & (np.abs(planes["atten"]) > FREEZE_THR)
            & (got["ndone"] == planes["ndone"]))
    assert stay.any()
    for k in ("px", "py", "atten", "life", "steps"):
        np.testing.assert_array_equal(got[k][stay], planes[k][stay])
    # at +inf the freeze build equals the build without it, bit for bit
    inf = wk.run_walk(interop.state_from_numpy(planes), params, STEPS,
                      freeze_thr=float("inf"))
    none = wk.run_walk(interop.state_from_numpy(planes), wk.make_walk_params(
        tprob, snap=True, seed=stream_seed(SEED), robin_correction="chain",
        **common), STEPS)
    for k in state_planes(1):
        assert torch.equal(inf[k], none[k]), k
    assert (np.abs(got["atten"]) != inf["atten"].numpy()).mean() >= 0.01
    with pytest.raises(ValueError, match="freeze build"):
        wk.run_walk(interop.state_from_numpy(planes), wk.make_walk_params(
            tprob, snap=True, seed=stream_seed(SEED),
            robin_correction="chain", **common), STEPS, freeze_thr=4.0)


def test_max_attenuation_matches_pallas(flagship):
    tprob, jprob, planes, common = flagship
    cap = 1.1
    want = _pallas_launch(jprob, planes, common, max_attenuation=cap)
    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 robin_correction="chain",
                                 max_attenuation=cap, **common)
    got = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), params, STEPS))
    _compare(got, want, state_planes(1))
    free = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), wk.make_walk_params(
            tprob, snap=True, seed=stream_seed(SEED),
            robin_correction="chain", **common), STEPS))
    clipped = (got["quota"] > 0) & (np.abs(got["atten"]) == np.float32(cap))
    assert clipped.mean() >= 0.01, clipped.mean()
    assert (np.abs(free["atten"]) > cap).mean() >= 0.01
    assert np.abs(got["atten"]).max() <= np.float32(cap)


# ---- whole host-loop solves ---------------------------------------------

AMP, SHARP = 3.0, 4.0   # the bump: alpha = 1 + AMP * smooth_circle


def _bump_problems(bc, amp=AMP, sharpness=SHARP):
    """``alpha = 1 + amp * smooth_circle((0, 0), 0.4, sharpness)`` on both
    sides, with the JAX package's sigma_bar on both (so the walks are the
    same); ``bc`` works on arrays of either package."""
    circle = jf.smooth_circle((0.0, 0.0), 0.4, sharpness)
    j_alpha = lambda x, y: 1.0 + amp * circle(x, y)
    sbar = JProblem(dirichlet=j_square_loop(2.0), alpha=j_alpha).sigma_bar
    jprob = JProblem(dirichlet=j_square_loop(2.0), bc_dirichlet=bc,
                     alpha=j_alpha, sigma_bar_override=sbar)
    tprob = Problem(dirichlet=square_loop(2.0), bc_dirichlet=bc,
                    alpha=fields.bump_sum(1.0, [(amp, fields.smooth_circle(
                        (0.0, 0.0), 0.4, sharpness))]),
                    sigma_bar_override=sbar)
    assert tprob.sigma_bar == jprob.sigma_bar
    return tprob, jprob


def _host_loop_pair(tprob, jprob, pts, n_walks, max_steps, seed, thr,
                    n_inner=16, eps=2e-2, target_slots=512, block_rows=8,
                    **extra):
    """The same solve through the JAX package's Pallas host loop (in
    interpret mode) and the port's, each with a progress recorder; the
    JAX side's clone count is read from its split at run time."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    import dcrmontecarlo_tpu.solver.split as jsplit_mod

    kw = dict(target_slots=target_slots, pallas_inner_steps=n_inner,
              pallas_block_rows=block_rows, split_threshold=thr, **extra)
    j_calls, t_calls, j_clones = [], [], []

    def counting_split(*args):
        inner = j_split(*args)

        def split(state, pid, sid_base):
            out = inner(state, pid, sid_base)
            jax.debug.callback(lambda n: j_clones.append(int(n)), out[2])
            return out

        return split

    js = JSolver(jprob, JOptions(backend="pallas", **kw))
    original = jsplit_mod.make_launch_split
    jsplit_mod.make_launch_split = counting_split
    try:
        with pltpu.force_tpu_interpret_mode():
            want = js.solve(pts, n_walks=n_walks, max_steps=max_steps,
                            eps=eps, seed=seed,
                            progress=lambda *a: j_calls.append(a))
    finally:
        jsplit_mod.make_launch_split = original
    ts = WoStSolver(tprob, SolverOptions(**kw), device="cpu")
    got = ts.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                   seed=seed, progress=lambda *a: t_calls.append(a))
    return dict(got=got, want=want, stats=ts.last_solve_stats,
                j_clones=sum(j_clones), t_calls=t_calls, j_calls=j_calls)


SPLIT_PTS = np.array([[0.0, 0.0], [0.4, 0.2]], np.float32)


@pytest.fixture(scope="module")
def split_solves():
    tprob, jprob = _bump_problems(lambda x, y: 1.0 + x * y)
    return {thr: _host_loop_pair(tprob, jprob, SPLIT_PTS, 96, 200, 9, thr)
            for thr in (None, 1.5)}


@pytest.mark.parametrize("thr", [None, 1.5])
def test_host_loop_solve_matches_pallas(split_solves, thr):
    r = split_solves[thr]
    got, want = r["got"], r["want"]
    assert got.total_steps == want.total_steps
    assert r["stats"]["clones"] == r["j_clones"]
    assert (r["j_clones"] > 0) == (thr is not None)
    se = np.sqrt(got.stderr ** 2 + np.asarray(want.stderr) ** 2)
    dm = np.abs(got.mean - np.asarray(want.mean))
    assert (dm <= 1e-3 * (np.abs(np.asarray(want.mean)) + se)).all(), (
        got.mean, want.mean)
    assert r["stats"]["launches"] > 1


def test_progress_calls_match_jax(split_solves):
    for r in split_solves.values():
        assert r["t_calls"] == r["j_calls"] and len(r["t_calls"]) > 1
        done, total, it = r["t_calls"][-1]
        assert done == total == 2 * 96 and it == 16 * len(r["t_calls"])


def test_split_on_agrees_with_split_off(split_solves):
    a, b = split_solves[None]["got"], split_solves[1.5]["got"]
    comb = np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    dev = np.abs(a.mean - b.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps  # the clones walked


def test_split_banks_destination_stats_across_points():
    # the port's test_pallas_walk.py::test_split_banks_destination_stats_
    # across_points: the split pairs lanes globally, so a drained point-A
    # lane hosts a point-B clone; its banked sums must stay with A. With
    # strongly contrasting means the transfer would show: split-on agrees
    # with split-off per point, and with the JAX package's host loop
    tprob, jprob = _bump_problems(lambda x, y: 10.0 * x)
    pts = np.array([[-1.2, 0.0], [1.2, 0.0], [0.0, 0.1]], np.float32)
    runs = {thr: _host_loop_pair(tprob, jprob, pts, 128, 150, 3, thr,
                                 n_inner=8, min_quota=2)
            for thr in (None, 1.2)}
    a, b = runs[None]["got"], runs[1.2]["got"]
    comb = np.sqrt(a.stderr ** 2 + b.stderr ** 2)
    dev = np.abs(a.mean - b.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps  # the clones walked
    r = runs[1.2]
    assert r["got"].total_steps == r["want"].total_steps
    assert r["stats"]["clones"] == r["j_clones"] > 0
    np.testing.assert_allclose(r["got"].mean, np.asarray(r["want"].mean),
                               rtol=1e-4, atol=1e-4)
