"""The fused walk of the PyTorch port against the JAX package's Pallas kernel.

One numpy-built set of walker planes, made the way the JAX solver's
adaptive single-launch path makes them (``solver/wost.py:1824-1871``),
goes through the interpreted Pallas kernel (``make_pallas_walk(...).run``)
and through the port's plain walk (``interop.state_from_numpy``) for 32
steps on the geophysical survey with common random numbers, roulette and
boundary-snap starts (the accuracy path's cases are in
``test_torch_walk_accuracy.py``). Each plane must agree on >= 99% of the
lanes to rel 1e-4 (integers exactly; ``walk_kernel.compare_planes`` states
the floor under tiny accumulator values): rare one-ulp differences of the
two math libraries may flip a trajectory. The CUDA kernel itself is
compared with the plain walk by ``test_torch_cuda.py``, which runs on the
card only.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu.models import geophysical_scenario as j_geo
from dcrmontecarlo_tpu.ops.pallas_walk import make_pallas_walk
from dcrmontecarlo_tpu.ops.pallas_walk import stream_ids as j_stream_ids
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import LocalMajorant, Problem, fields
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes

torch.set_num_threads(1)

EPS, SEED, STEPS = 0.9, 7, 32
# the survey electrodes (snapped onto the surface) plus points near the
# grounded sides and bottom, whose walks end within the 32 steps
POINTS = np.concatenate([
    np.stack([np.linspace(-40, 40, 9), np.full(9, -0.1)], 1),
    [[-99.5, -20.0], [98.7, -60.0], [0.0, -199.3], [-97.0, -150.0],
     [60.0, -197.5], [99.2, -5.0], [-30.0, -196.0]],
]).astype(np.float32)
OPTS = dict(target_slots=1024, pallas_block_rows=8, common_random_numbers=True,
            roulette_threshold=0.05)
N_WALKS = 256  # 64 slots per point, quota 4


def numpy_planes(jsolver, points, n_walks, eps):
    """Walker planes as the JAX solver's single-launch init makes them
    (with common random numbers), the snap planes only where the problem
    has a Neumann wall to snap onto."""
    n_points = len(points)
    K, quota_row = jsolver._slot_layout(n_points, n_walks)
    block_rows = jsolver.options.pallas_block_rows
    W = n_points * K
    rows = max(block_rows, -(-W // (block_rows * 128)) * block_rows)
    W_pad = rows * 128
    crn = ("tile", K, n_points)
    tol = jsolver._boundary_snap_tol(eps)
    ptx, pty, ob0, n0x, n0y = (np.asarray(v) for v in jsolver._snap_points(
        jnp.asarray(points), tol))

    def pad(v, dt):
        out = np.zeros(W_pad, dt)
        out[:W] = np.repeat(np.asarray(v).astype(dt), K)
        return out.reshape(rows, 128)

    f0 = np.zeros((rows, 128), np.float32)
    quotas = np.zeros(W_pad, np.int32)
    quotas[:W] = np.tile(quota_row, n_points)
    planes = {
        "p0x": pad(ptx, np.float32), "p0y": pad(pty, np.float32),
        "sid": np.asarray(j_stream_ids(rows, crn)),
        "px": pad(ptx, np.float32), "py": pad(pty, np.float32),
        "atten": f0 + 1.0, "quota": quotas.reshape(rows, 128),
        "ob": np.zeros((rows, 128), np.int32), "nx": f0.copy(),
        "ny": f0.copy(),
    }
    if tol is not None:
        planes.update(ob0=pad(ob0, np.int32), n0x=pad(n0x, np.float32),
                      n0y=pad(n0y, np.float32))
        planes.update(ob=planes["ob0"].copy(), nx=planes["n0x"].copy(),
                      ny=planes["n0y"].copy())
    for k in ("steps", "ndone", "life"):
        planes[k] = np.zeros((rows, 128), np.int32)
    for k in ("tn", "tw", "wmax", "bmax"):
        planes[k] = f0.copy()
    for i in range(max(1, len(jsolver.problem.source_fields))):
        for k in ("acc", "asum", "asq"):
            planes[f"{k}{i}"] = f0.copy()
    return planes


@pytest.fixture(scope="module")
def survey():
    tsurvey, _ = geophysical_scenario()
    jsurvey, _ = j_geo()
    return tsurvey.build_problem(), jsurvey.build_problem()


def _compare(got, want, names):
    """The walk parity rule of ``walk_kernel.compare_planes``: every plane
    agrees on >= 99% of the lanes (floats to rel 1e-4 above its floor)."""
    frac, _, finite = wk.compare_planes(
        {k: torch.tensor(v) for k, v in got.items()},
        {k: torch.tensor(v) for k, v in want.items()}, names)
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


@pytest.mark.parametrize("rounds,max_steps", [(2, 12), (1, 12), (64, 500)])
def test_plain_walk_matches_pallas_kernel(survey, rounds, max_steps):
    from jax.experimental.pallas import tpu as pltpu

    tprob, jprob = survey
    jsolver = JSolver(jprob, JOptions(rejection_rounds=rounds, **OPTS))
    planes = numpy_planes(jsolver, POINTS, N_WALKS, EPS)
    assert planes["px"].size == 1024 and planes["ob0"].any()
    common = dict(eps=EPS, max_steps=max_steps, t_min=1e-5 * jprob.diameter,
                  rmin=0.5 * EPS, project=True, rejection_rounds=rounds,
                  roulette_threshold=0.05)
    plan = make_pallas_walk(jprob, n_inner=STEPS, block_rows=8,
                            snap_starts=True, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=STEPS)
    want = {k: np.asarray(v) for k, v in out.items()}

    params = wk.make_walk_params(tprob, snap=True, seed=stream_seed(SEED),
                                 **common)
    state = interop.state_from_numpy(planes)
    launches = wk.run_walk.launches
    got = interop.state_to_numpy(wk.run_walk(state, params, STEPS))
    assert wk.run_walk.launches == launches  # CPU tensors: the plain walk
    _compare(got, want, state_planes(1))
    # the 32 steps exercised banking, recycling and the walk itself
    assert (want["ndone"] > 0).any() and (want["life"] > 0).any()
    assert (want["asum0"] != 0).any()


def test_solver_init_matches_numpy_planes(survey):
    tprob, jprob = survey
    jsolver = JSolver(jprob, JOptions(rejection_rounds=2, **OPTS))
    planes = numpy_planes(jsolver, POINTS, N_WALKS, EPS)
    tsolver = WoStSolver(tprob, SolverOptions(rejection_rounds=2, **OPTS),
                         device="cpu")
    state, params, pid, bound = tsolver._setup(POINTS, N_WALKS, 500, EPS,
                                               SEED)
    got = interop.state_to_numpy(state)
    assert set(got) == set(planes)
    for k, v in planes.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert params.seed == stream_seed(SEED) and bound == 4 * 501 + 2
    assert pid.shape == (1024,) and int(pid.max()) == len(POINTS) - 1


def test_compare_planes_rule():
    base = {"px": torch.tensor([100.0, -50.0, 1e-3, 2e-40]),
            "steps": torch.tensor([3, 4, 5, 6], dtype=torch.int32)}
    other = {"px": torch.tensor([100.005, -50.0, 1e-3 + 5e-5, 0.0]),
             "steps": torch.tensor([3, 4, 5, 7], dtype=torch.int32)}
    frac, max_err, finite = wk.compare_planes(other, base, ["px", "steps"])
    # rel 1e-4 at 100 allows 0.01; the floor (1e-6 x 100) covers 5e-5 on
    # the tiny value; subnormals flush to zero; integers must be equal
    assert frac == {"px": 1.0, "steps": 0.75} and finite
    assert max_err == pytest.approx(5e-3, rel=1e-2)
    other["px"][0] = 100.02
    other["px"][1] = float("nan")
    frac, _, finite = wk.compare_planes(other, base, ["px"])
    assert frac["px"] == 0.5 and not finite


@pytest.mark.parametrize("crn", [None, ("tile", 113, 9), ("slot", 9, 113)])
def test_stream_ids_match_jax(crn):
    np.testing.assert_array_equal(wk.stream_ids(8, crn).numpy(),
                                  np.asarray(j_stream_ids(8, crn)))


def test_segment_tables_match_kernel_constants(survey):
    tprob, _ = survey
    d = wk._dir_table(tprob.dirichlet)
    n = wk._neu_table(tprob.neumann)
    assert d.shape == (3, 5) and n.shape == (1, 6)
    # the Neumann surface runs along +x: its CCW normal is +y
    np.testing.assert_array_equal(n[0], [-100.0, 0.0, 200.0, 0.0, -0.0, 1.0])
    np.testing.assert_array_equal(d[:, 4], d[:, 2] ** 2 + d[:, 3] ** 2)


def test_wrapper_dispatch(survey):
    tprob, _ = survey
    solver = WoStSolver(tprob, SolverOptions(**OPTS), device="cpu")
    state, params, _, _ = solver._setup(POINTS, N_WALKS, 500, EPS, SEED)
    ref = {k: v.clone() for k, v in state.items()}
    launches = wk.run_walk.launches
    wk.run_walk(state, params, 16)
    wk.walk_plain(ref, params, 16)
    assert wk.run_walk.launches == launches
    for k in state:
        assert torch.equal(state[k], ref[k]), k
    # neither CPU nor CUDA: the wrapper raises instead of falling back
    meta = {k: torch.empty_like(v, device="meta") for k, v in state.items()}
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        wk.run_walk(meta, params, 16)
    assert wk.run_walk.launches == launches


def test_fixed_launches_equal_one_adaptive_launch(survey):
    # walks depend on (stream, walk#, step#) only, so cutting the solve
    # into 64-step launches changes nothing
    tprob, _ = survey
    pts = POINTS[[4, 9, 11, 13]]
    out = [WoStSolver(tprob, SolverOptions(
        adaptive_launches=adaptive, pallas_inner_steps=64, **OPTS),
        device="cpu")._solve_raw(pts, 16, 100, EPS, SEED)
        for adaptive in (True, False)]
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_kernel_params_need_field_specs(survey):
    tprob, _ = survey
    p = Problem(dirichlet=tprob.dirichlet, neumann=tprob.neumann,
                alpha=lambda x, y: 1.0 + 0.0 * x, source=tprob.source,
                sigma_bar_override=0.1)
    params = wk.make_walk_params(p, eps=EPS, max_steps=10, t_min=1e-3,
                                 rmin=0.45, project=True, rejection_rounds=2,
                                 roulette_threshold=None, snap=False, seed=1)
    with pytest.raises(NotImplementedError, match="field specs"):
        params.pack()
    fp, ip = wk.make_walk_params(
        tprob, eps=EPS, max_steps=10, t_min=1e-3, rmin=0.45, project=True,
        rejection_rounds=2, roulette_threshold=0.05, snap=True,
        seed=-5).pack()
    assert fp.dtype == np.float32 and ip.dtype == np.int32
    assert ip[0] == -5 and len(ip) == 21 + 2 * 4


def _over_table_budget():
    # a heightmap wall of 4,200 segments and 4,199 vertices: 8,402 rows,
    # more than the table form's 8,192 (the JAX package walks it on XLA)
    tprob = geophysical_scenario()[0].build_problem()
    x = np.linspace(-100.0, 100.0, 4201)
    wall = Polyline.from_points(np.stack([x, 0.1 * np.sin(x)], 1))
    return Problem(dirichlet=tprob.dirichlet, neumann=wall,
                   alpha=tprob.alpha, source=tprob.source,
                   sigma_bar_override=0.1)


def _survey_solver(**opts):
    return geophysical_scenario()[0].make_solver(SolverOptions(**opts),
                                                 device="cpu")


def _kernel_params(problem, **kw):
    return wk.make_walk_params(problem, eps=EPS, max_steps=10, t_min=1e-3,
                               rmin=0.45, project=True, rejection_rounds=2,
                               roulette_threshold=None, snap=False, seed=1,
                               **kw)


def _mis_over_kernel_table():
    tprob = geophysical_scenario()[0].build_problem()
    tprob.set_source_importance(fields.GaussianMixture.from_components(
        [((float(i), -1.0), 0.5, 1.0) for i in range(9)]))
    _kernel_params(tprob).pack()


def _kernel_variant_not_compiled():
    # reflectance with MIS: no path launches it, so it is not compiled
    tprob = notebook_survey()[0].build_problem()
    tprob.set_source_importance(fields.dipole_importance(
        (-200.0, -9.0), (200.0, -9.0), 5.0))
    _kernel_params(tprob, robin_correction="reflectance").pack()


def _majorant_over_kernel_table():
    tprob = geophysical_scenario()[0].build_problem()
    p = Problem(dirichlet=tprob.dirichlet, neumann=tprob.neumann,
                alpha=tprob.alpha, source=tprob.source,
                local_majorant=LocalMajorant(
                    boxes=tuple((10.0 * i, 10.0 * i + 5.0, -50.0, -40.0)
                                for i in range(9)), sigma_bar_bg=1e-3))
    wk.make_walk_params(p, eps=EPS, max_steps=10, t_min=1e-3, rmin=0.45,
                        project=True, rejection_rounds=2,
                        roulette_threshold=None, snap=False, seed=1).pack()


def _mis_without_delta_tracking():
    # MIS next-event estimation on an unscreened problem
    # (ops/pallas_walk.py:956-961) is not ported yet
    prob = Problem(dirichlet=square_loop(1.0), source=fields.constant(1.0),
                   source_importance=fields.GaussianMixture.from_components(
                       [((0.0, 0.0), 0.2, 1.0)]))
    WoStSolver(prob, device="cpu").solve([[0.0, 0.0]], 8, 5, 1e-3)


def _terms_over_kernel_table():
    # a TERMS field of more terms than the kernel's table holds
    bc = fields.terms(0.0, *(fields.term(1.0, sx=("sin", float(k)))
                             for k in range(fields.MAX_TERMS + 1)))
    _kernel_params(Problem(dirichlet=square_loop(1.0), bc_dirichlet=bc)).pack()


def _terms_on_accuracy_instantiation():
    # the accuracy path's instantiation (the majorant) has no TERMS fields
    tprob = notebook_survey()[0].build_problem()
    p = Problem(dirichlet=tprob.dirichlet, neumann=tprob.neumann,
                alpha=tprob.alpha, source=tprob.source,
                bc_dirichlet=fields.polynomial({(1, 0): 1e-3}),
                local_majorant=LocalMajorant(
                    boxes=((0.0, 5.0, -50.0, -40.0),), sigma_bar_bg=1e-3))
    _kernel_params(p).pack()


UNPORTED = {
    "robin_interior_chord": lambda: _survey_solver(
        robin_correction="chain", robin_interior="chord").solve(
            [[0.0, -1.0]], 8, 5, EPS),
    "robin_arrival_only": lambda: _survey_solver(
        robin_correction="arrival-only").solve([[0.0, -1.0]], 8, 5, EPS),
    "majorant_over_kernel_table": _majorant_over_kernel_table,
    "mis_over_kernel_table": _mis_over_kernel_table,
    "kernel_variant_not_compiled": _kernel_variant_not_compiled,
    "mis_without_delta_tracking": _mis_without_delta_tracking,
    "terms_over_kernel_table": _terms_over_kernel_table,
    "terms_on_accuracy_instantiation": _terms_on_accuracy_instantiation,
    "compaction_pack": lambda: _survey_solver(
        compaction="pack").solve([[0.0, -1.0]], 8, 5, EPS),
    "threefry": lambda: _survey_solver(rng="threefry").solve(
        [[0.0, -1.0]], 8, 5, EPS),
    "xla_backend": lambda: _survey_solver(backend="xla").solve(
        [[0.0, -1.0]], 8, 5, EPS),
    "return_history": lambda: _survey_solver().solve(
        [[0.0, -1.0]], 8, 5, EPS, return_history=True),
    "geometry_over_table_budget": lambda: WoStSolver(
        _over_table_budget(), device="cpu").solve([[0.0, -1.0]], 8, 5, EPS),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_option_raises(case):
    with pytest.raises(NotImplementedError) as info:
        UNPORTED[case]()
    msg = str(info.value)
    assert "dcrmontecarlo_tpu/" in msg and "\n" not in msg


@pytest.mark.parametrize("kwargs,match", [
    (dict(compaction=True), "compaction=True"),
    (dict(robin_correction="residual"), "residual"),
])
def test_removed_modes_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _survey_solver(**kwargs).solve([[0.0, -1.0]], 8, 5, EPS)
