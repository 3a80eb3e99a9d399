"""Walks without delta tracking: the port's plain walk against the JAX package.

A problem with no ``alpha`` and no ``sigma`` walks plain Walk-on-Stars:
the walker jumps to its ball's edge or its Neumann hit, and a source is
sampled at the Green's radius ``R sqrt(u2 u3)`` with the weight
``R^2 / 4`` (``ops/pallas_walk.py:626-629``, ``:906-909``, ``:920-931``,
``:1104-1106``). One numpy-built set of walker planes (1,024 lanes or
more) goes through the interpreted Pallas kernel and through the port's
plain walk for 32 steps in the cases of ``chip_smoke.py`` phase 21: the
harmonic square, the Poisson square, the Neumann box of
``tests/test_pallas_walk.py:142-151``, a Poisson square around a square
Neumann obstacle (the static form with silhouette vertices) and a
100-segment square (the table form). Every plane must agree on >= 99% of
the lanes to rel 1e-4 (``walk_kernel.compare_planes``): without a
coefficient the walks depend on the geometry and the draws alone.

The obstacle here is a square, not ``poisson_square(with_obstacle=True)``'s
32-segment circle, for the reason ``test_torch_silhouette.py`` walks a
staircase: on a sloped wall a hit point rounds off the wall's line and the
silhouette test of the wall's end vertices reads its last bit, so one-ulp
differences of the two math libraries desynchronize walks within a few
dozen steps (as a one-ulp nudge of the start points does to the JAX
kernel's own walks). The circle's solves are held statistically
(``test_torch_analytic.py``) and walk for walk on the card, where kernel
and plain version share one math library (``chip_smoke.py`` phase 21).

Whole solves of ``test_pallas_matches_xla_harmonic``'s and
``_source_nee``'s problems match the JAX XLA backend with equal total
steps and means to 4e-6 of their scale: the float32 moments of 64 walks
per point are summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.ops.pallas_walk import make_pallas_walk
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.sampling.rng import stream_seed
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_walk_kernel import numpy_planes

torch.set_num_threads(1)

SEED, STEPS = 7, 32
OPTS = dict(target_slots=1024, pallas_block_rows=8,
            common_random_numbers=True)
BOX = [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
WALL = [[-2.0, 0.0], [2.0, 0.0]]
OBSTACLE = [[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5]]


def _compare(got, want, names):
    frac, _, finite = wk.compare_planes(
        {k: torch.tensor(v) for k, v in got.items()},
        {k: torch.tensor(v) for k, v in want.items()}, names)
    assert finite
    assert min(frac.values()) >= wk.PLANE_MIN_FRAC, frac
    return frac


def one_launch(tprob, jprob, points, n_walks, eps, max_steps, jopts=None,
               topts=None, steps=STEPS):
    """32 steps of the interpreted Pallas kernel and of the port's plain
    walk from one numpy-built state; returns ``(got, want, params,
    planes)``."""
    from jax.experimental.pallas import tpu as pltpu

    jopts = dict(OPTS, **(jopts or {}))
    jsolver = JSolver(jprob, JOptions(**jopts))
    planes = numpy_planes(jsolver, points, n_walks, eps)
    snap = "ob0" in planes
    common = dict(eps=eps, max_steps=max_steps, t_min=1e-5 * jprob.diameter,
                  rmin=0.5 * eps, project=True,
                  rejection_rounds=jopts.get("rejection_rounds", 64),
                  roulette_threshold=jopts.get("roulette_threshold"))
    robin = jsolver._robin_enabled()
    sampler = jopts.get("screened_sampler", "exact")
    plan = make_pallas_walk(jprob, n_inner=steps, block_rows=8,
                            snap_starts=snap, robin_correction=robin,
                            screened_sampler=sampler, **common)
    with pltpu.force_tpu_interpret_mode():
        out = plan.run({k: jnp.asarray(v) for k, v in planes.items()},
                       stream_seed(SEED), inner_steps=steps)
    want = {k: np.asarray(v) for k, v in out.items()}
    params = wk.make_walk_params(tprob, snap=snap, seed=stream_seed(SEED),
                                 robin_correction=robin,
                                 screened_sampler=sampler,
                                 **dict(common, **(topts or {})))
    state = interop.state_from_numpy(planes)
    got = interop.state_to_numpy(wk.run_walk(state, params, steps))
    return got, want, params, planes


def _table_square(half=2.0, per_side=25):
    """A square with ``per_side`` segments per side (the table form)."""
    c = [(half, half), (-half, half), (-half, -half), (half, -half)]
    pts = []
    for s in range(4):
        (ax, ay), (bx, by) = c[s], c[(s + 1) % 4]
        for k in range(per_side):
            t = k / per_side
            pts.append([ax + t * (bx - ax), ay + t * (by - ay)])
    pts.append(list(c[0]))
    return pts


def _pair(name):
    """``(port problem, JAX problem, points, eps)`` of a phase-21 case."""
    if name == "harmonic_square":
        return (Problem(dirichlet=square_loop(1.0),
                        bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                        (0, 1): 2.0})),
                JProblem(dirichlet=j_square(1.0),
                         bc_dirichlet=lambda x, y: x + 2.0 * y),
                [[0.0, 0.0], [0.5, 0.3], [-0.7, -0.2], [0.2, -0.8]], 1e-3)
    if name == "poisson_square":
        return (Problem(dirichlet=square_loop(2.0),
                        bc_dirichlet=fields.polynomial({(2, 0): 1.0,
                                                        (0, 2): 1.0}),
                        source=fields.constant(-4.0)),
                JProblem(dirichlet=j_square(2.0),
                         bc_dirichlet=lambda x, y: x * x + y * y,
                         source=lambda x, y: -4.0 + 0.0 * x),
                [[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]], 1e-3)
    if name == "neumann_box":
        return (Problem(dirichlet=Polyline.from_points(BOX),
                        neumann=Polyline.from_points(WALL),
                        bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                        (0, 1): 1.0})),
                JProblem(dirichlet=JPolyline.from_points(BOX),
                         neumann=JPolyline.from_points(WALL),
                         bc_dirichlet=lambda x, y: x + y),
                [[0.0, -1.0], [0.5, -0.5], [-1.5, -0.02]], 1e-2)
    if name == "box_obstacle":
        return (Problem(dirichlet=square_loop(2.0),
                        neumann=Polyline.from_points(OBSTACLE),
                        bc_dirichlet=fields.polynomial({(2, 0): 1.0,
                                                        (0, 2): 1.0}),
                        source=fields.constant(-4.0)),
                JProblem(dirichlet=j_square(2.0),
                         neumann=JPolyline.from_points(OBSTACLE),
                         bc_dirichlet=lambda x, y: x * x + y * y,
                         source=lambda x, y: -4.0 + 0.0 * x),
                [[1.0, 1.0], [0.7, 0.0], [0.0, -1.5], [-0.55, 0.1]], 1e-3)
    assert name == "table_square"
    sq = _table_square()
    return (Problem(dirichlet=Polyline.from_points(sq),
                    bc_dirichlet=fields.polynomial({(2, 0): 1.0,
                                                    (0, 2): 1.0}),
                    source=fields.constant(-4.0)),
            JProblem(dirichlet=JPolyline.from_points(sq),
                     bc_dirichlet=lambda x, y: x * x + y * y,
                     source=lambda x, y: -4.0 + 0.0 * x),
            [[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]], 1e-3)


CASES = ("harmonic_square", "poisson_square", "neumann_box",
         "box_obstacle", "table_square")


@pytest.mark.parametrize("name", CASES)
def test_plain_walk_matches_pallas_kernel(name):
    tprob, jprob, pts, eps = _pair(name)
    assert not tprob.use_delta_tracking and not jprob.use_delta_tracking
    pts = np.asarray(pts, np.float32)
    got, want, params, _ = one_launch(tprob, jprob, pts, 1024, eps, 200)
    assert got["px"].size >= 1024
    assert not params.delta and not params.transport
    assert params.variant in wk.KERNEL_VARIANTS
    _compare(got, want, state_planes(params.n_src))
    assert (want["ndone"] > 0).any() and (want["life"] > 0).any()
    if name == "box_obstacle":
        assert not params.table and len(params.vert_table) >= 3
    if name == "table_square":
        assert params.table and len(params.dir_table) == 100


def test_greens_radius_nee_acts():
    # the same launch with the source removed banks otherwise on >= 1% of
    # lanes: the Green's-radius sample and its weight R^2 / 4 ran
    tprob, jprob, pts, eps = _pair("poisson_square")
    pts = np.asarray(pts, np.float32)
    got, _, params, planes = one_launch(tprob, jprob, pts, 1024, eps, 200)
    bare = Problem(dirichlet=tprob.dirichlet, bc_dirichlet=tprob.bc_dirichlet)
    p0 = wk.make_walk_params(bare, eps=eps, max_steps=200,
                             t_min=1e-5 * tprob.diameter, rmin=0.5 * eps,
                             project=True, rejection_rounds=64,
                             roulette_threshold=None, snap=False,
                             seed=stream_seed(SEED))
    other = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), p0, STEPS))
    changed = np.mean(got["acc0"] != other["acc0"])
    assert changed >= 0.01, changed
    # the walks themselves are the same: only the source's draws differ
    np.testing.assert_array_equal(got["px"], other["px"])


def test_no_delta_params_ignore_delta_options():
    # as the JAX kernel does without delta tracking: no Robin, roulette,
    # max_attenuation or sampler (ops/pallas_walk.py:611, :1100, :1120)
    tprob, _, _, _ = _pair("neumann_box")
    p = wk.make_walk_params(tprob, eps=1e-2, max_steps=10, t_min=1e-4,
                            rmin=5e-3, project=True, rejection_rounds=2,
                            roulette_threshold=0.05, snap=True, seed=1,
                            robin_correction="chain", max_attenuation=2.0,
                            screened_sampler="transport")
    assert p.robin == wk.ROBIN_OFF and p.roulette_threshold is None
    assert p.max_attenuation is None and not p.transport and not p.delta
    assert p.variant == (wk.ROBIN_OFF, False, False, False, False, False,
                         False, False, False)
    fp, ip = p.pack()
    assert ip[19] == 0 and ip[20] == 0 and ip[3] == 0


_SMALL = dict(target_slots=256, pallas_inner_steps=16, pallas_block_rows=8)


@pytest.mark.parametrize("name", ["harmonic_square", "poisson_square"])
def test_whole_solve_matches_jax_xla(name):
    # test_pallas_matches_xla_harmonic's and _source_nee's problems and
    # options: the same counter-hash streams, so means agree to rounding
    # and total steps exactly
    tprob, jprob, _, _ = _pair(name)
    pts = np.array([[0.0, 0.0], [0.5, 0.3]], np.float32)
    want = JSolver(jprob, JOptions(backend="xla", **_SMALL)).solve(
        pts, n_walks=64, max_steps=60, eps=1e-3, seed=5)
    got = WoStSolver(tprob, SolverOptions(**_SMALL), device="cpu").solve(
        pts, n_walks=64, max_steps=60, eps=1e-3, seed=5)
    scale = max(np.abs(np.asarray(want.mean)).max(), 1e-3)
    np.testing.assert_allclose(got.mean, np.asarray(want.mean), rtol=0,
                               atol=4e-6 * scale)
    assert got.total_steps == float(want.total_steps)
