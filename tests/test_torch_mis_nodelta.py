"""MIS next-event estimation without delta tracking, port against JAX.

A problem with no ``alpha`` and no ``sigma`` and a source importance
mixture samples its source toward the mixture as well as at the Green's
radius, and weighs the sample by the balance heuristic over the ball's
Green's function ``ln(R/r) / (2 pi)`` and its norm ``R^2 / 4``, with no
alpha factor (``ops/pallas_walk.py:956-961``; streams 1, 2, 3 and 5-8,
``:626-633``). The source is the narrow Gaussian of
``tests/test_pseudosection.py:150-175`` (width 0.05, unit mass), as the
port's ``fields.gaussian_bump``.

One numpy-built set of 1,024+ walker planes goes through the interpreted
Pallas kernel and the port's plain walk for 32 steps, on that test's
square and on a Neumann box (the star test of the MIS sample acts); every
plane must agree on >= 99% of the lanes to rel 1e-4
(``walk_kernel.compare_planes``). Dropping the mixture changes the
accumulators and not the walks. A whole solve of the test's problem at a
cut size (500 walks) lies within 4 sigma of the JAX package's XLA
backend, whose MIS branch for a walk without delta tracking is the one
the reference test runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.geometry import square_loop as j_square
from dcrmontecarlo_tpu.problems.fields import GaussianMixture as JMixture
from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
from dcrmontecarlo_tpu.solver import WoStSolver as JSolver
from dcrmontecarlo_tpu_torch import interop
from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_nodelta import BOX, STEPS, WALL, _compare, one_launch

torch.set_num_threads(1)

W = 0.05
AMP = 1.0 / (2 * np.pi * W * W)


def _pair(name, mis=True):
    """``(port problem, JAX problem, points, eps)``: the reference test's
    square, or a Neumann box with the Gaussian near its wall."""
    c = (0.0, 0.0) if name == "square" else (0.0, -0.3)
    jmix = JMixture.from_components([(c, W, 1.0)]) if mis else None
    src = fields.gaussian_bump(c, AMP, W)
    jsrc = lambda x, y: AMP * jnp.exp(
        -((x - c[0]) ** 2 + (y - c[1]) ** 2) / (2 * W * W))
    common = dict(source_importance=interop.gaussian_mixture_from(jmix))
    if name == "square":
        return (Problem(dirichlet=square_loop(2.0), source=src,
                        bc_dirichlet=fields.constant(0.0), **common),
                JProblem(dirichlet=j_square(2.0), source=jsrc,
                         bc_dirichlet=lambda x, y: 0.0 * x,
                         source_importance=jmix),
                [[0.5, 0.0], [1.0, 1.0], [-0.3, 0.2]], 1e-3)
    return (Problem(dirichlet=Polyline.from_points(BOX),
                    neumann=Polyline.from_points(WALL), source=src,
                    bc_dirichlet=fields.constant(0.0), **common),
            JProblem(dirichlet=JPolyline.from_points(BOX),
                     neumann=JPolyline.from_points(WALL), source=jsrc,
                     bc_dirichlet=lambda x, y: 0.0 * x,
                     source_importance=jmix),
            [[0.5, -0.2], [-1.0, -0.01], [0.0, -1.5]], 1e-2)


@pytest.mark.parametrize("name", ["square", "neumann_box"])
def test_plain_walk_matches_pallas_kernel(name):
    tprob, jprob, pts, eps = _pair(name)
    assert not tprob.use_delta_tracking and not jprob.use_delta_tracking
    got, want, params, _ = one_launch(tprob, jprob,
                                      np.asarray(pts, np.float32), 1024, eps,
                                      300)
    assert params.variant == (wk.ROBIN_OFF, False, True, False, False, False,
                              False, False, False)
    assert params.variant in wk.KERNEL_VARIANTS and wk.terms_fields(
        params.variant)
    _compare(got, want, state_planes(params.n_src))
    assert (want["ndone"] > 0).any() and (want["acc0"] != 0).any()


def test_mixture_acts_and_walks_stay():
    # the same launch without the mixture: the Green's-radius NEE banks
    # otherwise, the walks are the same
    tprob, jprob, pts, eps = _pair("neumann_box")
    got, _, params, planes = one_launch(tprob, jprob,
                                        np.asarray(pts, np.float32), 1024,
                                        eps, 300)
    bare, _, _, _ = _pair("neumann_box", mis=False)
    p0 = wk.make_walk_params(bare, eps=eps, max_steps=300,
                             t_min=params.t_min, rmin=params.rmin,
                             project=True, rejection_rounds=64,
                             roulette_threshold=None, snap=params.snap,
                             seed=params.seed)
    assert p0.mis_table is None
    other = interop.state_to_numpy(wk.run_walk(
        interop.state_from_numpy(planes), p0, STEPS))
    changed = np.mean(got["acc0"] != other["acc0"])
    assert changed >= 0.05, changed
    np.testing.assert_array_equal(got["px"], other["px"])
    np.testing.assert_array_equal(got["ndone"], other["ndone"])


def test_whole_solve_within_4_sigma_of_jax_xla():
    tprob, jprob, _, _ = _pair("square")
    pts = np.array([[0.5, 0.0], [1.0, 1.0]], np.float32)
    kw = dict(n_walks=500, max_steps=300, eps=1e-3, seed=0)
    want = JSolver(jprob, JOptions(target_slots=2048, backend="xla")).solve(
        pts, **kw)
    got = WoStSolver(tprob, SolverOptions(target_slots=2048),
                     device="cpu").solve(pts, **kw)
    gm, wm = np.asarray(got.mean), np.asarray(want.mean)
    comb = np.sqrt(np.asarray(got.stderr) ** 2
                   + np.asarray(want.stderr) ** 2)
    assert np.isfinite(gm).all() and (comb > 0).all()
    assert (np.abs(gm - wm) < 4.0 * comb).all(), (gm, wm, comb)
