"""The two builds without delta tracking through whole solves, against
the JAX package.

The host compiler builds ``csrc/walk_kernel.cu``'s static form without
delta tracking ``<0,false,false,false,false,false,false>``
(``walk_kernel.one_sincos``: the short walk) and its table form
``<0,false,false,false,true,false,false>`` (``walk_kernel.culled_closest``:
the Poisson bubble) with ``tests/host_cuda/``, and the solver's adaptive
single launch runs through them as the card's wrapper launches it
(``walk_kernel.launch_loop``: one thread a lane). The
reference's Poisson bubble (``tests/test_solver_source.py:33-46``: ``-lap u
= 1`` on the 256-segment unit disk, ``u = 0`` on it, ``chip_smoke.py``
phase 47) and the short walk's harmonic square (``bench.py --preset
short``: ``x + 2y`` on the unit square, phase 25), each at its three points
and 1,024 walks a point, 32 a lane, agree with the JAX package's solve on
its XLA backend at the same seed, run as
``test_torch_nodelta.py::test_whole_solve_matches_jax_xla`` runs it: every
mean within 4 sigma (the two errors in quadrature; the two draw the same
counter-hash streams, but on the disk's sloped rows a one-ulp difference of
the two math libraries parts a walk) and 1e-6 (from the disk's centre
every walk takes one step and the same weight), and within 4 sigma + 5e-3
of the exact solution, the reference test's bound.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from test_torch_host_dealt_walks import host_builds
from test_torch_host_dealt_walks_jax import _dealt_walk

torch.set_num_threads(1)

_F, _T = False, True
SHORT = (0, _F, _F, _F, _F, _F, _F, _F, _F)
BUBBLE = (0, _F, _F, _F, _T, _F, _F, _F, _F)
OPTIONS = dict(target_slots=96, pallas_block_rows=1, min_quota=32)


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, (SHORT, BUBBLE))


def _jax_problem(name):
    from dcrmontecarlo_tpu import Problem as JProblem
    from dcrmontecarlo_tpu import circle_loop as j_circle_loop
    from dcrmontecarlo_tpu import square_loop as j_square_loop

    if name == "bubble":
        return JProblem(dirichlet=j_circle_loop(1.0, n=256),
                        bc_dirichlet=lambda x, y: 0.0 * x,
                        source=lambda x, y: 1.0 + 0.0 * x)
    return JProblem(dirichlet=j_square_loop(1.0),
                    bc_dirichlet=lambda x, y: x + 2.0 * y)


# name: (the port's problem, points, max_steps, eps, exact, variant)
CASES = {
    "bubble": (lambda: cs.bubble_config()[0], cs.BUBBLE_POINTS,
               cs.BUBBLE_RUN[1], cs.BUBBLE_RUN[2],
               lambda p: cs.bubble_config()[2](p), BUBBLE),
    "short_walk": (lambda: cs.short_config()[0], cs.SHORT_POINTS,
                   cs.SHORT_RUN[1], cs.SHORT_RUN[2],
                   lambda p: p[:, 0] + 2.0 * p[:, 1], SHORT),
}


@pytest.mark.parametrize("name", list(CASES))
def test_solve_through_the_host_build_matches_jax_xla(host_walks, name):
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver

    make, pts, max_steps, eps, exact, variant = CASES[name]
    want = JSolver(_jax_problem(name), JOptions(backend="xla", **OPTIONS)
                   ).solve(pts, n_walks=1024, max_steps=max_steps, eps=eps,
                           seed=4)
    solver = WoStSolver(make(), SolverOptions(**OPTIONS), device="cpu")
    walk = _dealt_walk(host_walks[variant])
    got = solver._solve_raw(pts, 1024, max_steps, eps, 4, walk=walk)
    assert walk.loops == ["lanes"]
    w, w_se = np.asarray(want.mean), np.asarray(want.stderr)
    g, g_se = got.mean[0], got.stderr[0]
    assert np.isfinite(g).all() and np.isfinite(g_se).all()
    # (from the bubble's centre every walk ends in one step with the same
    # weight: a stderr of 0, so the two agree to rounding there)
    assert (np.abs(g - w) <= 4.0 * np.hypot(g_se, w_se) + 1e-6).all(), (
        g, w, g_se, w_se)
    assert (np.abs(g - exact(pts)) < 4.0 * g_se + 5e-3).all(), (g,
                                                                exact(pts))
    assert abs(got.total_steps / float(want.total_steps) - 1.0) < 0.05
