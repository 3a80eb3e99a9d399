"""Phase 49's narrow source through whole solves, against the JAX package.

``tests/test_pseudosection.py:150-176`` (``test_mis_nee_unbiased_and_
lower_variance``, ``chip_smoke.py`` phase 49 at full size): the unit
Gaussian of width 0.05 on ``square_loop(2.0)`` with ``u = 0`` on it,
solved at (0.5, 0) and (1, 1) with its one-component MIS mixture and
without, 6,000 walks each, ``max_steps`` 300, eps 1e-3, seed 0. The port
solves both through the host builds (``tests/host_cuda/``) of MIS without
delta tracking ``<0,false,true,false,false,false,false>`` and of the
static form without it (both ``walk_kernel.one_sincos``: the direction,
and with MIS the Box-Muller pair, from one ``sincosf``), launched as the
card's wrapper launches them, and holds the test's two bounds: the two
estimates within 4 sigma of each other at both points, the MIS stderr
below a third of the plain one. Each agrees with the JAX package's XLA
backend at the same seed within 4 sigma (the two errors in
quadrature).
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
MIS_ND = (0, _F, _T, _F, _F, _F, _F, _F, _F)
SHORT = (0, _F, _F, _F, _F, _F, _F, _F, _F)
OPTIONS = dict(target_slots=8192)
WALKS, MAX_STEPS, EPS = 6000, 300, 1e-3


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    return host_builds(tmp_path_factory, (MIS_ND, SHORT))


def _jax_solve(mis):
    import jax.numpy as jnp

    from dcrmontecarlo_tpu import Problem as JProblem
    from dcrmontecarlo_tpu import square_loop as j_square_loop
    from dcrmontecarlo_tpu.problems.fields import GaussianMixture
    from dcrmontecarlo_tpu.solver import SolverOptions as JOptions
    from dcrmontecarlo_tpu.solver import WoStSolver as JSolver

    w = cs.NARROW_WIDTH
    amp = 1.0 / (2 * np.pi * w * w)
    imp = GaussianMixture.from_components([((0.0, 0.0), w, 1.0)])
    prob = JProblem(dirichlet=j_square_loop(2.0),
                    bc_dirichlet=lambda x, y: 0.0 * x,
                    source=lambda x, y: amp * jnp.exp(-(x * x + y * y)
                                                      / (2 * w * w)),
                    source_importance=imp if mis else None)
    return JSolver(prob, JOptions(backend="xla", **OPTIONS)).solve(
        cs.NARROW_POINTS, n_walks=WALKS, max_steps=MAX_STEPS, eps=EPS,
        seed=0)


def test_narrow_source_holds_the_tests_bounds_and_matches_jax(host_walks):
    got = {}
    for label, mis, variant in (("mis", True, MIS_ND),
                                ("plain", False, SHORT)):
        problem, _ = cs.narrow_source_config(mis)
        solver = WoStSolver(problem, SolverOptions(**OPTIONS), device="cpu")
        walk = _dealt_walk(host_walks[variant])
        res = solver._solve_raw(cs.NARROW_POINTS, WALKS, MAX_STEPS, EPS, 0,
                                walk=walk)
        assert set(walk.loops) == {"lanes"}
        g, g_se = res.mean[0], res.stderr[0]
        assert np.isfinite(g).all() and np.isfinite(g_se).all()
        want = _jax_solve(mis)
        w, w_se = np.asarray(want.mean), np.asarray(want.stderr)
        assert (np.abs(g - w) <= 4.0 * np.hypot(g_se, w_se)).all(), (
            label, g, w, g_se, w_se)
        got[label] = (g, g_se)
    (a, a_se), (b, b_se) = got["plain"], got["mis"]
    dev = np.abs(a - b) / np.hypot(a_se, b_se)
    assert (dev < 4).all(), (a, b)
    assert (b_se < a_se / 3).all(), (a_se, b_se)
