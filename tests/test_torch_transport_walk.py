"""The walk with the transport sampler: the port against the JAX package.

One 32-step launch of the port's plain walk against the interpreted Pallas
kernel (``make_pallas_walk(..., screened_sampler="transport")``) from one
numpy-built state of 1,024 lanes, under ``walk_kernel.compare_planes``:
the configuration of ``tests/test_pallas_walk.py:120-139`` (variable
alpha, as a ``TERMS`` spec, and a Neumann wall: Robin ``"auto"`` resolves
to the chain) and the polynomial manufactured model (Robin off). The
sampler itself is held to the JAX function in
``test_torch_transport.py``.
"""

import numpy as np
import pytest
import torch

from dcrmontecarlo_tpu import Problem as JProblem
from dcrmontecarlo_tpu.geometry import Polyline as JPolyline
from dcrmontecarlo_tpu.models import polynomial_manufactured as j_poly
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.models import interior_grid, \
    polynomial_manufactured
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from test_torch_nodelta import BOX, WALL, _compare, one_launch

torch.set_num_threads(1)


def _transport_pair(name):
    """``(port problem, JAX problem, points, eps)``."""
    import jax.numpy as jnp

    if name == "neumann_box":
        # tests/test_pallas_walk.py:120-139: variable alpha and a Neumann
        # wall, so collisions, wall arrivals and the weight all act (and
        # Robin "auto" resolves to the chain)
        return (Problem(dirichlet=Polyline.from_points(BOX),
                        neumann=Polyline.from_points(WALL),
                        bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                        (0, 1): 1.0}),
                        alpha=fields.terms(
                            2.0, fields.term({(0, 1): 0.2}),
                            fields.term(0.3, sx=("sin", 0.5)))),
                JProblem(dirichlet=JPolyline.from_points(BOX),
                         neumann=JPolyline.from_points(WALL),
                         bc_dirichlet=lambda x, y: x + y,
                         alpha=lambda x, y: (2.0 + jnp.sin(0.5 * x) * 0.3
                                             + 0.2 * y)),
                [[0.0, -1.0], [0.5, -0.5]], 1e-2)
    assert name == "polynomial_manufactured"
    return (polynomial_manufactured(1.0 * 2)[0], j_poly(2.0)[0],
            interior_grid(n_points=3), 1e-3)


@pytest.mark.parametrize("name", ["neumann_box", "polynomial_manufactured"])
def test_plain_walk_matches_pallas_kernel(name):
    tprob, jprob, pts, eps = _transport_pair(name)
    pts = np.asarray(pts, np.float32)
    got, want, params, _ = one_launch(
        tprob, jprob, pts, 1024, eps, 500,
        jopts=dict(screened_sampler="transport"))
    assert params.transport and params.delta
    assert params.variant in wk.KERNEL_VARIANTS
    assert params.robin == (wk.ROBIN_CHAIN if name == "neumann_box"
                            else wk.ROBIN_OFF)
    frac = _compare(got, want, state_planes(params.n_src))
    assert frac["px"] >= wk.PLANE_MIN_FRAC
    assert (want["ndone"] > 0).any() and (want["life"] > 0).any()
