"""Finite-difference/volume oracle for cross-validating the MC solver.

The port's own copy of ``dcrmontecarlo_tpu/validation/fdm.py``, code
unchanged (the port imports nothing of the JAX package;
``tests/test_torch_fdm_gate.py`` holds the two to the same potentials).
The JAX package's CI replacement for the reference's external SimPEG FEM oracle
(``tests/testNotebook.ipynb`` cells 5-15, ``Simulation2DNodal`` on a
TreeMesh): a self-contained scipy.sparse finite-volume discretization of

    ``-div(alpha grad u) + sigma u = f``

on a rectangular grid with Dirichlet sides/bottom and an optional zero-flux
(Neumann) top surface — exactly the DCR half-space geometry. Face
conductivities use harmonic averaging; the Neumann condition is imposed by
mirror ghost cells. Accuracy is second order in the grid spacing, far
tighter than MC error at the resolutions used in tests.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla

__all__ = ["fdm_solve", "FDMSolution"]


class FDMSolution:
    """Grid solution with bilinear interpolation at arbitrary points."""

    def __init__(self, xs, ys, u):
        self.xs = xs
        self.ys = ys
        self.u = u  # (nx, ny)

    def __call__(self, points) -> np.ndarray:
        pts = np.asarray(points, np.float64).reshape(-1, 2)
        xs, ys, u = self.xs, self.ys, self.u
        fx = np.clip((pts[:, 0] - xs[0]) / (xs[1] - xs[0]), 0, len(xs) - 1.000001)
        fy = np.clip((pts[:, 1] - ys[0]) / (ys[1] - ys[0]), 0, len(ys) - 1.000001)
        ix = fx.astype(int)
        iy = fy.astype(int)
        tx = fx - ix
        ty = fy - iy
        return (
            (1 - tx) * (1 - ty) * u[ix, iy]
            + tx * (1 - ty) * u[ix + 1, iy]
            + (1 - tx) * ty * u[ix, iy + 1]
            + tx * ty * u[ix + 1, iy + 1]
        )


def fdm_solve(
    bounds: Tuple[Tuple[float, float], Tuple[float, float]],
    alpha: Callable,
    source: Callable,
    sigma: Optional[Callable] = None,
    bc: Optional[Callable] = None,
    neumann_top: bool = False,
    nx: int = 257,
    ny: int = 257,
) -> FDMSolution:
    """Solve ``-div(alpha grad u) + sigma u = f`` on a rectangle.

    Args:
        bounds: ``((x0, x1), (y0, y1))``.
        alpha, source, sigma: numpy-vectorized fields ``f(X, Y)``.
        bc: Dirichlet boundary value field (default 0). Applied on all four
            sides, or on sides+bottom only when ``neumann_top`` is set.
        neumann_top: zero-flux condition on the ``y = y1`` row (the DCR
            air-interface convention, ``testGeophysicalScenario.py:98-106``).
    """
    (x0, x1), (y0, y1) = bounds
    xs = np.linspace(x0, x1, nx)
    ys = np.linspace(y0, y1, ny)
    hx = xs[1] - xs[0]
    hy = ys[1] - ys[0]
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    A = np.asarray(alpha(X, Y), np.float64)
    if A.shape != X.shape:
        A = np.broadcast_to(A, X.shape).copy()
    F = np.asarray(source(X, Y), np.float64)
    if F.shape != X.shape:
        F = np.broadcast_to(F, X.shape).copy()
    S = np.zeros_like(X) if sigma is None else np.broadcast_to(
        np.asarray(sigma(X, Y), np.float64), X.shape
    )

    def harmonic(a, b):
        return 2.0 * a * b / np.maximum(a + b, 1e-300)

    # face conductivities
    ax_e = np.zeros_like(A)  # east face of (i, j): between i and i+1
    ax_e[:-1, :] = harmonic(A[:-1, :], A[1:, :])
    ay_n = np.zeros_like(A)  # north face of (i, j): between j and j+1
    ay_n[:, :-1] = harmonic(A[:, :-1], A[:, 1:])

    n = nx * ny

    interior_mask = np.zeros((nx, ny), bool)
    interior_mask[1:-1, 1:-1] = True
    if neumann_top:
        interior_mask[1:-1, -1] = True  # top row is an unknown

    # per-node neighbor couplings (vectorized COO assembly: the previous
    # per-node Python loop spent seconds per oracle solve)
    cw = np.zeros((nx, ny))
    cw[1:, :] = ax_e[:-1, :] / hx**2
    ce = ax_e / hx**2
    cs = np.zeros((nx, ny))
    cs[:, 1:] = ay_n[:, :-1] / hy**2
    cn = ay_n / hy**2
    if neumann_top:
        # MIRROR ghost at the zero-flux surface: u_ghost = u_south with
        # the south face conductivity, i.e. the north coupling folds into
        # a DOUBLED south coupling. (Dropping the north flux instead —
        # cn = 0 with single cs — degrades the stencil to first order on
        # the top row, exactly where the DCR electrodes sit: verified
        # max-error halving vs quartering on u = cos(pi x) cosh(pi(y-1)).)
        cs[:, -1] *= 2.0
        cn[:, -1] = 0.0

    K = np.arange(n).reshape(nx, ny)
    rhs = np.zeros(n)
    rows = [K[interior_mask]]
    cols = [K[interior_mask]]
    vals = [(cw + ce + cs + cn + S)[interior_mask]]
    for coef, dk in ((cw, -ny), (ce, ny), (cs, -1), (cn, 1)):
        m = interior_mask & (coef != 0.0)
        rows.append(K[m])
        cols.append(K[m] + dk)
        vals.append(-coef[m])
    rhs[K[interior_mask]] = F[interior_mask]

    # Dirichlet rows
    dir_mask = ~interior_mask
    bc_vals = np.zeros((nx, ny)) if bc is None else np.broadcast_to(
        np.asarray(bc(X, Y), np.float64), X.shape
    )
    rows.append(K[dir_mask])
    cols.append(K[dir_mask])
    vals.append(np.ones(int(dir_mask.sum())))
    rhs[K[dir_mask]] = bc_vals[dir_mask]

    M = sps.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    u = spla.spsolve(M, rhs).reshape(nx, ny)
    return FDMSolution(xs, ys, u)
