"""P1 triangular finite-element oracle — the SECOND independent reference.

The port's own copy of ``dcrmontecarlo_tpu/validation/fem.py``, code
unchanged (its ``.fdm`` import is the port's copy of the finite-volume
oracle; ``tests/test_torch_validation.py`` holds the two to the same
values).

The reference's richest check is a *third-party FEM* (SimPEG
``Simulation2DNodal`` on a TreeMesh, ``tests/testNotebook.ipynb`` cells
5-15) — structurally independent of the MC code under test. The in-repo
finite-volume oracle (``validation/fdm.py``) shares modelling conventions
with the solver, so a shared blind spot could pass both. This module
restores the reference's epistemic structure with a SECOND discretization
from a different family:

* **nodal P1 elements** on a structured triangulation (each grid cell
  split into two triangles) vs the FVM's cell-centered 5-point stencil;
* coefficient handled by **piecewise-constant centroid evaluation** inside
  the weak form vs the FVM's harmonic face averages;
* the zero-flux surface is a **natural boundary condition** (simply not
  constrained — the weak form's boundary integral vanishes) vs the FVM's
  mirror ghost cells.

Agreement between the two bounds the oracle error term in the flagship
DCR gate (``tests/test_dcr_survey.py``); both are convergence-order-gated
in ``tests/test_fdm_oracle.py``.

Assembly is fully vectorized: on a uniform grid all triangles are
congruent (two orientations), so each element stiffness is a constant
3x3 reference matrix scaled by the element's centroid ``alpha`` — one COO
concatenation, no Python loop over elements.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla

from .fdm import FDMSolution

__all__ = ["fem_solve"]


def _ref_stiffness(p1, p2, p3):
    """Element stiffness ``A * (grad phi_i . grad phi_j)`` for unit alpha."""
    x = np.array([p1[0], p2[0], p3[0]])
    y = np.array([p1[1], p2[1], p3[1]])
    # gradients of P1 basis: grad phi_k = (b_k, c_k) / (2A)
    b = np.array([y[1] - y[2], y[2] - y[0], y[0] - y[1]])
    c = np.array([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area = 0.5 * abs((x[1] - x[0]) * (y[2] - y[0])
                     - (x[2] - x[0]) * (y[1] - y[0]))
    return (np.outer(b, b) + np.outer(c, c)) / (4.0 * area), area


def fem_solve(
    bounds: Tuple[Tuple[float, float], Tuple[float, float]],
    alpha: Callable,
    source: Callable,
    sigma: Optional[Callable] = None,
    bc: Optional[Callable] = None,
    neumann_top: bool = False,
    nx: int = 257,
    ny: int = 257,
) -> FDMSolution:
    """Solve ``-div(alpha grad u) + sigma u = f`` with P1 elements.

    Same interface and return type as :func:`validation.fdm.fdm_solve`
    (the returned :class:`FDMSolution` interpolates bilinearly on the node
    grid), so tests can swap oracles freely.

    Args:
        bounds: ``((x0, x1), (y0, y1))``.
        alpha, source, sigma: numpy-vectorized fields ``f(X, Y)``.
        bc: Dirichlet value field (default 0) on all four sides, or
            sides+bottom only when ``neumann_top`` is set.
        neumann_top: zero-flux on ``y = y1`` — NATURAL in the weak form
            (the top row simply stays unconstrained).
    """
    (x0, x1), (y0, y1) = bounds
    xs = np.linspace(x0, x1, nx)
    ys = np.linspace(y0, y1, ny)
    hx = xs[1] - xs[0]
    hy = ys[1] - ys[0]
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    K = np.arange(nx * ny).reshape(nx, ny)

    # two congruent triangle orientations per cell:
    #   lower: (i,j) (i+1,j) (i,j+1);  upper: (i+1,j) (i+1,j+1) (i,j+1)
    k_lo = _ref_stiffness((0, 0), (hx, 0), (0, hy))
    k_up = _ref_stiffness((hx, 0), (hx, hy), (0, hy))
    cells_i, cells_j = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), indexing="ij"
    )
    ci = cells_i.ravel()
    cj = cells_j.ravel()
    n00 = K[ci, cj]
    n10 = K[ci + 1, cj]
    n01 = K[ci, cj + 1]
    n11 = K[ci + 1, cj + 1]
    tri_nodes = np.concatenate([
        np.stack([n00, n10, n01], axis=1),   # lower triangles
        np.stack([n10, n11, n01], axis=1),   # upper triangles
    ])
    # centroid alpha per triangle (piecewise-constant coefficient in the
    # weak form — deliberately NOT the FVM's harmonic face average)
    cx = xs[ci] + hx / 3.0
    cy_lo = ys[cj] + hy / 3.0
    cx_up = xs[ci] + 2.0 * hx / 3.0
    cy_up = ys[cj] + 2.0 * hy / 3.0
    a_tri = np.concatenate([
        np.asarray(alpha(cx, cy_lo), np.float64).ravel()
        * np.ones_like(cx),
        np.asarray(alpha(cx_up, cy_up), np.float64).ravel()
        * np.ones_like(cx),
    ])
    k_ref = np.concatenate([
        np.broadcast_to(k_lo[0], (len(ci), 3, 3)),
        np.broadcast_to(k_up[0], (len(ci), 3, 3)),
    ])
    vals = (a_tri[:, None, None] * k_ref).reshape(-1)
    rows = np.repeat(tri_nodes, 3, axis=1).reshape(-1)
    cols = np.tile(tri_nodes, (1, 3)).reshape(-1)

    # lumped load and mass: every interior node of the uniform
    # triangulation touches 6 triangles, each contributing area/3 —
    # exactly hx*hy per full node; boundary nodes get their actual share
    area3 = (0.5 * hx * hy) / 3.0
    m_lump = np.zeros(nx * ny)
    np.add.at(m_lump, tri_nodes.ravel(), area3)
    F = np.asarray(source(X, Y), np.float64)
    if F.shape != X.shape:
        F = np.broadcast_to(F, X.shape).copy()
    rhs = m_lump * F.ravel()
    if sigma is not None:
        S = np.broadcast_to(
            np.asarray(sigma(X, Y), np.float64), X.shape).ravel()
        rows = np.concatenate([rows, np.arange(nx * ny)])
        cols = np.concatenate([cols, np.arange(nx * ny)])
        vals = np.concatenate([vals, m_lump * S])

    # Dirichlet nodes: all four sides, or sides+bottom with a natural top
    dir_mask = np.zeros((nx, ny), bool)
    dir_mask[0, :] = dir_mask[-1, :] = True
    dir_mask[:, 0] = True
    if not neumann_top:
        dir_mask[:, -1] = True
    dir_idx = K[dir_mask]
    is_dir = np.zeros(nx * ny, bool)
    is_dir[dir_idx] = True
    free = ~is_dir[rows]
    rows, cols, vals = rows[free], cols[free], vals[free]
    rows = np.concatenate([rows, dir_idx])
    cols = np.concatenate([cols, dir_idx])
    vals = np.concatenate([vals, np.ones(len(dir_idx))])
    bc_vals = np.zeros((nx, ny)) if bc is None else np.broadcast_to(
        np.asarray(bc(X, Y), np.float64), X.shape
    )
    rhs[dir_idx] = bc_vals.ravel()[dir_idx]

    M = sps.csr_matrix((vals, (rows, cols)), shape=(nx * ny, nx * ny))
    u = spla.spsolve(M, rhs).reshape(nx, ny)
    return FDMSolution(xs, ys, u)
