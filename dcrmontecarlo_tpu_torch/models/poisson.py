"""Poisson-with-source model (port of ``models/poisson.py``).

Exact solution ``u = x^2 + y^2`` with ``f = -4`` on a 4 x 4 Dirichlet
square; ``with_obstacle=True`` adds the reference setup's circular
Neumann obstacle (32 segments).
"""

from typing import Callable, Tuple

import numpy as np

from ..geometry.polyline import circle_loop, square_loop
from ..problems import fields
from ..problems.problem import Problem

__all__ = ["poisson_square", "poisson_solve_points"]


def poisson_square(with_obstacle: bool = False) -> Tuple[Problem, Callable]:
    def u_exact(pts):
        return pts[:, 0] ** 2 + pts[:, 1] ** 2

    prob = Problem(
        dirichlet=square_loop(2.0),
        neumann=circle_loop(0.5, n=32) if with_obstacle else None,
        bc_dirichlet=fields.polynomial({(2, 0): 1.0, (0, 2): 1.0}),
        source=fields.constant(-4.0),
    )
    return prob, u_exact


def poisson_solve_points(n: int = 21, margin_radius: float = 0.6):
    """Evaluation grid skipping the obstacle."""
    g = np.linspace(-1.8, 1.8, n)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    keep = np.sqrt((pts**2).sum(axis=1)) > margin_radius
    return pts[keep].astype(np.float32)
