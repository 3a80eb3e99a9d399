"""Variable-coefficient mixed-boundary model (port of ``models/varcoeff.py``).

Gaussian-bump diffusion and sinusoidal absorption on a square with an
inner circular Neumann obstacle (reference
``testWostVariableCoefficients.py:37-104``), as kernel field specs:

* diffusion ``D = 0.5 + 1.5 exp(-2 r^2)``,
* absorption ``sigma = 0.3 + 0.7 (1 + sin(2 pi x) cos(2 pi y))``, held as
  ``1 + 0.7 sin(2 pi x) cos(2 pi y)``,
* BC ``u = sin(pi x) sin(pi y)``,
* source ``exp(-r^2) sin(pi x) cos(pi y)``.
"""

import math

import numpy as np

from ..geometry.polyline import circle_loop, square_loop
from ..problems import fields
from ..problems.problem import Problem

__all__ = ["variable_coefficient_problem", "varcoeff_solve_points"]


def variable_coefficient_problem() -> Problem:
    pi = math.pi
    return Problem(
        dirichlet=square_loop(1.5),
        neumann=circle_loop(0.4, n=32),
        bc_dirichlet=fields.terms(0.0, fields.term(1.0, sx=("sin", pi),
                                                   sy=("sin", pi))),
        source=fields.terms(0.0, fields.term(1.0, g=1.0, sx=("sin", pi),
                                             sy=("cos", pi))),
        alpha=fields.terms(0.5, fields.term(1.5, g=2.0)),
        sigma=fields.terms(0.3 + 0.7, fields.term(
            0.7, sx=("sin", 2 * pi), sy=("cos", 2 * pi))),
    )


def varcoeff_solve_points(n: int = 27, margin_radius: float = 0.5):
    """Evaluation grid excluding the obstacle."""
    g = np.linspace(-1.3, 1.3, n)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    keep = np.sqrt((pts**2).sum(axis=1)) > margin_radius
    return pts[keep].astype(np.float32)
