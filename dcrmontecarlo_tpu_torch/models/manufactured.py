"""Manufactured-solution problems (port of ``models/manufactured.py``).

Each function returns ``(Problem, u_exact)`` with ``u_exact(points)`` the
analytic solution on an ``(N, 2)`` array. The fields are kernel field
specs (``problems/fields.py``, kind ``TERMS``) built from the JAX
functions' constants; the polynomial model's source
``f = -div(D grad u) + sigma u`` is formed here by exact polynomial
arithmetic, the trigonometric model's by hand (two terms).
"""

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..geometry.polyline import square_loop
from ..problems import fields
from ..problems.problem import Problem
from ..utils.autodiff import gradient, laplacian

__all__ = [
    "polynomial_manufactured",
    "trig_manufactured",
    "autodiff_manufactured",
    "interior_grid",
]


def _poly(coeffs) -> np.ndarray:
    """A 4 x 4 coefficient array ``a[i, j]`` of ``x^i y^j``."""
    a = np.zeros((4, 4))
    for (i, j), v in coeffs.items():
        a[i, j] = v
    return a


def _mul(a, b) -> np.ndarray:
    out = np.zeros((7, 7))
    for i, j in zip(*np.nonzero(a)):
        out[i:i + 4, j:j + 4] += a[i, j] * b
    if np.any(out[4:, :]) or np.any(out[:, 4:]):
        raise ValueError("product of degree > 3 in a variable")
    return out[:4, :4]


def _dx(a) -> np.ndarray:
    out = np.zeros((4, 4))
    out[:3, :] = a[1:, :] * np.arange(1, 4)[:, None]
    return out


def _dy(a) -> np.ndarray:
    return _dx(a.T).T


def _as_dict(a) -> dict:
    return {(int(i), int(j)): float(a[i, j]) for i, j in zip(*np.nonzero(a))}


def polynomial_manufactured(domain_size: float = 2.0
                            ) -> Tuple[Problem, Callable]:
    """``u = (1-x^2)(1-y^2)``, ``D = 2 + 0.5x + 0.5y``, ``sigma = 2 + xy``
    (reference ``testWoStCorrectness.py:81-142``)."""

    def u_exact(pts):
        x, y = pts[:, 0], pts[:, 1]
        return (1 - x**2) * (1 - y**2)

    u = _poly({(0, 0): 1.0, (2, 0): -1.0, (0, 2): -1.0, (2, 2): 1.0})
    D = _poly({(0, 0): 2.0, (1, 0): 0.5, (0, 1): 0.5})
    sig = _poly({(0, 0): 2.0, (1, 1): 1.0})
    lap_u = _dx(_dx(u)) + _dy(_dy(u))
    f = -(_mul(D, lap_u) + _mul(_dx(D), _dx(u)) + _mul(_dy(D), _dy(u))) \
        + _mul(sig, u)
    prob = Problem(
        dirichlet=square_loop(domain_size / 2.0),
        bc_dirichlet=fields.polynomial(_as_dict(u)),
        source=fields.polynomial(_as_dict(f)),
        alpha=fields.polynomial(_as_dict(D)),
        sigma=fields.polynomial(_as_dict(sig)),
    )
    return prob, u_exact


def trig_manufactured(domain_size: float = 2.0) -> Tuple[Problem, Callable]:
    """``u = sin(pi x) sin(pi y)``, ``D = 2 + x``, ``sigma = y^2 + 1``
    (reference ``testWoStCorrectness.py:22-78``), with the JAX package's
    corrected sign of the absorption term:
    ``f = (4 pi^2 + 1 + 2 pi^2 x + y^2) u - pi cos(pi x) sin(pi y)``."""

    def u_exact(pts):
        x, y = pts[:, 0], pts[:, 1]
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    pi = math.pi
    sin_pi = ("sin", pi)
    prob = Problem(
        dirichlet=square_loop(domain_size / 2.0),
        bc_dirichlet=fields.terms(0.0, fields.term(1.0, sx=sin_pi,
                                                   sy=sin_pi)),
        source=fields.terms(
            0.0,
            fields.term({(0, 0): 4 * pi**2 + 1, (1, 0): 2 * pi**2,
                         (0, 2): 1.0}, sx=sin_pi, sy=sin_pi),
            fields.term(-pi, sx=("cos", pi), sy=sin_pi)),
        alpha=fields.polynomial({(0, 0): 2.0, (1, 0): 1.0}),
        sigma=fields.polynomial({(0, 0): 1.0, (0, 2): 1.0}),
    )
    return prob, u_exact


def interior_grid(domain_size: float = 2.0, n_points: int = 4,
                  margin: float = 0.3):
    """Interior evaluation grid (reference ``create_test_points``)."""
    half = domain_size / 2.0
    c = half - margin
    g = np.linspace(-c, c, n_points)
    X, Y = np.meshgrid(g, g, indexing="ij")
    return np.stack([X.ravel(), Y.ravel()], axis=1).astype(np.float32)


def autodiff_manufactured(u, alpha=None, sigma=None, dirichlet=None,
                          neumann=None, **problem_kwargs
                          ) -> Tuple[Problem, Callable]:
    """A manufactured problem for any elementwise torch ``u``, ``alpha``,
    ``sigma``: the source ``f = -(alpha lap u + grad alpha . grad u) +
    sigma u`` by ``torch.func`` (``utils/autodiff.py``). ``u`` is also the
    Dirichlet BC; with ``neumann`` walls the caller picks ``u`` with zero
    normal derivative there. The source is a callable, not a field spec,
    so these problems run on the CPU path only.
    """
    if dirichlet is None:
        dirichlet = square_loop(1.0)
    a = alpha if alpha is not None else (lambda x, y: 1.0 + 0.0 * x)
    grad_u = gradient(u)
    lap_u = laplacian(u)
    grad_a = gradient(a)

    def source(x, y):
        gx, gy = grad_u(x, y)
        ax, ay = grad_a(x, y)
        f = -(a(x, y) * lap_u(x, y) + ax * gx + ay * gy)
        if sigma is not None:
            f = f + sigma(x, y) * u(x, y)
        return f

    prob = Problem(dirichlet=dirichlet, neumann=neumann, bc_dirichlet=u,
                   source=source, alpha=alpha, sigma=sigma,
                   **problem_kwargs)

    def u_exact(pts):
        pts = torch.as_tensor(np.asarray(pts, np.float32))
        return u(pts[:, 0], pts[:, 1]).detach().numpy()

    return prob, u_exact
