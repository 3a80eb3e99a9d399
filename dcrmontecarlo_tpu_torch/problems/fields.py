"""Scalar fields as parametric specs (port of ``problems/fields.py``).

The JAX kernel traces arbitrary jnp lambdas, and a ``sigma'`` built by
``jax.grad``, into itself. A CUDA kernel cannot take a Python callable, so
the field families the DCR survey uses are *specs*: a small parameter
table plus hand-derived value, gradient and Laplacian. A spec is also a
plain callable on tensors, so the eager path and ``torch.func`` see an
ordinary field.

Kinds (the integer is the kernel's field tag, ``csrc/walk_kernel.cu``):

* ``CONST``  ``[value]``
* ``BUMPS``  ``[background, (amp, cx, cy, radius, sharpness, w2) * n]`` —
  background plus sigmoid-smoothed circles, ``sdf = sqrt(|x-c|^2 + w2) - R``
  with the regularizing ``w2 = min(1/sharpness, R/2)^2``;
* ``DIPOLE`` ``[px, py, nx, ny, norm, 2 w^2]`` — the Gaussian current dipole;
* ``TERMS``  ``[background, (term row) * n]`` — a background constant plus
  terms ``P(x, y) exp(ax x + ay y - g |p - c|^2) S1(x) S2(y)``: ``P`` a
  dense polynomial of degree <= 3 in each variable, ``S`` one of 1,
  ``sin(k t + phase)``, ``cos(k t + phase)``. The analytic-check models
  (``models/manufactured.py``, ``poisson.py``, ``varcoeff.py``) and the
  JAX tests' fields are of this kind; the kernel holds up to
  ``MAX_TERMS`` terms per field;
* ``GRID``   ``[x0, dx, y0, dy, hi_x, hi_y, nx, ny]`` plus a float32
  ``(nx, ny)`` table — the bilinear interpolant of a gridded field
  (``diagnostics.grid_continuation`` builds one, as the JAX package's
  does its closure; the cylinder oracle's Monte Carlo tier uses it as its
  Dirichlet data).
  It has no derivatives, so only ``bc_dirichlet`` may be one; the kernel
  reads its table from global memory.

Values of the survey kinds are computed in the same float32 operation
order as the JAX package's lambdas; a ``TERMS`` field differs from its
lambda by a few ulps (it has one operation order for every field it
stands for), and the kernel evaluates it in the plain version's order.
:class:`GaussianMixture` is the source importance density of MIS
next-event estimation (not a field: the walk kernel takes its components
as a table).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "CONST", "BUMPS", "DIPOLE", "TERMS", "GRID", "MAX_BUMPS", "MAX_TERMS",
    "TERM_COLS", "FieldSpec", "Constant", "BumpSum", "Dipole", "Term",
    "Terms", "Grid", "smooth_circle", "constant", "gaussian_dipole",
    "bump_sum", "term", "terms", "polynomial", "gaussian_bump",
    "is_spec", "sigma_prime_fn", "grad_log_alpha_fn",
    "GaussianMixture", "dipole_importance",
]

CONST, BUMPS, DIPOLE, TERMS, GRID = 0, 1, 2, 3, 4
MAX_BUMPS = 8          # kernel table capacity (csrc/walk_kernel.cu)
MAX_TERMS = 4          # kernel table capacity per TERMS field
TERM_COLS = 27         # 16 polynomial coefficients, ax, ay, g, cx, cy,
                       # (kind, k, phase) of S1 and of S2
S_NONE, S_SIN, S_COS = 0, 1, 2
ALPHA_EPS = 1e-8       # alpha clamp, as problems/problem.py:43 of the JAX package


class FieldSpec:
    """A field the walk kernel can evaluate: ``kind`` plus ``params``."""

    kind: int
    params: Tuple[float, ...]

    def table(self) -> Tuple[int, Tuple[float, ...]]:
        return self.kind, tuple(float(p) for p in self.params)


class Constant(FieldSpec):
    kind = CONST

    def __init__(self, value: float):
        self.value = float(value)
        self.params = (self.value,)

    def __call__(self, x, y):
        return self.value + 0.0 * x

    def value_grad_lap(self, x, y):
        z = 0.0 * x
        return self(x, y), z, z, z


class BumpSum(FieldSpec):
    """``background + sum_i amp_i * sigmoid(-k_i * sdf_i)``."""

    kind = BUMPS

    def __init__(self, background: float, bumps):
        self.background = float(background)
        self.bumps = tuple(tuple(float(v) for v in b) for b in bumps)
        if len(self.bumps) > MAX_BUMPS:
            raise ValueError(f"at most {MAX_BUMPS} bumps per field")
        self.params = (self.background,) + sum(self.bumps, ())

    @staticmethod
    def _geom(x, y, cx, cy, w2):
        ex = x - cx
        ey = y - cy
        d2 = ex * ex + ey * ey
        return ex, ey, d2, torch.sqrt(d2 + w2)

    def __call__(self, x, y):
        total = self.background + 0.0 * x
        for amp, cx, cy, radius, k, w2 in self.bumps:
            _, _, _, rho = self._geom(x, y, cx, cy, w2)
            total = total + amp * torch.sigmoid(-k * (rho - radius))
        return total

    def value_grad_lap(self, x, y):
        """Value, gradient and Laplacian, hand-derived: with
        ``s = sigmoid(-k sdf)``, ``s' = -k s (1-s)``,
        ``s'' = k^2 s (1-s)(1-2s)``, ``grad sdf = (ex, ey)/rho`` and
        ``lap sdf = (d^2 + 2 w2)/rho^3``."""
        total = self.background + 0.0 * x
        gx = 0.0 * x
        gy = 0.0 * x
        lap = 0.0 * x
        for amp, cx, cy, radius, k, w2 in self.bumps:
            ex, ey, d2, rho = self._geom(x, y, cx, cy, w2)
            s = torch.sigmoid(-k * (rho - radius))
            ds = -k * (s * (1.0 - s))
            d2s = k * (k * (s * (1.0 - s) * (1.0 - 2.0 * s)))
            total = total + amp * s
            gx = gx + amp * (ds * ex / rho)
            gy = gy + amp * (ds * ey / rho)
            lap = lap + amp * (d2s * (d2 / (rho * rho))
                               + ds * ((d2 + 2.0 * w2) / (rho * rho * rho)))
        return total, gx, gy, lap


class Dipole(FieldSpec):
    """``norm * (exp(-|x-p|^2 / 2w^2) - exp(-|x-n|^2 / 2w^2))``."""

    kind = DIPOLE

    def __init__(self, pos, neg, current: float, width: float):
        self.params = (float(pos[0]), float(pos[1]), float(neg[0]),
                       float(neg[1]),
                       current / (2.0 * math.pi * width * width),
                       2 * width * width)

    def _terms(self, x, y):
        px, py, nx, ny, _, tw2 = self.params
        epx, epy, enx, eny = x - px, y - py, x - nx, y - ny
        dp = epx * epx + epy * epy
        dn = enx * enx + eny * eny
        return (epx, epy, dp, torch.exp(-dp / tw2)), \
            (enx, eny, dn, torch.exp(-dn / tw2))

    def __call__(self, x, y):
        (_, _, _, gp), (_, _, _, gn) = self._terms(x, y)
        return self.params[4] * (gp - gn)

    def value_grad_lap(self, x, y):
        norm, tw2 = self.params[4], self.params[5]
        (epx, epy, dp, gp), (enx, eny, dn, gn) = self._terms(x, y)
        c = -2.0 / tw2
        gx = norm * (gp * (c * epx) - gn * (c * enx))
        gy = norm * (gp * (c * epy) - gn * (c * eny))
        lap = norm * (gp * (c * c * dp + 2.0 * c)
                      - gn * (c * c * dn + 2.0 * c))
        return norm * (gp - gn), gx, gy, lap


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def _f32_mul(a, b) -> float:
    """The float32 product of two float32 values (as the kernel forms it
    at run time), as a Python float."""
    return float(np.float32(a) * np.float32(b))


class Term(NamedTuple):
    """One ``TERMS`` term, every value rounded to float32: ``poly[i][j]``
    multiplies ``x^i y^j``; ``s1``, ``s2`` are ``(kind, k, phase)``."""

    poly: Tuple[Tuple[float, ...], ...]
    ax: float
    ay: float
    g: float
    cx: float
    cy: float
    s1: Tuple[int, float, float]
    s2: Tuple[int, float, float]

    @property
    def has_exp(self) -> bool:
        return self.ax != 0.0 or self.ay != 0.0 or self.g != 0.0

    def row(self) -> Tuple[float, ...]:
        """The kernel's table row (``TERM_COLS`` values)."""
        return (sum(self.poly, ()) + (self.ax, self.ay, self.g, self.cx,
                                      self.cy) + tuple(map(float, self.s1))
                + tuple(map(float, self.s2)))


def _horner(c, t):
    """``((c3 t + c2) t + c1) t + c0`` for coefficients ``c[0..3]``."""
    return ((c[3] * t + c[2]) * t + c[1]) * t + c[0]


def _factor(s, t, derivs: bool):
    """``S(t)`` of a ``(kind, k, phase)`` factor with ``S'`` and ``S''``;
    ``None`` for the factor 1."""
    kind, k, ph = s
    if kind == S_NONE:
        return None
    arg = k * t + ph
    kk = _f32_mul(k, k)
    if kind == S_SIN:
        v = torch.sin(arg)
        if not derivs:
            return v, None, None
        return v, k * torch.cos(arg), -kk * v
    v = torch.cos(arg)
    if not derivs:
        return v, None, None
    return v, -k * torch.sin(arg), -kk * v


class Terms(FieldSpec):
    """``background + sum_t P_t(x, y) exp(E_t) S1_t(x) S2_t(y)`` with
    ``E = (ax x + ay y) - g ((x - cx)^2 + (y - cy)^2)``.

    The polynomial is evaluated by Horner's rule in ``y`` for each power of
    ``x``, then in ``x``; ``value_grad_lap`` is the product rule, in the
    operation order ``csrc/walk_kernel.cu`` repeats (derivative
    coefficients ``3 a``, ``6 a`` and ``k^2`` are float32 products)."""

    kind = TERMS

    def __init__(self, background: float, terms_):
        self.background = _f32(background)
        self.terms = tuple(terms_)
        self.params = (self.background,) + sum(
            (t.row() for t in self.terms), ())

    def _term_value(self, t: Term, x, y):
        py = [_horner(t.poly[i], y) for i in range(4)]
        val = _horner(py, x)
        if t.has_exp:
            dx, dy = x - t.cx, y - t.cy
            val = val * torch.exp((t.ax * x + t.ay * y)
                                  - t.g * (dx * dx + dy * dy))
        for s, v in ((t.s1, x), (t.s2, y)):
            f = _factor(s, v, False)
            if f is not None:
                val = val * f[0]
        return val

    def __call__(self, x, y):
        total = self.background + 0.0 * x
        for t in self.terms:
            total = total + self._term_value(t, x, y)
        return total

    def _term_parts(self, t: Term, x, y):
        """``(T, Tx, Ty, lap T)`` of one term."""
        a = t.poly
        py = [_horner(a[i], y) for i in range(4)]
        P = _horner(py, x)
        Px = ((3.0 * py[3]) * x + 2.0 * py[2]) * x + py[1]
        Pxx = (6.0 * py[3]) * x + 2.0 * py[2]
        qy = [(_f32_mul(3.0, a[i][3]) * y + _f32_mul(2.0, a[i][2])) * y
              + a[i][1] for i in range(4)]
        ry = [_f32_mul(6.0, a[i][3]) * y + _f32_mul(2.0, a[i][2])
              for i in range(4)]
        Py = _horner(qy, x)
        lapA = Pxx + _horner(ry, x)
        A, Ax, Ay = P, Px, Py
        if t.has_exp:
            dx, dy = x - t.cx, y - t.cy
            G = torch.exp((t.ax * x + t.ay * y) - t.g * (dx * dx + dy * dy))
            g2 = _f32_mul(2.0, t.g)
            Ex = t.ax - g2 * dx
            Ey = t.ay - g2 * dy
            Gx, Gy = G * Ex, G * Ey
            lapG = G * ((Ex * Ex + Ey * Ey) - _f32_mul(4.0, t.g))
            A = P * G
            Ax = Px * G + P * Gx
            Ay = Py * G + P * Gy
            lapA = (lapA * G + 2.0 * (Px * Gx + Py * Gy)) + P * lapG
        val, tx, ty, lap = A, Ax, Ay, lapA
        f1 = _factor(t.s1, x, True)
        f2 = _factor(t.s2, y, True)
        if f1 is not None:
            b, db, d2b = f1
            val = val * b
            tx = tx * b + A * db
            ty = ty * b
            lap = (lap * b + (2.0 * Ax) * db) + A * d2b
            ay_b = Ay * b
        else:
            ay_b = Ay
        if f2 is not None:
            b, db, d2b = f2
            # A1 = A S1: its y-derivative is Ay S1, its value val
            a1 = A if f1 is None else A * f1[0]
            val = val * b
            tx = tx * b
            ty = ty * b + a1 * db
            lap = lap * b + ((2.0 * ay_b) * db + a1 * d2b)
        return val, tx, ty, lap

    def value_grad_lap(self, x, y):
        total = self.background + 0.0 * x
        gx = 0.0 * x
        gy = 0.0 * x
        lap = 0.0 * x
        for t in self.terms:
            v, tx, ty, tl = self._term_parts(t, x, y)
            total = total + v
            gx = gx + tx
            gy = gy + ty
            lap = lap + tl
        return total, gx, gy, lap


class Grid(FieldSpec):
    """The bilinear interpolant of ``u[ix, iy]`` on a uniform grid with
    first nodes ``(x0, y0)`` and spacings ``(dx, dy)``, in the float32
    operation order of the JAX package's ``grid_continuation``
    (``diagnostics/martingale.py:92-105``): the index coordinate
    ``(p - x0) / dx`` clipped to ``[0, n - 1.000001]`` (the bound rounded
    to float32, so for some ``n`` it is ``n - 1`` itself), truncated to an
    integer, and the four weighted corners summed in order; a corner past
    the last node reads the last node (JAX's gather clamps the index,
    and its weight is zero)."""

    kind = GRID

    def __init__(self, x0: float, dx: float, y0: float, dy: float, u):
        self.u = np.ascontiguousarray(np.asarray(u, np.float32))
        if self.u.ndim != 2 or min(self.u.shape) < 2:
            raise ValueError("a grid field needs a 2-D table of at least "
                             f"2 x 2 nodes, got shape {self.u.shape}")
        nx, ny = self.u.shape
        self.params = (_f32(x0), _f32(dx), _f32(y0), _f32(dy),
                       _f32(nx - 1.000001), _f32(ny - 1.000001),
                       float(nx), float(ny))
        self._tables = {}

    def table(self):
        """The kernel's parameters; the node values go by
        :meth:`device_table`."""
        return self.kind, self.params

    def device_table(self, device) -> torch.Tensor:
        """The node values as a contiguous float32 tensor on ``device``,
        copied there once."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(self.u).to(device)
        return self._tables[key]

    def __call__(self, x, y):
        x0, dx, y0, dy, hx, hy, nx, ny = self.params
        ny = int(ny)
        u = self.device_table(x.device).reshape(-1)
        # divide by a tensor: CUDA divides by a Python scalar as a multiply
        # by its reciprocal
        fx = torch.clamp((x - x0) / torch.full_like(x, dx), 0.0, hx)
        fy = torch.clamp((y - y0) / torch.full_like(y, dy), 0.0, hy)
        ix = fx.to(torch.int64)
        iy = fy.to(torch.int64)
        tx = fx - ix.to(fx.dtype)
        ty = fy - iy.to(fy.dtype)
        ix1 = torch.clamp(ix + 1, max=int(nx) - 1)
        iy1 = torch.clamp(iy + 1, max=ny - 1)
        return ((((1.0 - tx) * (1.0 - ty)) * u[ix * ny + iy]
                 + (tx * (1.0 - ty)) * u[ix1 * ny + iy])
                + ((1.0 - tx) * ty) * u[ix * ny + iy1]) \
            + (tx * ty) * u[ix1 * ny + iy1]

    def value_grad_lap(self, x, y):
        raise NotImplementedError(
            "a grid field has no derivatives: it may be the Dirichlet data "
            "(bc_dirichlet) only")


def _factor_spec(s):
    if s is None:
        return (S_NONE, 0.0, 0.0)
    kind, k, *ph = s
    code = {"sin": S_SIN, "cos": S_COS}[kind]
    return (code, _f32(k), _f32(ph[0] if ph else 0.0))


def term(coeffs=1.0, *, ax: float = 0.0, ay: float = 0.0, g: float = 0.0,
         center=(0.0, 0.0), sx=None, sy=None) -> Term:
    """One ``TERMS`` term. ``coeffs``: a number (a constant polynomial), a
    dict ``{(i, j): a}`` of ``a x^i y^j`` or a 4 x 4 nested sequence;
    ``sx``/``sy``: ``None`` or ``("sin" | "cos", k[, phase])``."""
    a = np.zeros((4, 4), np.float64)
    if isinstance(coeffs, dict):
        for (i, j), v in coeffs.items():
            a[i, j] += v
    elif np.ndim(coeffs) == 0:
        a[0, 0] = float(coeffs)
    else:
        a[:, :] = np.asarray(coeffs, np.float64)
    poly = tuple(tuple(_f32(v) for v in row) for row in a)
    return Term(poly, _f32(ax), _f32(ay), _f32(g), _f32(center[0]),
                _f32(center[1]), _factor_spec(sx), _factor_spec(sy))


def terms(background: float = 0.0, *terms_: Term) -> Terms:
    """``background + sum of terms`` (:func:`term`)."""
    return Terms(background, terms_)


def polynomial(coeffs) -> Terms:
    """A polynomial of degree <= 3 in each variable, ``{(i, j): a}``."""
    return Terms(0.0, [term(coeffs)])


def gaussian_bump(center, amplitude: float, width: float) -> Terms:
    """``amplitude exp(-|p - center|^2 / (2 width^2))`` (the JAX package's
    ``problems/fields.py:124-133``)."""
    return Terms(0.0, [term(amplitude, g=1.0 / (2.0 * width * width),
                            center=center)])


def smooth_circle(center, radius, sharpness: float = 100.0) -> BumpSum:
    """Sigmoid-smoothed circle indicator: 1 inside, 0 outside, with the
    regularized sdf ``sqrt(|x-c|^2 + w^2) - radius``,
    ``w = min(1/sharpness, radius/2)``."""
    w2 = float(min(1.0 / sharpness, radius / 2.0)) ** 2
    return BumpSum(0.0, [(1.0, float(center[0]), float(center[1]),
                          float(radius), float(sharpness), w2)])


def bump_sum(background: float, terms) -> BumpSum:
    """``background + sum amp * circle`` over ``(amp, smooth_circle)`` terms."""
    bumps = []
    for amp, circle in terms:
        if not (isinstance(circle, BumpSum) and circle.background == 0.0
                and len(circle.bumps) == 1 and circle.bumps[0][0] == 1.0):
            raise TypeError("bump_sum terms must be smooth_circle specs")
        bumps.append((float(amp),) + circle.bumps[0][1:])
    return BumpSum(background, bumps)


def constant(value: float) -> Constant:
    """Constant field (broadcasts against the coordinates)."""
    return Constant(value)


def gaussian_dipole(pos_electrode, neg_electrode, current: float = 1.0,
                    width: float = 0.5) -> Dipole:
    """Gaussian-regularized +/- current dipole source of total current
    ``current`` and width ``width``."""
    return Dipole(pos_electrode, neg_electrode, current, width)


class GaussianMixture(NamedTuple):
    """Isotropic Gaussian mixture used as a source importance density.

    Next-event estimation of near-point sources from the Green's-weighted
    density alone has heavy-tailed weights; sampling toward the source
    from this mixture and combining by the balance heuristic bounds them.
    Fields are float32 CPU tensors over the ``k`` components.
    """

    cx: torch.Tensor      # (k,)
    cy: torch.Tensor      # (k,)
    width: torch.Tensor   # (k,) Gaussian sigma
    weight: torch.Tensor  # (k,) normalized positive mixture weights

    @staticmethod
    def from_components(components) -> "GaussianMixture":
        """``components``: iterable of ``(center, width, weight)``; the
        weights become ``|a| / sum |a|`` in float32."""
        cx = np.asarray([c[0][0] for c in components], np.float32)
        cy = np.asarray([c[0][1] for c in components], np.float32)
        w = np.asarray([c[1] for c in components], np.float32)
        a = np.abs(np.asarray([c[2] for c in components], np.float32))
        a = a / a.sum()
        return GaussianMixture(*(torch.from_numpy(v) for v in (cx, cy, w, a)))

    def sample(self, u_sel, u1, u2):
        """One point per lane: the component by ``u_sel``, the offset by
        Box-Muller normals from ``(u1, u2)``."""
        dev = u_sel.device
        cum = torch.cumsum(self.weight, 0).to(dev)
        idx = (u_sel[..., None] > cum).sum(-1)
        idx = torch.clamp(idx, 0, self.weight.shape[0] - 1)
        rad = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
        ang = (2.0 * math.pi) * u2
        w = self.width.to(dev)[idx]
        x = self.cx.to(dev)[idx] + w * rad * torch.cos(ang)
        y = self.cy.to(dev)[idx] + w * rad * torch.sin(ang)
        return x, y

    def pdf(self, x, y):
        """Mixture density at ``(x, y)`` (2D normal components)."""
        dev = x.device
        dx = x[..., None] - self.cx.to(dev)
        dy = y[..., None] - self.cy.to(dev)
        w2 = self.width.to(dev) * self.width.to(dev)
        comp = torch.exp(-(dx * dx + dy * dy) / (2.0 * w2)) / (
            (2.0 * math.pi) * w2)
        return torch.sum(self.weight.to(dev) * comp, dim=-1)


def dipole_importance(pos_electrode, neg_electrode,
                      width: float) -> GaussianMixture:
    """Importance mixture matching a :func:`gaussian_dipole` source."""
    return GaussianMixture.from_components([
        (pos_electrode, width, 0.5),
        (neg_electrode, width, 0.5),
    ])


def is_spec(f) -> bool:
    return isinstance(f, FieldSpec)


def _alpha_parts(alpha: FieldSpec, x, y):
    """``alpha_c = max(alpha, 1e-8)`` with its gradient and Laplacian
    (zero where the clamp is active)."""
    a, gx, gy, lap = alpha.value_grad_lap(x, y)
    live = a > ALPHA_EPS
    return (torch.clamp(a, min=ALPHA_EPS), torch.where(live, gx, 0.0),
            torch.where(live, gy, 0.0), torch.where(live, lap, 0.0))


def grad_log_alpha_fn(alpha: FieldSpec):
    """``grad log(alpha_c + 1e-8)`` of a spec, hand-derived."""
    def grad_log_alpha(x, y):
        a, gx, gy, _ = _alpha_parts(alpha, x, y)
        la = a + ALPHA_EPS
        return gx / la, gy / la

    return grad_log_alpha


def sigma_prime_fn(alpha: FieldSpec, sigma: FieldSpec):
    """``sigma' = sigma/a + (lap a / a - |grad ln a|^2 / 2) / 2`` of specs,
    in the JAX package's operation order (``problem.py:168-172``)."""
    def sigma_prime(x, y):
        a, gx, gy, lap = _alpha_parts(alpha, x, y)
        la = a + ALPHA_EPS
        glx = gx / la
        gly = gy / la
        grad_norm2 = glx * glx + gly * gly
        return sigma(x, y) / a + 0.5 * (lap / a - grad_norm2 / 2.0)

    return sigma_prime
