"""Green's functions for the 2D ball on torch tensors.

Port of ``dcrmontecarlo_tpu/ops/greens.py`` (same definitions, same
cancellation-safe ``1 - 1/I0`` branch, and the Robin wall ratio and chord
integral with both branches of their selects). ``R`` and ``sigma_bar``
may be tensors or python floats; results are float32 tensors.
"""

import math

import torch

from .bessel import (
    _ii0_over_z_series,
    _ik0_reg_over_z_series,
    _k0_reg_over_z2_series,
    i0,
    i0e,
    i1e,
    ii0e,
    ik0,
    k0,
    k0e,
    k1e,
)

__all__ = [
    "greens_2d",
    "greens_norm_2d",
    "screened_greens_2d",
    "screened_greens_norm_2d",
    "screened_interior_prob",
    "screened_greens_wall_ratio",
    "screened_chord_integral",
]

_TWO_PI = 2.0 * math.pi


def _f32(v, like=None):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(v, dtype=torch.float32, device=device)


def greens_2d(r, R):
    """Ball Green's function ``ln(R/r)/(2 pi)`` (zero on the sphere)."""
    rc = torch.clamp(_f32(r), min=1e-12)
    return torch.log(_f32(R, rc) / rc) / _TWO_PI


def greens_norm_2d(R):
    """Disk integral of ``greens_2d``: ``R^2/4``."""
    R = _f32(R)
    return R * R / 4.0


def screened_greens_2d(r, R, sigma_bar):
    """Screened (Yukawa) ball Green's function at distance ``r``."""
    r = _f32(r)
    s = torch.sqrt(_f32(sigma_bar, r))
    z = _f32(R, r) * s
    rz = torch.clamp(r, min=1e-12) * s
    return (k0(rz) - (k0(z) / i0(z)) * i0(rz)) / _TWO_PI


def _one_minus_inv_i0_scaled(z, i0e_z):
    """``1 - 1/I0(z)`` given a precomputed ``i0e(z)`` (cancellation-safe:
    the series ``s/(1+s)``, ``s = t + t^2/4 + t^3/36``, ``t = z^2/4``,
    below z = 0.25)."""
    t = z * z * 0.25
    s = t * (1.0 + t * (0.25 + t / 36.0))
    small = s / (1.0 + s)
    large = 1.0 - torch.exp(-z) / torch.clamp(i0e_z, min=1e-30)
    return torch.where(z < 0.25, small, large)


def _one_minus_inv_i0(z):
    """``1 - 1/I0(z)`` without catastrophic cancellation."""
    return _one_minus_inv_i0_scaled(z, i0e(z))


def screened_greens_norm_2d(R, sigma_bar):
    """Disk integral of the screened Green's function,
    ``(1 - 1/I0(R sqrt(sigma_bar))) / sigma_bar``."""
    R = _f32(R)
    sb = _f32(sigma_bar, R)
    z = R * torch.sqrt(sb)
    return _one_minus_inv_i0(z) / sb


def screened_interior_prob(R, sigma_bar):
    """Delta-tracking interior-event probability ``1 - 1/I0(R sqrt(sb))``."""
    R = _f32(R)
    z = R * torch.sqrt(_f32(sigma_bar, R))
    return _one_minus_inv_i0(z)


def screened_greens_wall_ratio(d, R, sigma_bar):
    """``G_s(d) / |dG_s/dd(d)|``, the radial kernel ratio of the Robin
    wall-arrival weight ``1 + gamma * ratio / cos(phi)``, from scaled
    Bessels (the ``e^{-z d}`` factors cancel; the reflection term carries
    ``e^{2 q (d - R)} <= 1``)."""
    d = _f32(d)
    q = torch.sqrt(_f32(sigma_bar, d))
    zd = torch.clamp(d, min=1e-12) * q
    zr = _f32(R, d) * q
    ratio_c = (k0e(zr) / i0e(zr)) * torch.exp(
        2.0 * torch.clamp(zd - zr, max=0.0))
    num = k0e(zd) - ratio_c * i0e(zd)
    den = q * (k1e(zd) + ratio_c * i1e(zd))
    return torch.clamp(num, min=0.0) / torch.clamp(den, min=1e-30)


def screened_chord_integral(r, sigma_bar):
    """``J(r) = int_0^r G_s(t) dt`` along a ray through the ball centre;
    the Robin chord mass is ``c = 4 gamma J``.

    ``z = r sqrt(sigma_bar) <= 2``: the series form, whose ``ln(z/2)``
    pieces cancel algebraically, so ``J -> r / 2 pi`` as ``sigma_bar -> 0``
    with no division by ``sqrt(sigma_bar)``. Larger ``z``: scaled Bessel
    integrals, with ``K0(z)/I0(z) int I0`` formed from scaled forms.
    """
    r = _f32(r)
    q = torch.sqrt(torch.clamp(_f32(sigma_bar, r), min=0.0))
    z = r * q
    zs = torch.clamp(z, max=2.0)
    z2 = zs * zs
    small = (_ik0_reg_over_z_series(z2)
             - z2 * _k0_reg_over_z2_series(z2) * _ii0_over_z_series(z2)
             / i0(zs)) * (r / _TWO_PI)
    zl = torch.clamp(z, min=2.0)
    cross = k0e(zl) * ii0e(zl) * torch.exp(-zl) / i0e(zl)
    large = (ik0(zl) - cross) / (_TWO_PI * torch.clamp(q, min=1e-30))
    return torch.where(z <= 2.0, small, large)
