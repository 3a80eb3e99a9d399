"""Radial samplers for the 2D ball (port of ``sampling/radial.py``).

* :func:`sample_greens_radius` — ``r = R sqrt(u1 u2)``, exact for the
  Green's-weighted radial density ``r ln(R/r) / (R^2/4)``.
* :func:`_exact_rejection` — the two-regime rejection sampler of the
  screened radial density ``p(x) ∝ x [K0(x) - c I0(x)]`` with the
  importance-weighted final round that makes any round cap unbiased
  (``max_rounds == 1`` is pure importance sampling).
* :func:`sample_screened_radius_transport` — the loop-free alternative
  (``screened_sampler="transport"``): a fitted monotone transport map
  (``_transport_coeffs.py``) plus the exact importance weight.

The walk kernel (``csrc/walk_kernel.cu``) runs both samplers per thread;
the plain walk (``ops/walk_kernel.py``) calls these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bessel import i0e, k0e
from ..ops.greens import _one_minus_inv_i0_scaled

__all__ = ["sample_greens_radius", "greens_radial_pdf", "_exact_rejection",
           "sample_screened_radius_fast", "sample_screened_radius_exact",
           "sample_screened_radius_transport", "screened_radial_pdf"]


def sample_greens_radius(R, u1, u2):
    """Exact sample of the Green's-weighted radius in a ball of radius R."""
    return R * torch.sqrt(u1 * u2)


def greens_radial_pdf(r, R):
    """Normalized Green's radial density ``r ln(R/r) / (R^2/4)`` on
    ``(0, R)``, zero elsewhere."""
    r = torch.as_tensor(r, dtype=torch.float32)
    rc = torch.minimum(torch.clamp(r, min=1e-12),
                       torch.as_tensor(R, dtype=torch.float32))
    return torch.where((r > 0) & (r < R), rc * torch.log(R / rc)
                       / (R * R / 4.0), 0.0)


def sample_screened_radius_transport(draw, R, sigma_bar):
    """Screened radius by the fitted transport map plus its exact
    importance weight; returns ``(r, w)`` with ``E[w f(r)]`` exact.

    ``draw(0) -> (4, ...)`` uniforms (one call, the rejection's round-0
    streams). For ``z = R sqrt(sigma_bar) <= Z_SW`` the uniform is warped
    by ``v = sqrt(u) / (sqrt(u) + sqrt(1 - u))`` and mapped by the
    Chebyshev tensor ``s = S(v; z)``, whose proposal density
    ``m'(v) / S'(v)`` is exact; above ``Z_SW`` the free density ``x K0(x)``
    is drawn in closed form. The weight ``p(s; z) / q`` is zero past the
    ball. Operation order as ``sampling/radial.py:64-177`` of the JAX
    package: the coefficient rows ``row[0] + row[1] om`` then ``+ c_j
    T_j(om)`` for the nonzero ``c_j``, ``j = 2..12``, the T/U recurrences
    in ``2v - 1``.
    """
    from ._transport_coeffs import (
        A_RAT, COEFFS, OMEGA_R0, OMEGA_R1, Z_LO, Z_SW)

    R = torch.as_tensor(R, dtype=torch.float32)
    sb = torch.as_tensor(sigma_bar, dtype=torch.float32, device=R.device)
    z = torch.clamp(R * torch.sqrt(sb), min=1e-12)
    u4 = draw(0)
    u = torch.clamp(u4[0], 1e-7, 1.0 - 1e-7)

    # the map at z_eff = clip(z, Z_LO, Z_SW)
    z_eff = torch.clamp(z, Z_LO, Z_SW)
    om = (2.0 * ((z_eff - A_RAT) / (z_eff + A_RAT) - OMEGA_R0)
          / (OMEGA_R1 - OMEGA_R0) - 1.0)
    su = torch.sqrt(u)
    cu = torch.sqrt(1.0 - u)
    v = su / (su + cu)
    tv = 2.0 * v - 1.0
    tw_prev = torch.ones_like(om)
    tw_cur = om
    c = [row[0] + row[1] * om for row in COEFFS]
    for j in range(2, len(COEFFS[0])):
        tw_prev, tw_cur = tw_cur, 2.0 * om * tw_cur - tw_prev
        for i, row in enumerate(COEFFS):
            if row[j] != 0.0:
                c[i] = c[i] + row[j] * tw_cur
    # s = sum_i c_i T_i(tv), S'(v) = 2 sum_i c_i i U_{i-1}(tv)
    t_prev = torch.ones_like(tv)
    t_cur = tv
    u_prev = torch.ones_like(tv)
    u_cur = 2.0 * tv
    s_t = c[0] + c[1] * tv
    ds = c[1]
    for i in range(2, len(COEFFS)):
        t_prev, t_cur = t_cur, 2.0 * tv * t_cur - t_prev
        s_t = s_t + c[i] * t_cur
        ds = ds + (float(i) * c[i]) * u_cur
        u_prev, u_cur = u_cur, 2.0 * tv * u_cur - u_prev
    ds = 2.0 * ds
    w1 = v * v + (1.0 - v) * (1.0 - v)
    mp = 2.0 * v * (1.0 - v) / (w1 * w1)

    # the free density's exact draw (z > Z_SW)
    u1 = torch.clamp(u4[1], min=1e-7)
    u2 = torch.clamp(u4[2], min=1e-7)
    u0 = u4[3]
    x_f = -torch.log(u1 * u2) * torch.sqrt(
        torch.clamp(1.0 - u0 * u0, min=1e-12))
    use_f = z > Z_SW
    s_raw = torch.where(use_f, x_f / z, s_t)

    # the exact importance weight
    invalid = s_raw >= 1.0
    s = torch.clamp(s_raw, 1e-7, 1.0)
    x = z * s
    i0e_z = i0e(z)
    k0e_z = k0e(z)
    i0e_x = i0e(x)
    k0e_x = k0e(x)
    ratio = (k0e_z * i0e_x) / (i0e_z * k0e_x) * torch.exp(
        -2.0 * torch.clamp(z - x, min=0.0))
    one_m_ratio = torch.clamp(1.0 - ratio, min=0.0)
    norm = torch.clamp(_one_minus_inv_i0_scaled(z, i0e_z), min=1e-30)
    w_f = one_m_ratio / norm
    k0x = k0e_x * torch.exp(-x)
    p = z * z * s * k0x * one_m_ratio / norm
    w_t = p * ds / torch.clamp(mp, min=1e-30)
    w = torch.where(invalid, 0.0, torch.where(use_f, w_f, w_t))
    return s * R, w


def _exact_rejection(draw, R, sigma_bar, max_rounds: int,
                     with_weight: bool = False):
    """Two-regime rejection; ``draw(round) -> (4, ...) uniforms``.

    Small ``z = R sqrt(sigma_bar) < 2``: envelope ``-s ln s`` sampled as
    ``s = sqrt(U0 U1)``. Large z: the free density ``x K0(x)`` sampled as
    ``x = -ln(U1 U2) sqrt(1 - U0^2)``. ``with_weight`` returns ``(r, w)``:
    a lane still unaccepted entering round ``max_rounds-1`` takes that
    round's candidate with ``w = A(x)/a(z)`` (``a`` = the closed-form
    acceptance rate), so ``E[w f(r)]`` is exact for any cap. Lanes with
    ``z < 1e-3`` keep round 0's (unscreened) candidate at weight 1.
    """
    R = torch.as_tensor(R, dtype=torch.float32)
    sb = torch.as_tensor(sigma_bar, dtype=torch.float32, device=R.device)
    z = torch.clamp(R * torch.sqrt(sb), min=1e-12)
    small = z < 2.0
    k0e_z = k0e(z)
    i0e_z = i0e(z)

    def accept_prob(x, s):
        k0e_x = k0e(x)
        ratio = (k0e_z * i0e(x)) / (i0e_z * k0e_x) * torch.exp(
            -2.0 * torch.clamp(z - x, min=0.0))
        k0x = k0e_x * torch.exp(-x)
        num = k0x * (1.0 - ratio)
        ln_s = -torch.log(torch.clamp(s, 1e-12, 1.0 - 1e-7))
        p_small = torch.clamp(num / torch.clamp(ln_s, min=1e-12), 0.0, 1.0)
        p_large = torch.where(x <= z, torch.clamp(1.0 - ratio, 0.0, 1.0), 0.0)
        return torch.where(small, p_small, p_large)

    if with_weight:
        p_ii = _one_minus_inv_i0_scaled(z, i0e_z)
        a_rate = torch.clamp(torch.where(small, 4.0 * p_ii / (z * z), p_ii),
                             min=1e-12)

    def candidates(u):
        u0 = torch.clamp(u[0], min=1e-7)
        u1 = torch.clamp(u[1], min=1e-7)
        u2 = torch.clamp(u[2], min=1e-7)
        s_small = torch.sqrt(u0 * u1)
        x_small = z * s_small
        x_large = -torch.log(u1 * u2) * torch.sqrt(
            torch.clamp(1.0 - u0 * u0, min=1e-12))
        x = torch.where(small, x_small, x_large)
        s = torch.where(small, s_small, x_large / z)
        return x, s, u[3]

    x0, s0, ua0 = candidates(draw(0))
    s_round0 = s0
    A0 = accept_prob(x0, s0)
    if with_weight and max_rounds == 1:
        acc = torch.ones_like(s0, dtype=torch.bool)  # pure IS
        w = A0 / a_rate
    else:
        acc = ua0 < A0
        w = torch.ones_like(s0)
    s_cur = s0

    def body(i, s_cur, w_cur, accepted):
        # redraw round i uses stream round i + 1, as the reference loop does
        x, s, ua = candidates(draw(i + 1))
        A = accept_prob(x, s)
        if with_weight:
            is_final = i >= max_rounds - 1
            take = ~accepted & ((ua < A) | is_final)
            w_new = A / a_rate if is_final else torch.ones_like(A)
        else:
            take = ~accepted & (ua < A)
            w_new = torch.ones_like(A)
        return (torch.where(take, s, s_cur), torch.where(take, w_new, w_cur),
                accepted | take)

    i = 1
    if with_weight and 2 <= max_rounds <= 4:
        # static unroll for small caps: identical draws, no host sync
        for i in range(1, max_rounds):
            s_cur, w, acc = body(i, s_cur, w, acc)
    else:
        while i < max_rounds and not bool(acc.all()):
            s_cur, w, acc = body(i, s_cur, w, acc)
            i += 1
    tiny = z < 1e-3
    s_fin = torch.where(tiny, s_round0, s_cur)
    r_fin = torch.clamp(s_fin, 0.0, 1.0) * R
    if not with_weight:
        return r_fin
    return r_fin, torch.where(tiny, 1.0, w)


def sample_screened_radius_fast(seed, counter, R, sigma_bar,
                                max_rounds: int = 64):
    """Exact screened-radius sampling with the counter-hash RNG
    (``sampling/radial.py:316-337`` of the JAX package): the rejection of
    :func:`_exact_rejection` on uniforms drawn from ``(seed, counter)``,
    round ``k`` from the base ``mix32(seed ^ counter * 0xB5297A4D)`` xor
    ``k * 0x68E31DA4``. ``seed`` and ``counter`` are u32 integers, ``R``
    a float32 tensor of radii; returns the radii, shaped as ``R``."""
    from .rng import MASK32, counter_uniform, mix32

    R = torch.as_tensor(R, dtype=torch.float32)
    lanes = int(R.numel()) if R.dim() else 1
    base = int(mix32((int(seed) ^ int(counter) * 0xB5297A4D) & MASK32))

    def draw(round_idx):
        s = base ^ ((int(round_idx) * 0x68E31DA4) & MASK32)
        u = counter_uniform(s, 0, 4, lanes, device=R.device)
        return u.reshape((4,) + tuple(R.shape))

    return _exact_rejection(draw, R, sigma_bar, max_rounds)


def sample_screened_radius_exact(key, R, sigma_bar, max_rounds: int = 64):
    """Not ported: the JAX package draws it with ``jax.random`` (threefry
    keys); the port's walks use the counter hash
    (:func:`sample_screened_radius_fast`)."""
    raise NotImplementedError(
        "sample_screened_radius_exact draws with jax.random keys and is "
        "not ported (use sample_screened_radius_fast); reference: "
        "dcrmontecarlo_tpu/sampling/radial.py::sample_screened_radius_exact")


def screened_radial_pdf(r, R, sigma_bar):
    """Normalized screened radial density (numpy/scipy oracle for tests)."""
    from scipy.special import i0, k0

    r = np.asarray(r, np.float64)
    sq = np.sqrt(sigma_bar)
    c = k0(R * sq) / i0(R * sq)
    g = k0(r * sq) - c * i0(r * sq)
    dens = np.where((r > 0) & (r < R), r * g, 0.0)
    s = np.concatenate([
        np.geomspace(1e-7 * R, 1e-2 * R, 2048, endpoint=False),
        np.linspace(1e-2 * R, R, 8192),
    ])
    gs = k0(s * sq) - c * i0(s * sq)
    return dens / np.trapezoid(s * gs, s)
