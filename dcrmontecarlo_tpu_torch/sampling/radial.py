"""Radial samplers for the 2D ball (port of ``sampling/radial.py``).

* :func:`sample_greens_radius` — ``r = R sqrt(u1 u2)``, exact for the
  Green's-weighted radial density ``r ln(R/r) / (R^2/4)``.
* :func:`_exact_rejection` — the two-regime rejection sampler of the
  screened radial density ``p(x) ∝ x [K0(x) - c I0(x)]`` with the
  importance-weighted final round that makes any round cap unbiased
  (``max_rounds == 1`` is pure importance sampling).

The walk kernel (``csrc/walk_kernel.cu``) runs the same rejection per
thread; the plain walk (``ops/walk_kernel.py``) calls this function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bessel import i0e, k0e
from ..ops.greens import _one_minus_inv_i0_scaled

__all__ = ["sample_greens_radius", "_exact_rejection", "screened_radial_pdf"]


def sample_greens_radius(R, u1, u2):
    """Exact sample of the Green's-weighted radius in a ball of radius R."""
    return R * torch.sqrt(u1 * u2)


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
