"""Batched polyline queries on torch tensors.

Port of ``dcrmontecarlo_tpu/geometry/queries.py``: walker-batched
``(W,)`` coordinates against the ``(S,)`` segment axis as one ``(W, S)``
broadcast, reduced by a first-minimum ``argmin`` (the reference's
variadic min-reduce). Same arithmetic: divide (not reciprocal-multiply)
for the projection and the ray parameters, ``1e-30`` guards, and the
inclusive ``t >= t_min`` self-hit test.
"""

import numpy as np
import torch

from .polyline import Polyline

__all__ = ["cross2", "distance", "closest_point", "closest_point_chord",
           "is_silhouette", "silhouette_distance", "ray_intersection",
           "first_hit"]

_BIG = float(np.float32(3.0e38))


def cross2(ax, ay, bx, by):
    """2D cross product ``a x b``."""
    return ax * by - ay * bx


def _seg_fields(poly: Polyline, device):
    a = poly.seg_a.to(device)
    b = poly.seg_b.to(device)
    return (a[:, 0][None, :], a[:, 1][None, :], b[:, 0][None, :],
            b[:, 1][None, :], poly.seg_valid.to(device)[None, :])


def _min_by(key, payloads):
    """``(min key, payloads at the first minimum)`` along axis 1."""
    idx = torch.argmin(key, dim=1, keepdim=True)
    out = [torch.gather(key, 1, idx)[:, 0]]
    for p in payloads:
        out.append(torch.gather(p.expand_as(key), 1, idx)[:, 0])
    return out


def _project(poly: Polyline, px, py):
    """Per-segment clamped projection: foot points and squared distances
    (invalid segments at ``_BIG``)."""
    ax, ay, bx, by, valid = _seg_fields(poly, px.device)
    pxe, pye = px[:, None], py[:, None]
    ux, uy = bx - ax, by - ay
    vx, vy = pxe - ax, pye - ay
    uu = ux * ux + uy * uy
    t = torch.clamp((vx * ux + vy * uy) / torch.clamp(uu, min=1e-30),
                    0.0, 1.0)
    cx = ax + t * ux
    cy = ay + t * uy
    ex, ey = cx - pxe, cy - pye
    d2 = ex * ex + ey * ey
    return cx, cy, torch.where(valid, d2, _BIG), (ux, uy, uu, t)


def closest_point(poly: Polyline, px, py):
    """Distance and closest point on the polyline: ``(dist, cx, cy)``."""
    cx, cy, d2, _ = _project(poly, px, py)
    d2m, cxm, cym = _min_by(d2, (cx, cy))
    return torch.sqrt(d2m), cxm, cym


def distance(poly: Polyline, px, py):
    """Minimum distance to the polyline."""
    _, _, d2, _ = _project(poly, px, py)
    return torch.sqrt(torch.min(d2, dim=1).values)


def closest_point_chord(poly: Polyline, px, py):
    """Closest point plus the exact segment frame of the winning segment.

    Returns ``(dist, cx, cy, tx, ty, s_lo, s_hi)``: unit tangent and the
    chord interval ``[s_lo, s_hi]`` keeping ``foot + s t_hat`` on the
    segment (used by boundary snap for the start normal).
    """
    cx, cy, d2, (ux, uy, uu, t) = _project(poly, px, py)
    ul = torch.sqrt(torch.clamp(uu, min=1e-30))
    d2m, cxm, cym, txm, tym, slom, shim = _min_by(
        d2, (cx, cy, ux / ul, uy / ul, -t * ul, (1.0 - t) * ul))
    return torch.sqrt(d2m), cxm, cym, txm, tym, slom, shim


def is_silhouette(poly: Polyline, px, py):
    """``(W, V)`` mask: interior vertex ``b`` (neighbours ``a``, ``c``) is a
    silhouette seen from ``p`` iff ``cross(ab, ap) * cross(bc, bp) < 0``."""
    abc = poly.vert_abc.to(px.device)
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    abx = (b[:, 0] - a[:, 0])[None, :]
    aby = (b[:, 1] - a[:, 1])[None, :]
    bcx = (c[:, 0] - b[:, 0])[None, :]
    bcy = (c[:, 1] - b[:, 1])[None, :]
    apx = px[:, None] - a[:, 0][None, :]
    apy = py[:, None] - a[:, 1][None, :]
    bpx = px[:, None] - b[:, 0][None, :]
    bpy = py[:, None] - b[:, 1][None, :]
    s = cross2(abx, aby, apx, apy) * cross2(bcx, bcy, bpx, bpy)
    return (s < 0) & poly.vert_valid.to(px.device)[None, :]


def silhouette_distance(poly: Polyline, px, py):
    """Distance to the closest silhouette vertex, ``+inf`` if none (an
    open two-point chain has no interior vertex)."""
    mask = is_silhouette(poly, px, py)
    b = poly.vert_abc[:, 1].to(px.device)
    dx = b[:, 0][None, :] - px[:, None]
    dy = b[:, 1][None, :] - py[:, None]
    d2 = torch.where(mask, dx * dx + dy * dy, torch.inf)
    return torch.sqrt(torch.min(d2, dim=1).values)


def _ray_params(poly: Polyline, px, py, dx, dy, t_min):
    """Per-segment ray parameter ``t``, segment parameter ``s`` and
    validity (the inclusive ``t >= t_min`` test); ``t_min`` is a float or
    a per-walker ``(W,)`` tensor. Returns ``(t, s, ok, (ax, ay, ux, uy))``."""
    ax, ay, bx, by, valid = _seg_fields(poly, px.device)
    ux, uy = bx - ax, by - ay
    wx = px[:, None] - ax
    wy = py[:, None] - ay
    dxe, dye = dx[:, None], dy[:, None]
    den = cross2(dxe, dye, ux, uy)
    den_safe = torch.where(torch.abs(den) < 1e-30,
                           torch.full_like(den, 1e-30), den)
    t = cross2(ux, uy, wx, wy) / den_safe
    s = cross2(dxe, dye, wx, wy) / den_safe
    if isinstance(t_min, torch.Tensor):
        t_min = t_min[:, None]
    ok = (valid & (s >= 0.0) & (s <= 1.0) & (t >= t_min)
          & (torch.abs(den) > 1e-30))
    return t, s, ok, (ax, ay, ux, uy)


def ray_intersection(poly: Polyline, px, py, dx, dy, t_min=1e-6):
    """``(W, S)`` ray parameters of each segment's hit, ``+inf`` for
    misses."""
    t, _, ok, _ = _ray_params(poly, px, py, dx, dy, t_min)
    return torch.where(ok, t, torch.inf)


def first_hit(poly: Polyline, px, py, dx, dy, r, t_min=1e-6):
    """First ray/polyline intersection within distance ``r``.

    ``t_min`` is a float or a per-walker ``(W,)`` tensor. Returns
    ``(hx, hy, nx, ny, t_hit, hit)``: hit (or sphere) point, inward unit
    normal (zero when no hit), hit distance ``min(t, r)``, bool mask.
    """
    t, s, ok, (ax, ay, ux, uy) = _ray_params(poly, px, py, dx, dy, t_min)
    t = torch.where(ok, t, _BIG)
    ulen = torch.sqrt(torch.clamp(ux * ux + uy * uy, min=1e-30))
    t_best, nx, ny, hxs, hys = _min_by(
        t, (-uy / ulen, ux / ulen, ax + s * ux, ay + s * uy))
    hit = t_best <= r
    t_hit = torch.where(hit, t_best, r)
    hx = torch.where(hit, hxs, px + r * dx)
    hy = torch.where(hit, hys, py + r * dy)
    flip = (nx * dx + ny * dy) > 0.0
    nx = torch.where(flip, -nx, nx)
    ny = torch.where(flip, -ny, ny)
    nx = torch.where(hit, nx, 0.0)
    ny = torch.where(hit, ny, 0.0)
    return hx, hy, nx, ny, t_hit, hit
