"""PDE problem definition (port of ``problems/problem.py``).

``-div(alpha grad u) + sigma u = f`` with a Dirichlet polyline and an
optional Neumann polyline. With a coefficient given, the delta-tracking
transform applies:

    ``sigma'(x) = sigma/alpha + (lap(alpha)/alpha - |grad ln alpha|^2 / 2) / 2``

When ``alpha`` and ``sigma`` are field specs (``problems/fields.py``),
``sigma'`` and ``grad ln alpha`` are the hand-derived expressions the walk
kernel also evaluates; other callables are differentiated with
``torch.func`` and run on the CPU path only. The majorant ``sigma_bar`` is
the same grid scan plus subgrid extrema refinement as the JAX package's;
``local_majorant="auto"`` derives the two-level majorant
(``problems/majorant.py``) from that scan.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..geometry.polyline import Polyline
from ..utils.autodiff import gradient, laplacian
from ..utils.gridscan import grid_min_max
from . import fields
from .majorant import LocalMajorant, derive_local_majorant

__all__ = ["Problem"]

_ALPHA_EPS = fields.ALPHA_EPS


@dataclass
class Problem:
    """Static problem description; the solver reads it at solve time."""

    dirichlet: Polyline
    neumann: Optional[Polyline] = None
    bc_dirichlet: Callable = field(default=None)  # g(x, y)
    source: Optional[Callable] = None             # f(x, y) or a list
    alpha: Optional[Callable] = None              # diffusion coefficient
    sigma: Optional[Callable] = None              # absorption coefficient
    source_importance: Optional[object] = None    # fields.GaussianMixture
                                                  # (MIS next-event est.)
    sigma_bar_resolution: int = 128               # base grid scan res.
    sigma_bar_override: Optional[float] = None    # skip the grid scan
    local_majorant: object = None                 # None | "auto" |
                                                  # majorant.LocalMajorant

    version: int = field(init=False, default=0)
    use_delta_tracking: bool = field(init=False, default=False)
    alpha_c: Optional[Callable] = field(init=False, default=None)
    sigma_prime: Optional[Callable] = field(init=False, default=None)
    grad_log_alpha: Optional[Callable] = field(init=False, default=None)
    sigma_bar: Optional[float] = field(init=False, default=None)
    domain_bounds: tuple = field(init=False, default=None)

    def __post_init__(self):
        if not (self.local_majorant is None or self.local_majorant == "auto"
                or isinstance(self.local_majorant, LocalMajorant)):
            raise ValueError("local_majorant must be None, 'auto' or a "
                             f"LocalMajorant; got {self.local_majorant!r}")
        if self.bc_dirichlet is None:
            self.bc_dirichlet = fields.constant(0.0)  # zero Dirichlet BC

        (dx0, dx1), (dy0, dy1) = self.dirichlet.bounds()
        if self.neumann is not None:
            (nx0, nx1), (ny0, ny1) = self.neumann.bounds()
            bounds = ((min(dx0, nx0), max(dx1, nx1)),
                      (min(dy0, ny0), max(dy1, ny1)))
        else:
            bounds = ((dx0, dx1), (dy0, dy1))
        self.domain_bounds = bounds

        if self.neumann is None:
            n_open = self._open_endpoints(self.dirichlet)
            if n_open:
                warnings.warn(
                    f"Dirichlet boundary has {n_open} open endpoint(s) and "
                    "there is no Neumann boundary: walkers can escape the "
                    "domain. Close the polyline (from_points does not) or "
                    "add the missing walls.")

        if self.alpha is None and self.sigma is None:
            self.local_majorant = None  # meaningless without delta tracking
            return
        self.alpha = self.alpha if self.alpha is not None else fields.constant(1.0)
        self.sigma = self.sigma if self.sigma is not None else fields.constant(0.0)
        self.use_delta_tracking = True
        alpha = self.alpha

        def alpha_c(x, y):
            return torch.clamp(alpha(x, y), min=_ALPHA_EPS)

        self.alpha_c = alpha_c
        if fields.is_spec(self.alpha) and fields.is_spec(self.sigma):
            self.grad_log_alpha = fields.grad_log_alpha_fn(self.alpha)
            self.sigma_prime = fields.sigma_prime_fn(self.alpha, self.sigma)
        else:
            self.grad_log_alpha, self.sigma_prime = self._autodiff_fields()

        if self.sigma_bar_override is not None:
            self.sigma_bar = max(float(self.sigma_bar_override), 1e-6)
            if self.local_majorant == "auto":
                v = self._sigma_prime_grid()  # the override skipped the scan
                _, _, refined_pts = self._refine_sigma_extrema(v)
                self._derive_majorant(v, refined_pts)
            return
        a_mn, _, _, _ = grid_min_max(alpha_c, bounds, self.sigma_bar_resolution)
        if a_mn <= 2.0 * _ALPHA_EPS:
            warnings.warn(
                f"alpha reaches {a_mn:.3g} (<= 0 before clamping) on the "
                "domain; the sqrt-alpha transform needs a strictly positive "
                "coefficient — expect exploding sigma' and meaningless "
                "walks. Check the field definition.")
        v = self._sigma_prime_grid()
        finite = v[np.isfinite(v)]
        if finite.size == 0:
            raise ValueError("sigma' could not be evaluated at any grid point")
        if finite.size < v.size:
            warnings.warn(
                f"sigma' is non-finite at {v.size - finite.size}/{v.size} "
                "grid points; the global majorant is priced from the finite "
                "cells only. Smooth the coefficient field or set "
                "sigma_bar_override.")
        mn, mx, refined_pts = self._refine_sigma_extrema(v)
        sb = (max(mx, 0.0) - mn) if mn < 0 else mx
        if sb <= 1e-12:
            sb = 1e-6  # unscreened limit: pure WoSt
        if sb > 1e3:
            warnings.warn(
                f"sigma' majorant {sb:.3g} is extreme; delta-tracking walks "
                "will take O(sigma_bar * L^2) steps. Smooth the coefficient "
                "field or set sigma_bar_override.")
        self.sigma_bar = float(sb)
        if self.local_majorant == "auto":
            self._derive_majorant(v, refined_pts)

    def _derive_majorant(self, v, refined_pts):
        """Resolve ``local_majorant="auto"`` from the scan grid ``v`` and
        the extrema-refinement samples (None when localizing cannot
        help)."""
        xs, ys = self._grid_axes()
        self.local_majorant = derive_local_majorant(
            v, xs, ys, self.sigma_bar, extra_points=refined_pts)

    def _autodiff_fields(self):
        """``grad ln alpha_c`` and ``sigma'`` of arbitrary callables through
        ``torch.func`` (CPU path)."""
        alpha_c, sigma = self.alpha_c, self.sigma

        def log_alpha(x, y):
            return torch.log(alpha_c(x, y) + _ALPHA_EPS)

        lap_alpha = laplacian(alpha_c)
        grad_log_alpha = gradient(log_alpha)

        def sigma_prime(x, y):
            a = alpha_c(x, y)
            gx, gy = grad_log_alpha(x, y)
            grad_norm2 = gx * gx + gy * gy
            return sigma(x, y) / a + 0.5 * (lap_alpha(x, y) / a
                                            - grad_norm2 / 2.0)

        return grad_log_alpha, sigma_prime

    @staticmethod
    def _open_endpoints(poly) -> int:
        """Count boundary endpoints used by exactly one segment."""
        seg = poly.valid_segments()
        if len(seg) == 0:
            return 0
        pts = np.concatenate([seg[:, :2], seg[:, 2:]])
        span = max(float(np.ptp(pts[:, 0])), float(np.ptp(pts[:, 1])), 1e-30)
        key = np.round(pts / (1e-6 * span)).astype(np.int64)
        _, counts = np.unique(key, axis=0, return_counts=True)
        return int((counts == 1).sum())

    def _grid_axes(self):
        (x0, x1), (y0, y1) = self.domain_bounds
        n = self.sigma_bar_resolution
        return np.linspace(x0, x1, n), np.linspace(y0, y1, n)

    def _eval_sigma_prime(self, qx, qy) -> np.ndarray:
        v = self.sigma_prime(torch.as_tensor(qx, dtype=torch.float32),
                             torch.as_tensor(qy, dtype=torch.float32))
        return v.detach().numpy()

    def _sigma_prime_grid(self) -> np.ndarray:
        """``sigma'`` on the scan grid (one batched evaluation)."""
        xs, ys = self._grid_axes()
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        return self._eval_sigma_prime(X.ravel(), Y.ravel()).reshape(
            len(xs), len(ys))

    def _refine_sigma_extrema(self, v, rounds: int = 2, sub: int = 9,
                              top_k: int = 64):
        """Subgrid-refine the ``sigma'`` extrema of the base scan: each
        round rescans a ``sub x sub`` neighbourhood of the ``top_k``
        largest and smallest points at finer spacing. Returns
        ``(mn, mx, (qx, qy, qv))``."""
        xs, ys = self._grid_axes()
        (x0, x1), (y0, y1) = self.domain_bounds
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        px, py = X.ravel(), Y.ravel()
        vals = np.where(np.isfinite(v), v, np.nan).ravel()
        mn, mx = float(np.nanmin(vals)), float(np.nanmax(vals))
        hx = float(xs[1] - xs[0]) if len(xs) > 1 else 0.0
        hy = float(ys[1] - ys[0]) if len(ys) > 1 else 0.0
        all_qx, all_qy, all_qv = [], [], []
        for _ in range(rounds):
            if not (hx > 0 or hy > 0):
                break
            order = np.argsort(vals)  # NaNs sort last
            n_fin = int(np.isfinite(vals).sum())
            if n_fin == 0:
                break
            lo = order[: min(top_k, n_fin)]
            hi = order[max(0, n_fin - top_k): n_fin]
            idx = np.unique(np.concatenate([lo, hi]))
            offs = np.linspace(-1.0, 1.0, sub)
            ox, oy = np.meshgrid(offs * hx, offs * hy, indexing="ij")
            qx = np.clip((px[idx, None] + ox.ravel()[None, :]).ravel(), x0, x1)
            qy = np.clip((py[idx, None] + oy.ravel()[None, :]).ravel(), y0, y1)
            qv = self._eval_sigma_prime(qx, qy)
            keep = np.isfinite(qv)
            if keep.any():
                mn = min(mn, float(qv[keep].min()))
                mx = max(mx, float(qv[keep].max()))
            all_qx.append(qx)
            all_qy.append(qy)
            all_qv.append(qv)
            px, py = qx, qy
            vals = np.where(keep, qv, np.nan)
            hx = 2.0 * hx / (sub - 1)
            hy = 2.0 * hy / (sub - 1)
        if all_qx:
            pts = (np.concatenate(all_qx), np.concatenate(all_qy),
                   np.concatenate(all_qv))
        else:
            pts = (np.empty(0), np.empty(0), np.empty(0))
        return mn, mx, pts

    def max_boundary_gamma(self, samples_per_segment: int = 8) -> float:
        """Max ``|gamma| = |d(ln sqrt alpha)/dn|`` probed along the Neumann
        boundary (decides ``robin_correction="auto"``)."""
        if self.neumann is None or self.grad_log_alpha is None:
            return 0.0
        seg = self.neumann.valid_segments()
        if len(seg) == 0:
            return 0.0
        a, b = seg[:, :2], seg[:, 2:]
        t = np.linspace(0.05, 0.95, samples_per_segment)
        pts = a[:, None, :] + t[None, :, None] * (b - a)[:, None, :]
        u = b - a
        ln = np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-30)
        nrm = np.stack([-u[:, 1], u[:, 0]], axis=1) / ln
        gx, gy = self.grad_log_alpha(
            torch.as_tensor(pts[..., 0].ravel(), dtype=torch.float32),
            torch.as_tensor(pts[..., 1].ravel(), dtype=torch.float32))
        gx = gx.detach().numpy().reshape(len(a), -1)
        gy = gy.detach().numpy().reshape(len(a), -1)
        gamma = 0.5 * np.abs(nrm[:, 0:1] * gx + nrm[:, 1:2] * gy)
        gamma = gamma[np.isfinite(gamma)]
        return float(gamma.max()) if gamma.size else 0.0

    @property
    def source_fields(self) -> list:
        """Normalized list of source fields (one walker ensemble serves
        every source)."""
        if self.source is None:
            return []
        if isinstance(self.source, (list, tuple)):
            return list(self.source)
        return [self.source]

    @property
    def diameter(self) -> float:
        (x0, x1), (y0, y1) = self.domain_bounds
        return float(np.sqrt(float(x1 - x0) ** 2 + float(y1 - y0) ** 2))

    def set_boundary_conditions(self, bc: Callable) -> None:
        """Replace the Dirichlet BC (bumps ``version``)."""
        self.bc_dirichlet = bc
        self.version += 1

    def set_source_term(self, source: Callable) -> None:
        """Replace the source term (bumps ``version``)."""
        self.source = source
        self.version += 1

    def set_source_importance(self, importance) -> None:
        """Replace the MIS importance mixture (bumps ``version``)."""
        self.source_importance = importance
        self.version += 1
