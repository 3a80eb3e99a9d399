"""Two-level local delta-tracking majorant (port of ``problems/majorant.py``).

The global majorant ``Problem.sigma_bar`` prices every ball at the worst
``sigma'`` anywhere. The two-level majorant confines the high-``sigma'``
load inside a few axis-aligned boxes and full-width horizontal bands, with
a small ``sigma_bar_bg`` valid outside them. Each step chooses, from the
walker position alone, between the full star radius at the global
majorant and a radius shrunk to the distance to the regions at the
background majorant, whichever promises more progress
``min(radius, 1/sqrt(sigma_bar))``. Both are valid delta-tracking
realizations for their ball, so the estimator stays unbiased.

:func:`derive_local_majorant` builds the regions from the same ``sigma'``
grid scan that prices the global majorant, in numpy and scipy exactly as
the JAX package does. The walk kernel (``csrc/walk_kernel.cu``) holds the
regions in a table of at most ``MAX_BOXES`` boxes and ``MAX_BANDS`` bands.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["LocalMajorant", "derive_local_majorant", "MAX_BOXES",
           "MAX_BANDS"]

MAX_BOXES = 8   # kernel table capacity (csrc/walk_kernel.cu)
MAX_BANDS = 8


@dataclass(frozen=True)
class LocalMajorant:
    """High-``sigma'`` containment regions plus the background majorant.

    ``boxes``: ``((x0, x1, y0, y1), ...)``; ``bands``: ``((y_lo, y_hi),
    ...)`` full-width horizontal bands, one per layer; ``sigma_bar_bg``:
    the majorant valid at every point outside all regions.
    """

    boxes: Tuple = ()
    bands: Tuple = ()
    sigma_bar_bg: float = 0.0

    def distance(self, x, y):
        """Distance from ``(x, y)`` to the nearest region (0 inside), in
        float32 with the region bounds rounded to float32."""
        x = torch.as_tensor(x, dtype=torch.float32)
        y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
        d = torch.full_like(x, 3e38)
        for (x0, x1, y0, y1) in self.boxes:
            dx = torch.clamp(torch.maximum(_f32(x0) - x, x - _f32(x1)),
                             min=0.0)
            dy = torch.clamp(torch.maximum(_f32(y0) - y, y - _f32(y1)),
                             min=0.0)
            d = torch.minimum(d, torch.sqrt(dx * dx + dy * dy))
        for (y_lo, y_hi) in self.bands:
            d = torch.minimum(d, torch.maximum(_f32(y_lo) - y,
                                               y - _f32(y_hi)))
        return torch.clamp(d, min=0.0)

    def table(self):
        """``(boxes (B, 4), bands (N, 2))`` float32 arrays for the kernel."""
        return (np.asarray(self.boxes, np.float32).reshape(-1, 4),
                np.asarray(self.bands, np.float32).reshape(-1, 2))


def _f32(v):
    return float(np.float32(v))


def derive_local_majorant(
    values: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    global_sigma_bar: float,
    max_boxes: int = 8,
    margin_cells: float = 1.5,
    band_width_frac: float = 0.85,
    extra_points=None,
) -> Optional[LocalMajorant]:
    """Containment regions from a ``sigma'`` grid scan.

    ``values``: ``(nx, ny)`` grid of ``sigma'`` (non-finite entries count
    as maximal load); ``xs, ys``: grid coordinates; ``global_sigma_bar``:
    the priced global majorant; ``extra_points``: optional off-grid
    ``(qx, qy, qv)`` samples (the extrema refinement), whose values
    outside the regions also price the background majorant.

    Returns ``None`` when localization cannot help: the load is spread
    over most of the domain, or the background is not below half the
    global majorant.
    """
    import scipy.ndimage as ndi

    v = np.asarray(values, np.float64)
    bad = ~np.isfinite(v)
    load = np.abs(np.where(bad, 0.0, v))
    vmax = load.max()
    if not (vmax > 0):
        return None
    dx = abs(xs[1] - xs[0])
    dy = abs(ys[1] - ys[0])
    width = xs[-1] - xs[0]
    mx = margin_cells * dx
    my = margin_cells * dy

    # cells above a few percent of the peak load, plus every non-finite one
    mask = (load > 0.02 * vmax) | bad
    if mask.mean() > 0.5:
        return None

    labels, n_comp = ndi.label(mask)
    boxes, bands = [], []
    for i in range(1, n_comp + 1):
        cells = np.argwhere(labels == i)
        x_cells = xs[cells[:, 0]]
        y_cells = ys[cells[:, 1]]
        if (x_cells.max() - x_cells.min()) > band_width_frac * width:
            bands.append((y_cells.min() - my, y_cells.max() + my))
            continue
        boxes.append((float(x_cells.min() - mx), float(x_cells.max() + mx),
                      float(y_cells.min() - my), float(y_cells.max() + my)))
    if len(boxes) > max_boxes:
        # one bounding box of every contained cell
        cells = np.argwhere(mask)
        x_cells, y_cells = xs[cells[:, 0]], ys[cells[:, 1]]
        boxes = [(float(x_cells.min() - mx), float(x_cells.max() + mx),
                  float(y_cells.min() - my), float(y_cells.max() + my))]
    out = ~mask
    if not out.any():
        return None
    v_out = v[out]
    bg_mx = float(v_out.max())
    bg_mn = float(v_out.min())
    if extra_points is not None and len(extra_points[0]):
        qx = np.asarray(extra_points[0], np.float64)
        qy = np.asarray(extra_points[1], np.float64)
        qv = np.asarray(extra_points[2], np.float64)
        outside = np.isfinite(qv)
        for (x0, x1, y0, y1) in boxes:
            outside &= ~((qx >= x0) & (qx <= x1) & (qy >= y0) & (qy <= y1))
        for (y_lo, y_hi) in bands:
            outside &= ~((qy >= y_lo) & (qy <= y_hi))
        if outside.any():
            bg_mx = max(bg_mx, float(qv[outside].max()))
            bg_mn = min(bg_mn, float(qv[outside].min()))
    sb_bg = max(bg_mx - min(bg_mn, 0.0), 0.0)
    if sb_bg > 0.5 * global_sigma_bar:
        return None
    return LocalMajorant(
        boxes=tuple(boxes),
        bands=tuple((float(b[0]), float(b[1])) for b in bands),
        sigma_bar_bg=sb_bg,
    )
