"""Dense grid min/max scan of a scalar field.

Port of ``dcrmontecarlo_tpu/utils/gridscan.py``: one batched evaluation
of the whole grid, non-finite values masked out of the reduction.
"""

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["grid_min_max"]


def grid_min_max(
    f: Callable,
    bounds: Sequence[Tuple[float, float]],
    resolution: int = 100,
):
    """Min/max of an elementwise field over a rectangular 1-3D grid.

    Returns ``(min_val, max_val, min_pt, max_pt)`` as host floats / np
    arrays.
    """
    ndim = len(bounds)
    if ndim not in (1, 2, 3):
        raise ValueError(f"grid scan supports 1-3 dimensions, got {ndim}")
    axes = [torch.linspace(lo, hi, resolution, dtype=torch.float32)
            for lo, hi in bounds]
    grids = torch.meshgrid(*axes, indexing="ij")
    coords = [g.reshape(-1) for g in grids]
    vals = torch.as_tensor(f(*coords), dtype=torch.float32)
    vals = vals + torch.zeros_like(coords[0])
    finite = torch.isfinite(vals)
    if not bool(finite.any()):
        raise ValueError("field could not be evaluated at any grid point")
    big = 3e38
    imin = int(torch.argmin(torch.where(finite, vals, big)))
    imax = int(torch.argmax(torch.where(finite, vals, -big)))
    pts = np.stack([c.numpy() for c in coords], axis=1)
    return float(vals[imin]), float(vals[imax]), pts[imin], pts[imax]
