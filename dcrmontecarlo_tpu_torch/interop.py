"""Carry-over of boundary data and walker state from numpy arrays.

The JAX package's ``Polyline`` fields and walker planes, taken with
``np.asarray``, become the port's tensors here (and back), so the same
inputs can be fed to both implementations.
"""

import numpy as np
import torch

from .geometry.polyline import Polyline
from .solver.state import plane_dtype

__all__ = ["polyline_from_numpy", "state_from_numpy", "state_to_numpy"]


def polyline_from_numpy(seg_a, seg_b, seg_valid, vert_abc, vert_valid,
                        points) -> Polyline:
    """A :class:`Polyline` from the six SoA arrays, as they are."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    return Polyline(
        seg_a=f32(seg_a), seg_b=f32(seg_b),
        seg_valid=torch.from_numpy(np.array(seg_valid, bool)),
        vert_abc=f32(vert_abc),
        vert_valid=torch.from_numpy(np.array(vert_valid, bool)),
        points=f32(points),
    )


def state_from_numpy(planes: dict, device="cpu") -> dict:
    """Walker planes (name -> array) as tensors of the kernel's dtypes."""
    out = {}
    for name, arr in planes.items():
        dt = plane_dtype(name)
        np_dt = np.int32 if dt == torch.int32 else np.float32
        out[name] = torch.from_numpy(np.array(arr, np_dt)).to(device)
    return out


def state_to_numpy(state: dict) -> dict:
    """Walker planes as numpy arrays on the host."""
    return {name: t.detach().cpu().numpy() for name, t in state.items()}
