"""Carry-over of boundary data, walker state and options from the JAX package.

The JAX package's ``Polyline`` fields and walker planes, taken with
``np.asarray``, become the port's tensors here (and back); its local
majorant, MIS importance mixture and Robin settings become the port's. The same inputs can then
be fed to both implementations. Nothing here imports the JAX package: the
objects are read by their attributes.
"""

import numpy as np
import torch

from .geometry.polyline import Polyline
from .problems.fields import GaussianMixture
from .problems.majorant import LocalMajorant
from .solver.state import plane_dtype

__all__ = ["polyline_from_numpy", "state_from_numpy", "state_to_numpy",
           "local_majorant_from", "gaussian_mixture_from",
           "robin_options_from"]

_ROBIN_FIELDS = ("robin_correction", "robin_interior", "robin_arrival_clamp")


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


def local_majorant_from(majorant):
    """The port's :class:`LocalMajorant` from the JAX package's (its
    ``boxes``, ``bands`` and ``sigma_bar_bg`` as Python floats); ``None``
    stays ``None``."""
    if majorant is None:
        return None
    return LocalMajorant(
        boxes=tuple(tuple(float(v) for v in b) for b in majorant.boxes),
        bands=tuple(tuple(float(v) for v in b) for b in majorant.bands),
        sigma_bar_bg=float(majorant.sigma_bar_bg))


def gaussian_mixture_from(mixture):
    """The port's :class:`GaussianMixture` from the JAX package's (its
    ``cx``, ``cy``, ``width`` and ``weight`` as float32 arrays, as they
    are); ``None`` stays ``None``."""
    if mixture is None:
        return None
    return GaussianMixture(*(torch.from_numpy(np.array(v, np.float32))
                             for v in (mixture.cx, mixture.cy, mixture.width,
                                       mixture.weight)))


def robin_options_from(options) -> dict:
    """The Robin settings of the JAX package's ``SolverOptions``, as keyword
    arguments of the port's ``SolverOptions``."""
    return {k: getattr(options, k) for k in _ROBIN_FIELDS}
