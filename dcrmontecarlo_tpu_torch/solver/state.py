"""Walker plane layout for the fused walk (``ops/walk_kernel.py``).

Every walker slot is one lane of a set of ``(rows, 128)`` planes, in the
JAX kernel's order (``ops/pallas_walk.py:1266-1274``): constant inputs
``p0x, p0y, sid`` (plus ``ob0, n0x, n0y`` for boundary-snap starts), then
the mutable state ``px, py, nx, ny, atten, acc*, asum*, asq*, quota,
steps, ndone, ob, life, tn, tw, wmax, bmax``.
"""

from __future__ import annotations

import torch

__all__ = ["LANES", "CONST_PLANES", "SNAP_PLANES", "state_planes",
           "plane_dtype", "init_state"]

LANES = 128
CONST_PLANES = ("p0x", "p0y", "sid")
SNAP_PLANES = ("ob0", "n0x", "n0y")
_INT_PLANES = {"sid", "ob0", "quota", "steps", "ndone", "ob", "life"}


def state_planes(n_src: int):
    """Mutable state planes in kernel order for ``n_src`` accumulators."""
    return (["px", "py", "nx", "ny", "atten"]
            + [f"acc{i}" for i in range(n_src)]
            + [f"asum{i}" for i in range(n_src)]
            + [f"asq{i}" for i in range(n_src)]
            + ["quota", "steps", "ndone", "ob", "life"]
            + ["tn", "tw", "wmax", "bmax"])


def plane_dtype(name: str):
    return torch.int32 if name in _INT_PLANES else torch.float32


def init_state(ptx, pty, snap, K: int, rows: int, quotas, sid, n_src: int):
    """Fresh walker planes: ``K`` point-major slots per evaluation point,
    padded to ``rows * 128`` lanes (padding lanes have quota 0).

    ``ptx, pty``: ``(P,)`` start points; ``snap``: ``None`` or
    ``(ob0, n0x, n0y)`` per point; ``quotas``: ``(rows, 128)`` int32;
    ``sid``: ``(rows, 128)`` int32 stream ids. Mutable planes never alias
    the constant ones: the kernel updates them in place.
    """
    dev = ptx.device
    W = ptx.shape[0] * K
    W_pad = rows * LANES

    def pad(v, dtype):
        out = torch.zeros(W_pad, dtype=dtype, device=dev)
        out[:W] = torch.repeat_interleave(v.to(dtype), K)
        return out.reshape(rows, LANES)

    f0 = lambda: torch.zeros(rows, LANES, dtype=torch.float32, device=dev)
    i0 = lambda: torch.zeros(rows, LANES, dtype=torch.int32, device=dev)
    p0x, p0y = pad(ptx, torch.float32), pad(pty, torch.float32)
    state = {
        "p0x": p0x, "p0y": p0y, "sid": sid.to(dev),
        "px": p0x.clone(), "py": p0y.clone(), "nx": f0(), "ny": f0(),
        "atten": f0() + 1.0,
        "quota": quotas.to(dev), "steps": i0(), "ndone": i0(), "ob": i0(),
        "life": i0(), "tn": f0(), "tw": f0(), "wmax": f0(), "bmax": f0(),
    }
    if snap is not None:
        ob0, n0x, n0y = snap
        state["ob0"] = pad(ob0, torch.int32)
        state["n0x"] = pad(n0x, torch.float32)
        state["n0y"] = pad(n0y, torch.float32)
        state["ob"] = state["ob0"].clone()
        state["nx"] = state["n0x"].clone()
        state["ny"] = state["n0y"].clone()
    for i in range(n_src):
        state[f"acc{i}"] = f0()
        state[f"asum{i}"] = f0()
        state[f"asq{i}"] = f0()
    return state
