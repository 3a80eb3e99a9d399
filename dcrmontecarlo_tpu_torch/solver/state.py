"""Walker state (port of ``solver/state.py``) and the plane layout of the
fused walk (``ops/walk_kernel.py``).

Every walker slot is one lane of a set of ``(rows, 128)`` planes, in the
JAX kernel's order (``ops/pallas_walk.py:1266-1274``): constant inputs
``p0x, p0y, sid`` (plus ``ob0, n0x, n0y`` for boundary-snap starts), then
the mutable state ``px, py, nx, ny, atten, acc*, asum*, asq*, quota,
steps, ndone, ob, life, tn, tw, wmax, bmax``. :class:`WalkerState` is the
JAX package's structure of ``(W,)`` lanes; :func:`lane_planes` lays one
out on the planes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["LANES", "CONST_PLANES", "SNAP_PLANES", "state_planes",
           "plane_dtype", "WalkerState", "init_state", "lane_planes",
           "slot_planes", "point_sums"]

LANES = 128
CONST_PLANES = ("p0x", "p0y", "sid")
SNAP_PLANES = ("ob0", "n0x", "n0y")
_INT_PLANES = {"sid", "ob0", "quota", "steps", "ndone", "ob", "life"}
_CHUNK = 1024  # lanes per chunk of the card's prefix sums (point_sums)


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


class WalkerState(NamedTuple):
    """The walker state as the JAX package's ``WalkerState``: ``(W,)``
    tensors, the accumulators ``(n_src, W)``, and the solve-wide
    counters as 0-d tensors. The walk itself runs on planes
    (:func:`lane_planes`)."""

    px: torch.Tensor          # f32 current walker position x
    py: torch.Tensor          # f32 current walker position y
    on_bdry: torch.Tensor     # bool standing on the Neumann boundary
    nx: torch.Tensor          # f32 inward normal at the last Neumann hit
    ny: torch.Tensor          # f32
    atten: torch.Tensor       # f32 delta-tracking attenuation
    walk_acc: torch.Tensor    # f32 (n_src, W) source terms of this walk
    quota: torch.Tensor       # i32 walks left for this slot (incl. current)
    steps_cur: torch.Tensor   # i32 steps taken in the current walk
    acc_sum: torch.Tensor     # f32 (n_src, W) sum of finished-walk totals
    acc_sumsq: torch.Tensor   # f32 (n_src, W) sum of squared totals
    n_done: torch.Tensor      # i32 finished walks
    total_steps: torch.Tensor  # () f32 active walker-steps taken
    step_idx: torch.Tensor    # () i32 loop iteration
    trunc_n: torch.Tensor     # () f32 walks ended by the step cap
    wmax: torch.Tensor        # () f32 max |atten| over stepping lanes
    bmax: torch.Tensor        # () f32 max |banked walk total|
    trunc_absw: torch.Tensor  # () f32 sum of |atten| those walks carried
    a_cur: Optional[torch.Tensor] = None  # f32 alpha at the position


def init_state(p0x, p0y, quotas, n_src: int = 1, a0=None) -> WalkerState:
    """A fresh :class:`WalkerState` at the start points ``p0x, p0y`` with
    per-lane ``quotas`` (the JAX package's ``init_state``); ``a0``: alpha
    at the start points, kept as ``a_cur``."""
    p0x = torch.as_tensor(p0x)
    dev = p0x.device
    w = p0x.shape[0]
    f0 = torch.zeros(w, dtype=torch.float32, device=dev)
    acc0 = torch.zeros(n_src, w, dtype=torch.float32, device=dev)
    s0 = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
    return WalkerState(
        a_cur=None if a0 is None else torch.as_tensor(
            a0, dtype=torch.float32, device=dev),
        px=p0x.to(torch.float32),
        py=torch.as_tensor(p0y, device=dev).to(torch.float32),
        on_bdry=torch.zeros(w, dtype=torch.bool, device=dev),
        nx=f0, ny=f0.clone(), atten=f0 + 1.0, walk_acc=acc0,
        quota=torch.as_tensor(quotas, device=dev).to(torch.int32),
        steps_cur=torch.zeros(w, dtype=torch.int32, device=dev),
        acc_sum=acc0.clone(), acc_sumsq=acc0.clone(),
        n_done=torch.zeros(w, dtype=torch.int32, device=dev),
        total_steps=s0(torch.float32), step_idx=s0(torch.int32),
        trunc_n=s0(torch.float32), wmax=s0(torch.float32),
        bmax=s0(torch.float32), trunc_absw=s0(torch.float32))


def lane_planes(state: WalkerState, p0x, p0y, sid, start=None) -> dict:
    """The walk's planes holding ``state``'s ``W`` lanes, padded to whole
    rows of ``LANES`` (padding lanes have quota 0): lane ``j`` starts its
    walks at ``(p0x[j], p0y[j])`` and draws stream ``sid[j]``. ``start``:
    ``None`` or per-lane ``(ob0, n0x, n0y)``, starts on a Neumann wall
    with their inward normals (boundary snap). The per-lane counters
    (``life``, ``tn``, ``tw``, ``wmax``, ``bmax``) start at zero."""
    dev = state.px.device
    w = state.px.shape[0]
    rows = max(1, -(-w // LANES))

    def pad(v, dtype):
        out = torch.zeros(rows * LANES, dtype=dtype, device=dev)
        out[:w] = torch.as_tensor(v, device=dev).to(dtype)
        return out.reshape(rows, LANES)

    planes = {"p0x": pad(p0x, torch.float32), "p0y": pad(p0y, torch.float32),
              "sid": pad(sid, torch.int32),
              "px": pad(state.px, torch.float32),
              "py": pad(state.py, torch.float32),
              "nx": pad(state.nx, torch.float32),
              "ny": pad(state.ny, torch.float32),
              "atten": pad(state.atten, torch.float32),
              "quota": pad(state.quota, torch.int32),
              "steps": pad(state.steps_cur, torch.int32),
              "ndone": pad(state.n_done, torch.int32),
              "ob": pad(state.on_bdry, torch.int32)}
    for name in ("life", "tn", "tw", "wmax", "bmax"):
        planes[name] = pad(torch.zeros(w), plane_dtype(name))
    for i in range(state.walk_acc.shape[0]):
        planes[f"acc{i}"] = pad(state.walk_acc[i], torch.float32)
        planes[f"asum{i}"] = pad(state.acc_sum[i], torch.float32)
        planes[f"asq{i}"] = pad(state.acc_sumsq[i], torch.float32)
    if start is not None:
        for name, v in zip(SNAP_PLANES, start):
            planes[name] = pad(v, plane_dtype(name))
    return planes


def slot_planes(ptx, pty, snap, K: int, rows: int, quotas, sid, n_src: int,
                slot_major: bool = False):
    """Fresh walker planes of a solve: ``K`` slots per evaluation point,
    padded to ``rows * 128`` lanes (padding lanes have quota 0).
    Point-major (lane ``i * K + j`` holds slot ``j`` of point ``i``: the
    single-device solver), or with ``slot_major`` lane ``j * P + i`` (a
    shard of the sharded solver, ``parallel/mesh.py:502-535`` of the JAX
    package).

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
        v = v.to(dtype)
        out[:W] = v.repeat(K) if slot_major else torch.repeat_interleave(v, K)
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


def point_sums(out, pid, values):
    """``out[:, pid[j]] += values[:, j]`` for every lane ``j`` of ``(k,
    lanes)`` values into ``(k, n)`` sums, the same on every run. On the CPU
    ``index_add_``, in lane order. On the card ``index_add_`` adds with
    float atomics, in an order that changes from run to run (two solves
    with one seed would differ in their last bits), and ``index_put_``
    with ``accumulate=True`` serializes the lanes of one point (a
    short-walk solve took three times as long): there the lanes are
    sorted by point, prefix-summed in float64 and differenced at each
    point's end, no atomics. Returns ``out``."""
    if out.device.type != "cuda":
        return out.index_add_(1, pid, values)
    return _prefix_sums(out, pid, values)


def _prefix_sums(out, pid, values):
    """The card's :func:`point_sums` (any device). A point's sum is the
    difference of two float64 prefix sums of the lanes sorted by point:
    exact to ~1e-16 of the prefix, far inside float32's rounding. The
    prefix is taken in chunks of ``_CHUNK`` lanes and then across chunks,
    so the scans run in parallel (one long scan per row takes ~0.3 ms at
    196,608 lanes); every scan has a fixed order."""
    k, n = out.shape
    sorted_pid, order = torch.sort(pid, stable=True)
    v = torch.nn.functional.pad(values[:, order].double(),
                                (0, -values.shape[1] % _CHUNK))
    local = torch.cumsum(v.view(k, -1, _CHUNK), 2)
    zero = torch.zeros(k, 1, dtype=torch.float64, device=out.device)
    before = torch.cat([zero, torch.cumsum(local[:, :-1, -1], 1)], 1)
    prefix = torch.cat([zero, (local + before[:, :, None]).view(k, -1)], 1)
    # each point's end in the sorted lanes
    ends = torch.searchsorted(sorted_pid, torch.arange(
        n, dtype=sorted_pid.dtype, device=pid.device), right=True)
    sums = torch.diff(prefix[:, ends], dim=1, prepend=zero)
    return out.add_(sums.to(out.dtype))
