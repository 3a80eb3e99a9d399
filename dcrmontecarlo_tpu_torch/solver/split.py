"""Slot quota layout and the launch-boundary high-weight split (port of
``solver/split.py::reserve_quota_row``, ``LAUNCH_SPLIT_COPY`` and
``make_launch_split``).

The in-graph split of the JAX package's XLA step loop
(``make_ingraph_split``, ``run_split_while``) has no counterpart here: the
port has no such loop.
"""

import numpy as np
import torch

__all__ = ["reserve_quota_row", "LAUNCH_SPLIT_COPY", "make_launch_split"]


def reserve_quota_row(n_walks: int, K: int, frac: float):
    """Distribute ``n_walks`` over ``K`` slots leaving ~``frac`` of them
    idle (every ``round(1/frac)``-th slot) as split clone hosts."""
    quota = np.zeros((K,), np.int32)
    if frac <= 0.0 or K < 2:
        work_idx = np.arange(K)
    else:
        stride = max(2, int(round(1.0 / frac)))
        idle = (np.arange(K) % stride) == (stride - 1)
        work_idx = np.flatnonzero(~idle)
    base, rem = divmod(int(n_walks), len(work_idx))
    quota[work_idx] = base
    quota[work_idx[:rem]] += 1
    return quota


# per-walk state a split clone copies; accumulators (asum/asq/life) are
# NOT copied — the destination lane's finished-walk statistics are banked
# under its OLD point id first — and acc starts at 0 on the clone, so the
# walk's prefix is counted once, by the original
LAUNCH_SPLIT_COPY = ["p0x", "p0y", "px", "py", "nx", "ny", "ob",
                     "steps", "ndone", "atten",
                     # boundary-snap start constants (present only with
                     # snap starts; clones never recycle — quota 1 — but
                     # copying keeps their lane state self-consistent)
                     "ob0", "n0x", "n0y"]


def _wrap_i32(v):
    """int64 values wrapped to int32, as int32 arithmetic wraps."""
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def make_launch_split(threshold: float, n_src: int, n_points: int):
    """The launch-boundary split on the port's dict of planes:
    ``split(state, pid, sid_base) -> (n, dsum, dsq)``, updating ``state``
    and the per-lane point ids ``pid`` in place, on their device.

    Heavy lanes (quota left and ``|atten| > threshold``) pair with idle
    lanes (no quota) GLOBALLY, in lane order on both sides (a stable
    sort, as ``jnp.argsort(..., stable=True)`` orders them, so the clones
    get the reference's stream ids). The ``n`` pairs halve their weight;
    the idle lane becomes a clone that finishes exactly the current walk
    (quota 1) on a fresh stream ``sid_base + rank``. A drained point-A lane
    may host a point-B clone: its finished-walk sums are banked under A
    first and returned as ``dsum``/``dsq`` ``(n_src, n_points)`` for the
    caller's carry, then ``pid`` is relabelled. The caller advances
    ``sid_base`` by ``n``.
    """
    thr = float(np.float32(threshold))

    def split(state, pid, sid_base):
        flat = {k: v.view(-1) for k, v in state.items()}
        active = flat["quota"] > 0
        heavy = active & (torch.abs(flat["atten"]) > thr)
        idle = ~active
        n = int(torch.minimum(heavy.sum(), idle.sum()))
        dev = pid.device
        dsum = torch.zeros(n_src, n_points, dtype=torch.float32, device=dev)
        dsq = torch.zeros_like(dsum)
        if n == 0:
            return 0, dsum, dsq
        # heavy lanes first / idle lanes first, each in lane order
        src = torch.argsort((~heavy).to(torch.int8), stable=True)[:n]
        dst = torch.argsort((~idle).to(torch.int8), stable=True)[:n]
        for key in LAUNCH_SPLIT_COPY:
            if key in flat:  # the snap keys are optional
                flat[key][dst] = flat[key][src]
        for i in range(n_src):
            flat[f"acc{i}"][dst] = 0.0
        half = flat["atten"][src] * 0.5
        flat["atten"][src] = half
        flat["atten"][dst] = half
        flat["quota"][dst] = 1
        flat["sid"][dst] = _wrap_i32(
            int(sid_base) + torch.arange(n, dtype=torch.int64, device=dev))
        # bank the destination lanes' finished walks under their old point
        old_pid = pid[dst]
        for i in range(n_src):
            dsum[i].index_add_(0, old_pid, flat[f"asum{i}"][dst])
            dsq[i].index_add_(0, old_pid, flat[f"asq{i}"][dst])
            flat[f"asum{i}"][dst] = 0.0
            flat[f"asq{i}"][dst] = 0.0
        pid[dst] = pid[src]
        return n, dsum, dsq

    return split
