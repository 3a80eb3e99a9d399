"""Slot quota layout (port of ``solver/split.py::reserve_quota_row``).

Only the quota helper is ported; splitting itself
(``make_ingraph_split``, ``make_launch_split``) is not.
"""

import numpy as np

__all__ = ["reserve_quota_row"]


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
