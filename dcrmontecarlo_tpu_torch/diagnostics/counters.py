"""Solver observability: occupancy and termination statistics (port of
``diagnostics/counters.py``).

One-step launches of the solver's own walk over a solve's slot layout;
each step's active walkers and finished walks are read from the walker
planes (the lanes whose lifetime grew, whose walk count grew).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..solver.state import init_state
from ._steps import walk_planes
from ..ops.walk_kernel import run_walk

__all__ = ["OccupancyProfile", "profile_occupancy"]


@dataclass
class OccupancyProfile:
    active_per_iter: np.ndarray   # (T,) active walkers per loop iteration
    walks_done_per_iter: np.ndarray  # (T,)
    n_slots: int

    @property
    def mean_occupancy(self) -> float:
        live = self.active_per_iter > 0
        if not live.any():
            return 0.0
        return float(self.active_per_iter[live].mean() / self.n_slots)

    @property
    def iterations(self) -> int:
        return int((self.active_per_iter > 0).sum())


def profile_occupancy(solver, points, n_walks: int = 64,
                      max_steps: int = 200, eps: float = 1e-3, seed: int = 0,
                      max_iters: int = 512) -> OccupancyProfile:
    """Measure per-iteration active-walker occupancy for a solve setup
    (the solver's slot layout, no boundary snap, lane ``j`` on stream
    ``j``), on the solver's device."""
    solver._check_supported()
    dev = solver.device
    params = solver._walk_params(eps, max_steps, seed, snap=False)
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    K, quota_row = solver._slot_layout(pts.shape[0], n_walks)
    p0x = torch.as_tensor(np.repeat(pts[:, 0], K), device=dev)
    p0y = torch.as_tensor(np.repeat(pts[:, 1], K), device=dev)
    quotas = torch.as_tensor(np.tile(quota_row, pts.shape[0]), device=dev)
    planes = walk_planes(init_state(p0x, p0y, quotas, n_src=params.n_src),
                         p0x, p0y)
    active = np.zeros(max_iters, np.int64)
    done = np.zeros(max_iters, np.int64)
    for t in range(max_iters):
        if not bool((planes["quota"] > 0).any()):
            break  # nothing steps or finishes any more
        life = planes["life"].clone()
        ndone = planes["ndone"].clone()
        run_walk(planes, params, 1)
        active[t] = int((planes["life"] - life).sum())
        done[t] = int((planes["ndone"] - ndone).sum())
    return OccupancyProfile(active_per_iter=active, walks_done_per_iter=done,
                            n_slots=int(p0x.shape[0]))
