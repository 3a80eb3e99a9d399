"""Walk-history tracing (port of ``diagnostics/history.py``).

A small walker batch (one slot per walk, quota 1) is advanced by one-step
launches of the solver's own walk (the CUDA kernel on the card, its plain
version on the CPU), and each step's records are taken from the walker
planes before and after the launch and from the geometry queries. The
result converts to the reference's history schema
(``WoStSolver.py:330-349``) via :meth:`WalkHistory.to_dict` for the
plotting utilities.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..solver.state import init_state
from ._steps import geometry_records, lane_state, traced_step, walk_planes

__all__ = ["WalkHistory", "trace_walks"]


@dataclass
class WalkHistory:
    """Fixed-shape traced walks for one evaluation point.

    Step axis ``T`` = traced steps; per-walk validity is given by
    ``active`` (True while the walk was still running *at the start of*
    the step — the position at that step is part of the path).
    """

    point: np.ndarray            # (2,) evaluation point
    positions: np.ndarray        # (n_walks, T, 2) walker position per step
    d_dirichlet: np.ndarray      # (n_walks, T)
    d_silhouette: np.ndarray     # (n_walks, T) +inf without Neumann
    radius: np.ndarray           # (n_walks, T) star radius
    source_contrib: np.ndarray   # (n_walks, T) source field 0 (see _all)
    boundary_contrib: np.ndarray  # (n_walks,) terminal BC contribution
    active: np.ndarray           # (n_walks, T) bool
    walk_length: np.ndarray      # (n_walks,) steps taken
    total: np.ndarray            # (n_walks,) walk total, source field 0
    source_contrib_all: np.ndarray = None  # (n_src, n_walks, T): every
                                  # source's terms from the one shared
                                  # walk set
    total_all: np.ndarray = None  # (n_src, n_walks) walk totals per source

    @property
    def n_src(self) -> int:
        return 1 if self.source_contrib_all is None else \
            self.source_contrib_all.shape[0]

    def to_dict(self, source: int = 0) -> Dict[int, List[dict]]:
        """Reference history schema (``WoStSolver.py:330-349``) for a single
        point index 0; ``source`` selects which source field's
        contributions/totals are reported (multi-source ensembles)."""
        if source == 0 or self.source_contrib_all is None:
            src_c, tot = self.source_contrib, self.total
        else:
            src_c = self.source_contrib_all[source]
            tot = self.total_all[source]
        walks = []
        n_t = self.positions.shape[1]
        for w in range(self.positions.shape[0]):
            T = int(self.walk_length[w]) + 1
            path = [
                {
                    "point": self.positions[w, t],
                    "dirichlet_distance": float(self.d_dirichlet[w, t]),
                    "neumann_distance": (
                        float(self.d_silhouette[w, t])
                        if np.isfinite(self.d_silhouette[w, t])
                        else None
                    ),
                }
                for t in range(min(T, n_t))
            ]
            contributions = [
                {
                    "step": t,
                    "type": "source",
                    "point": self.positions[w, t],
                    "contribution": float(src_c[w, t]),
                }
                for t in range(n_t)
                if src_c[w, t] != 0.0
            ]
            contributions.append(
                {
                    "step": int(self.walk_length[w]),
                    "type": "boundary",
                    "point": self.positions[w, min(T - 1, n_t - 1)],
                    "contribution": float(self.boundary_contrib[w]),
                }
            )
            walks.append(
                {
                    "walk_id": w,
                    "path": path,
                    "contributions": contributions,
                    "total_contribution": float(tot[w]),
                }
            )
        return {0: walks}


def trace_walks(solver, point, n_walks: int = 16, max_steps: int = 200,
                eps: float = 1e-3, seed: int = 0) -> WalkHistory:
    """Run ``n_walks`` traced walks from ``point`` and capture every step
    (``max_steps + 2`` of them, as the JAX package's scan), on the
    solver's device. Walks start at the point itself (no boundary snap)
    and lane ``j`` draws stream ``j``."""
    solver._check_supported()
    pb, dev = solver.problem, solver.device
    params = solver._walk_params(eps, max_steps, seed, snap=False)
    n_src = params.n_src
    p = np.asarray(point, np.float32).reshape(2)
    p0x = torch.full((n_walks,), float(p[0]), device=dev)
    p0y = torch.full((n_walks,), float(p[1]), device=dev)
    state = init_state(p0x, p0y,
                       torch.ones(n_walks, dtype=torch.int32, device=dev),
                       n_src=n_src)
    planes = walk_planes(state, p0x, p0y)
    W, T = n_walks, max_steps + 2
    recs = {k: [] for k in ("px", "py", "dD", "dS", "r", "src", "bnd",
                            "active")}
    for _ in range(T):
        px = lane_state(planes, "px", W).clone()
        py = lane_state(planes, "py", W).clone()
        active = lane_state(planes, "quota", W) > 0
        if not bool(active.any()):
            break  # every later step records this state again
        dD, d_sil, _, r = geometry_records(pb, px, py, params.rmin)
        src, bnd, _ = traced_step(planes, params, W)
        for k, v in (("px", px), ("py", py), ("dD", dD), ("dS", d_sil),
                     ("r", r), ("src", src), ("bnd", bnd),
                     ("active", active)):
            recs[k].append(v)
    n_rec = len(recs["px"])
    if n_rec < T:
        px = lane_state(planes, "px", W)
        py = lane_state(planes, "py", W)
        dD, d_sil, _, r = geometry_records(pb, px, py, params.rmin)
        idle = (("px", px), ("py", py), ("dD", dD), ("dS", d_sil), ("r", r),
                ("src", torch.zeros(n_src, W, device=dev)),
                ("bnd", torch.zeros(W, device=dev)),
                ("active", torch.zeros(W, dtype=torch.bool, device=dev)))
        for k, v in idle:
            recs[k].extend([v] * (T - n_rec))
    rec = {k: torch.stack(v, dim=-1).cpu().numpy() for k, v in recs.items()}
    positions = np.stack([rec["px"], rec["py"]], axis=-1)
    active = rec["active"]
    total_all = torch.stack([lane_state(planes, f"asum{i}", W)
                             for i in range(n_src)]).cpu().numpy()
    src_all = rec["src"]                     # (n_src, n_walks, T)
    return WalkHistory(
        point=p,
        positions=positions,
        d_dirichlet=rec["dD"],
        d_silhouette=rec["dS"],
        radius=rec["r"],
        source_contrib=src_all[0],
        boundary_contrib=rec["bnd"].sum(axis=1),
        active=active,
        walk_length=np.maximum(active.sum(axis=1) - 1, 0),
        total=total_all[0],
        source_contrib_all=src_all,
        total_all=total_all,
    )
