"""Per-step unbiasedness audit: martingale increments by pre-step bucket
(port of ``diagnostics/martingale.py``).

For an unbiased step operator and the exact solution ``u`` of the
problem, the per-walker quantity

    est_t = walk_acc_t + atten_t * u(x_t)        (live walker)
          = acc_sum                              (banked, once done)

is a martingale: ``E[est_{t+1} - est_t | any pre-step event] = 0``. The
only systematic exception is the designed eps-shell completion bias,
which the ``completing`` bucket isolates; bucketing is by PRE-step state.
The audit drives the solver's own walk (the CUDA kernel on the card, its
plain version on the CPU) by one-step launches from a controlled start
state and evaluates the continuation on the state's device between them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..problems.fields import Grid
from ..ops.walk_kernel import run_walk
from ..solver.state import init_state
from ._steps import geometry_records, lane_state, walk_planes

__all__ = ["MartingaleReport", "martingale_audit", "grid_continuation"]

BUCKET_NAMES = (
    "far-interior",   # ball does not reach a Neumann wall
    "near-wall",      # interior, ball reaches a Neumann wall (hits possible)
    "on-boundary",    # standing on a Neumann wall (chord/hemisphere machinery)
    "onb-pristine",   # on-boundary at step 0 (snapped starts; no history)
    "completing",     # the walk banks this step (designed eps-shell bias)
)


@dataclass
class MartingaleReport:
    """Cross-seed bucket statistics of per-step martingale increments."""

    bucket_names: Sequence[str]
    mean: np.ndarray            # (B,) mean increment per visit
    sem: np.ndarray             # (B,) cross-seed standard error of the mean
    visits_per_walk: np.ndarray  # (B,) average visits per walker
    n: np.ndarray               # (B,) total increments audited

    @property
    def walk_bias(self) -> np.ndarray:
        return self.mean * self.visits_per_walk

    def __str__(self) -> str:
        lines = []
        for i, nm in enumerate(self.bucket_names):
            if self.n[i] == 0:
                continue
            lines.append(
                f"{nm:13s} n/walk {self.visits_per_walk[i]:8.2f} "
                f"mean-inc {self.mean[i]:+.5f} +- {self.sem[i]:.5f} "
                f"(walk-bias contrib {self.walk_bias[i]:+.4f})"
            )
        return "\n".join(lines)


def grid_continuation(xs, ys, u) -> Grid:
    """The bilinear interpolant of a grid field ``u[ix, iy]`` on the
    uniform node coordinates ``xs``, ``ys`` as a field spec
    (:class:`problems.fields.Grid`): callable on tensors, and the walk
    kernel's gridded Dirichlet kind when it is a problem's
    ``bc_dirichlet``. The nodes are rounded to float32 and the spacings
    are float32 differences, as the JAX package's closure takes them.
    Mirrors ``validation.fdm.FDMSolution.__call__``."""
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    return Grid(float(xs[0]), float(xs[1] - xs[0]), float(ys[0]),
                float(ys[1] - ys[0]), u)


def _band_names(a_edges, s_edges):
    NA = 1 if a_edges is None else len(a_edges) + 1
    NS = 1 if s_edges is None else len(s_edges) + 1
    names = []
    for nm in BUCKET_NAMES:
        for ai in range(NA):
            a_tag = "" if a_edges is None else (
                f"@a<{a_edges[ai]:g}" if ai < len(a_edges)
                else f"@a>={a_edges[-1]:g}")
            for six in range(NS):
                s_tag = "" if s_edges is None else (
                    f"@t<{s_edges[six]}" if six < len(s_edges)
                    else f"@t>={s_edges[-1]}")
                names.append(nm + a_tag + s_tag)
    return names, NA, NS


def martingale_audit(
    problem,
    options,
    point,
    *,
    continuation: Callable,
    eps: float,
    on_boundary: bool = False,
    normal: Optional[Sequence[float]] = None,
    n_steps: int = 48,
    n_walkers: int = 1 << 18,
    n_seeds: int = 8,
    seed0: int = 0,
    max_steps: int = 60000,
    source_index: int = 0,
    normalize_by_atten: bool = False,
    atten_bands=None,
    step_bands=None,
    device="cuda",
) -> MartingaleReport:
    """Audit the production step operator from a controlled start state.

    Args as the JAX package's ``martingale_audit``:
        problem / options: as for ``WoStSolver`` (the audit launches the
            solver's own walk, one step at a time).
        point: ``(x, y)`` start position for every walker.
        continuation: exact/oracle solution ``u(px, py)`` of the
            UNTRANSFORMED problem, callable on tensors.
        eps / max_steps: walk parameters.
        on_boundary / normal: start standing on a Neumann wall with the
            given inward normal (the snapped-electrode configuration).
        n_steps: steps audited per seed.
        n_walkers / n_seeds / seed0: power; SEMs are cross-seed. Seed
            ``k`` walks with the JAX audit's key
            ``(seed0 + k) * 7919 + 13``.
        source_index: which source's accumulator defines ``est``.
        normalize_by_atten: divide each increment by the PRE-step atten
            (use raw to SIZE a leak, normalized to FIND it).
        atten_bands / step_bands: optional increasing ``|atten|`` and step
            edges splitting each state bucket into ``name@a<edge`` /
            ``name@a>=last`` and ``name@t<edge`` / ``name@t>=last``.
        device: where the walkers live (the card unless asked).

    Returns a :class:`MartingaleReport` over the buckets in
    ``BUCKET_NAMES``.
    """
    from ..solver.wost import WoStSolver

    solver = WoStSolver(problem, options, device=device)
    solver._check_supported()
    dev = solver.device
    rmin = options.rmin_factor * eps

    px0, py0 = float(point[0]), float(point[1])
    if on_boundary and normal is None:
        raise ValueError("on_boundary start needs the inward normal")
    nx0, ny0 = (float(normal[0]), float(normal[1])) if normal else (0.0, 0.0)
    W = int(n_walkers)
    si = int(source_index)
    a_edges = (torch.as_tensor(np.asarray(sorted(atten_bands), np.float32),
                               device=dev) if atten_bands else None)
    s_edges = (np.asarray(sorted(step_bands), np.int32)
               if step_bands else None)
    names, NA, NS = _band_names(
        None if a_edges is None else a_edges.cpu().numpy(), s_edges)
    NB = len(names)

    def est_of(pl):
        live = lane_state(pl, "ndone", W) < 1
        px, py = lane_state(pl, "px", W), lane_state(pl, "py", W)
        return torch.where(
            live, lane_state(pl, f"acc{si}", W)
            + lane_state(pl, "atten", W) * continuation(px, py),
            lane_state(pl, f"asum{si}", W))

    def run(seed):
        params = solver._walk_params(eps, max_steps, seed, snap=on_boundary)
        p0x = torch.full((W,), px0, dtype=torch.float32, device=dev)
        p0y = torch.full((W,), py0, dtype=torch.float32, device=dev)
        st = init_state(p0x, p0y,
                        torch.ones(W, dtype=torch.int32, device=dev),
                        n_src=params.n_src)
        ob_a = torch.full((W,), bool(on_boundary), device=dev)
        nx_a = torch.full((W,), nx0, dtype=torch.float32, device=dev)
        ny_a = torch.full((W,), ny0, dtype=torch.float32, device=dev)
        st = st._replace(on_bdry=ob_a, nx=nx_a, ny=ny_a)
        pl = walk_planes(st, p0x, p0y,
                         (ob_a, nx_a, ny_a) if on_boundary else None)
        sums = torch.zeros(3, NB, dtype=torch.float64, device=dev)
        for t in range(n_steps):
            pre_est = est_of(pl)
            pre_live = lane_state(pl, "ndone", W) < 1
            pre_att = lane_state(pl, "atten", W).clone()
            if normalize_by_atten:
                pre_live = pre_live & (torch.abs(pre_att) > 1e-9)
            ob = lane_state(pl, "ob", W) != 0
            px, py = lane_state(pl, "px", W), lane_state(pl, "py", W)
            _, _, d_neu, r_pre = geometry_records(problem, px, py, rmin)
            run_walk(pl, params, 1)
            inc = torch.where(pre_live, est_of(pl) - pre_est, 0.0)
            if normalize_by_atten:
                inc = inc / torch.where(pre_live, pre_att, 1.0)
            bucket = torch.where(
                ob, 3 if t == 0 else 2,
                torch.where(d_neu < r_pre, 1, 0))
            bucket = torch.where(
                (lane_state(pl, "ndone", W) >= 1) & pre_live, 4, bucket)
            if a_edges is not None or s_edges is not None:
                a_idx = 0
                if a_edges is not None:
                    a_idx = (torch.abs(pre_att)[:, None]
                             >= a_edges[None, :]).sum(dim=1)
                s_idx = 0 if s_edges is None else int((t >= s_edges).sum())
                bucket = bucket * (NA * NS) + a_idx * NS + s_idx
            inc = torch.where(pre_live, inc, 0.0).double()
            for row, v in enumerate((inc, inc * inc, pre_live.double())):
                sums[row].index_add_(0, bucket.reshape(-1), v)
        return sums.cpu().numpy()

    per_seed = []
    tot = np.zeros((3, NB), np.float64)
    for k in range(n_seeds):
        sm, sq, cn = run((seed0 + k) * 7919 + 13)
        per_seed.append(sm / np.maximum(cn, 1.0))
        tot += [sm, sq, cn]
    per_seed = np.stack(per_seed)
    mean = tot[0] / np.maximum(tot[2], 1.0)
    if n_seeds > 1:
        sem = per_seed.std(0, ddof=1) / np.sqrt(n_seeds)
    else:  # single seed: fall back to the iid SEM
        var = np.maximum(tot[1] / np.maximum(tot[2], 1.0) - mean**2, 0.0)
        sem = np.sqrt(var / np.maximum(tot[2], 1.0))
    return MartingaleReport(
        bucket_names=names,
        mean=mean,
        sem=sem,
        visits_per_walk=tot[2] / (W * n_seeds),
        n=tot[2],
    )
