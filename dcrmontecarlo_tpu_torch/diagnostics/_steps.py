"""One-step walks for the diagnostics: lanes laid out on the walk's planes
and advanced by one-step :func:`ops.walk_kernel.run_walk` launches (the
CUDA kernel on a CUDA device, its plain version on the CPU), with the
per-step records the JAX package's step core returns as ``diag`` taken
from the planes before and after each launch and from the geometry
queries."""

from __future__ import annotations

import torch

from ..geometry import queries
from ..ops.walk_kernel import run_walk
from ..solver.state import lane_planes


def lane_state(planes: dict, name: str, w: int):
    """The first ``w`` lanes of plane ``name``."""
    return planes[name].reshape(-1)[:w]


def walk_planes(state, p0x, p0y, start=None) -> dict:
    """Planes of a :class:`WalkerState`, stream ``j`` for lane ``j`` (the
    step core's lane layout without common random numbers)."""
    sid = torch.arange(state.px.shape[0], dtype=torch.int32,
                       device=state.px.device)
    return lane_planes(state, p0x, p0y, sid, start)


def geometry_records(problem, px, py, rmin: float):
    """``(d_dirichlet, d_silhouette, d_neumann, radius)`` at ``(px, py)``:
    the plain star radius ``max(rmin, min(dD, d_sil))`` (``+inf`` for the
    Neumann distances without a Neumann boundary)."""
    dD = queries.distance(problem.dirichlet, px, py)
    if problem.neumann is not None:
        d_sil = queries.silhouette_distance(problem.neumann, px, py)
        d_neu = queries.distance(problem.neumann, px, py)
    else:
        d_sil = torch.full_like(dD, torch.inf)
        d_neu = torch.full_like(dD, torch.inf)
    return dD, d_sil, d_neu, torch.clamp(torch.minimum(dD, d_sil), min=rmin)


def traced_step(planes: dict, params, w: int):
    """One step of every lane with the exact per-step source and boundary
    terms of the first ``w`` lanes.

    The launch runs on planes whose accumulators and moments were set to
    zero, so each stepping lane's accumulators come back holding exactly
    this step's source terms and each banking lane's moments its boundary
    term ``bc * atten``; the walk's own sums are then formed from them as
    the kernel forms them (float32 adds, banking before stepping). Returns
    ``(src, bnd, banked)``: ``(n_src, w)`` source terms, the ``(w,)``
    boundary record ``(acc + g) - acc`` of source 0 (the JAX step core's
    ``boundary_contrib``) and the banking mask."""
    n_src = params.n_src
    keys = [f"{k}{i}" for k in ("acc", "asum", "asq") for i in range(n_src)]
    saved = {k: planes[k].clone() for k in keys}
    bmax = planes["bmax"].clone()
    ndone = planes["ndone"].clone()
    for k in keys:
        planes[k].zero_()
    run_walk(planes, params, 1)
    banked = planes["ndone"] != ndone
    g = planes["asum0"].clone()
    src = torch.stack([planes[f"acc{i}"].clone() for i in range(n_src)])
    bank_mag = torch.zeros_like(g)
    for i in range(n_src):
        acc = saved[f"acc{i}"]
        contrib = acc + g
        planes[f"asum{i}"].copy_(torch.where(
            banked, saved[f"asum{i}"] + contrib, saved[f"asum{i}"]))
        planes[f"asq{i}"].copy_(torch.where(
            banked, saved[f"asq{i}"] + contrib * contrib, saved[f"asq{i}"]))
        planes[f"acc{i}"].copy_(torch.where(banked, 0.0, acc + src[i]))
        bank_mag = torch.maximum(bank_mag, torch.abs(contrib))
    planes["bmax"].copy_(torch.where(banked, torch.maximum(bmax, bank_mag),
                                     bmax))
    bnd = torch.where(banked, (saved["acc0"] + g) - saved["acc0"], 0.0)
    flat = lambda t: t.reshape(*t.shape[:-2], -1)[..., :w]
    return flat(src), flat(bnd), flat(banked)
