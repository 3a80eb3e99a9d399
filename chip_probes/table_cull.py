#!/usr/bin/env python3
"""How many table rows the culled scans visit: a host replay of the skip
tests on a walker state.

``csrc/walk_kernel.cu``'s culled first hit (``chunk_skips``) cuts the
table form's Neumann rows into chunks with a box each and skips a chunk
that cannot change the scan's result. This replay evaluates the same test
in float32 (``hit_skips``) on every lane that takes a step from
``state``, for the step's first hit along the lane's own direction (its
next uniform, the hemisphere on the wall) within its star radius; and,
for the scans the kernel runs in full, what a cull by distance alone
would keep: the Dirichlet scan (``closest``, rows past the nearest so
far) and the silhouette (vertices past the nearest silhouette vertex so
far or past ``dD``), in row order or the nearest chunk first. For chunks of
8, 16 and 32 rows it counts the rows a lane visits, and for each warp of
32 consecutive lanes the rows of the union of its lanes' chunks (a warp
runs a chunk's rows when any of its lanes does) and the (lane, chunk)
pairs of the warp, which the cooperative first hit runs 32 at a time.
MIS's star test is not replayed (its sample needs the step's whole draw),
nor the majorant's shrinking of the star radius (the replay keeps more
rows).

``replay_large(params, state)`` replays the large-table build's scans as
the kernel runs them (``walk_kernel.large_scans``): the silhouette's
group and chunk records (``sil_skips``: the box distance against the
running minimum from ``dD^2 (1 + 2^-20)``, and the oriented cone), in row
order, and the first hit's group records (``group_skips``) above its
chunks, all in float32 with the kernel's margins; it counts the rows and
the records a lane and a warp read a step.

``replay_closest(params, state)`` replays the culled closest point of
the table form without delta tracking (``walk_kernel.culled_closest``:
the Dirichlet rows by chunks from the chunk of the least box distance
outward, ``box_d2`` against the running minimum) over iterations of
``walk_plain`` from a state, and counts the rows and records a lane and a
warp read a closest point.

``replay(params, state)`` returns a dict per chunk size and scan; as a
script it runs ``chip_smoke.py`` phase 20's configuration (the terrain,
294,912 lanes) for 256 steps on the card and replays the end planes,
writing ``chiprun_out/table_cull.json``:

    python3 chip_probes/table_cull.py
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402

SIZES = (8, 16, 32)
WARP = 32


def _box_d2(box, px, py):
    """``box_d2`` of the kernel: ``(L, C)`` lower bounds on a row's d2."""
    gx = torch.clamp(torch.maximum(box[None, :, 0] - px[:, None],
                                   px[:, None] - box[None, :, 2]), min=0.0)
    gy = torch.clamp(torch.maximum(box[None, :, 1] - py[:, None],
                                   py[:, None] - box[None, :, 3]), min=0.0)
    return (gx * gx + gy * gy) * np.float32(0.9999)


def _hit_skips(rec, px, py, dx, dy, tmw, lim):
    """``hit_skips`` of the kernel over ``(L, C)`` lanes and chunks."""
    c = lambda k: rec[None, :, k]
    x0, x1 = c(0) - px[:, None], c(2) - px[:, None]
    y0, y1 = c(1) - py[:, None], c(3) - py[:, None]
    rb = x0.abs() + x1.abs() + y0.abs() + y1.abs()
    dx, dy = dx[:, None], dy[:, None]
    dy0, dy1, dx0, dx1 = dx * y0, dx * y1, dy * x0, dy * x1
    f_lo = torch.minimum(dy0, dy1) - torch.maximum(dx0, dx1)
    f_hi = torch.maximum(dy0, dy1) - torch.minimum(dx0, dx1)
    tol = rb * np.float32(2.0 ** -16) + np.float32(1e-30)
    line = (f_lo > tol) | (f_hi < -tol)
    sig = (dx * c(5) - dy * c(4)).abs() - c(6)
    t_lo = torch.minimum(dx * x0, dx * x1) + torch.minimum(dy * y0, dy * y1)
    t_hi = torch.maximum(dx * x0, dx * x1) + torch.maximum(dy * y0, dy * y1)
    m = rb * np.float32(2.0 ** -11)
    along = (sig > np.float32(2.0 ** -10)) & (
        ((tmw[:, None] - t_hi) * sig > m) | ((t_lo - lim[:, None]) * sig > m))
    return line | along


def _group_skips(rec, px, py, dx, dy, tmw, lim):
    """``group_skips`` of the kernel over ``(L, G)`` lanes and groups."""
    c = lambda k: rec[None, :, k]
    x0, x1 = c(0) - px[:, None], c(2) - px[:, None]
    y0, y1 = c(1) - py[:, None], c(3) - py[:, None]
    rb = x0.abs() + x1.abs() + y0.abs() + y1.abs()
    dxc, dyc = dx[:, None], dy[:, None]
    sig = (dxc * c(5) - dyc * c(4)).abs() - c(6)
    ex = torch.clamp(torch.maximum(x0, -x1), min=0.0)
    ey = torch.clamp(torch.maximum(y0, -y1), min=0.0)
    far = (sig > np.float32(2.0 ** -10)) & (
        (torch.maximum(ex, ey) * np.float32(1.0 - 2.0 ** -16)
         - lim[:, None]) * sig > rb * np.float32(2.0 ** -11))
    return _hit_skips(rec, px, py, dx, dy, tmw, lim) | far


def _sil_skips(rec, px, py, best):
    """``sil_skips`` of the kernel: ``(L,)`` lanes against one record."""
    r = [rec[k] for k in range(12)]
    ex = torch.clamp(torch.maximum(r[4] - px, px - r[6]), min=0.0)
    ey = torch.clamp(torch.maximum(r[5] - py, py - r[7]), min=0.0)
    near = ex * ex + ey * ey >= best
    x0, x1, y0, y1 = r[0] - px, r[2] - px, r[1] - py, r[3] - py
    rb = torch.maximum(x0.abs(), x1.abs()) + torch.maximum(y0.abs(), y1.abs())
    my0, my1, mx0, mx1 = r[8] * y0, r[8] * y1, r[9] * x0, r[9] * x1
    f_lo = torch.minimum(my0, my1) - torch.maximum(mx0, mx1)
    f_hi = torch.maximum(my0, my1) - torch.minimum(mx0, mx1)
    tol = (r[10] + np.float32(2.0 ** -16)) * rb + np.float32(1e-20)
    return near | (f_lo > tol) | (f_hi < -tol)


def _warp_any(mask, go):
    """``(W, K)``: whether any stepping lane of each warp of ``WARP``
    consecutive lanes has ``mask`` (``(L, K)``), and the warps that
    step."""
    n = go.numel()
    pad = (-n) % WARP
    v = torch.nn.functional.pad(mask & go[:, None], (0, 0, 0, pad))
    warps = torch.nn.functional.pad(go, (0, pad)).view(-1, WARP).any(1)
    return v.view(-1, WARP, v.shape[1]).any(1), warps


def _boxes(points, per):
    """The boxes of ``per`` consecutive rows of ``points`` ``(R, 2k)``,
    widened as ``walk_kernel.chunk_records`` widens a chunk's:
    ``(C, 4)``."""
    pts = np.asarray(points, np.float64)
    out = []
    for c0 in range(0, len(pts), per):
        xy = pts[c0:c0 + per].reshape(-1, 2)
        widen = float(np.abs(xy).max()) * 2.0 ** -20 + 1e-30
        out.append([*(xy.min(0) - widen), *(xy.max(0) + widen)])
    return np.asarray(out, np.float32)


def _rows_d2(ax, ay, bx, by, px, py):
    """The table form's closest-point d2 of every row, ``(L, S)``."""
    ux, uy = bx - ax, by - ay
    uu = torch.clamp(ux * ux + uy * uy, min=1e-30)
    vx, vy = px[:, None] - ax, py[:, None] - ay
    t = torch.clamp((vx * ux + vy * uy) / uu, 0.0, 1.0)
    ex, ey = (ax + t * ux) - px[:, None], (ay + t * uy) - py[:, None]
    return ex * ex + ey * ey


def _running(d2, bound, per, extra=None, nearest_first=False):
    """Visits of a scan that skips a chunk when its bound reaches the
    running minimum (or ``extra``): ``(L, C)`` bool, in chunk order, or
    with ``nearest_first`` the chunk of the least bound first."""
    n_l, n_c = bound.shape
    best = torch.full((n_l,), float(np.float32(3e38)), device=d2.device)
    visit = torch.zeros(n_l, n_c, dtype=torch.bool, device=d2.device)
    if nearest_first:  # a min: any order gives the same result
        first = bound.argmin(1)
        cols = first[:, None] * per + torch.arange(per, device=d2.device)
        rows = torch.gather(d2, 1, cols.clamp(max=d2.shape[1] - 1))
        best = torch.minimum(best, rows.min(1).values)
        visit[torch.arange(n_l), first] = True
    for ch in range(n_c):
        lim = best if extra is None else torch.minimum(best, extra)
        visit[:, ch] |= ~(bound[:, ch] >= lim)
        rows = d2[:, ch * per:(ch + 1) * per]
        low = torch.where(visit[:, ch, None], rows, float("inf")).min(1)
        best = torch.minimum(best, low.values)
    return visit


def _counts(visit, sizes, go):
    """Rows visited per lane and per warp (the union of its lanes'
    chunks), over the lanes that step."""
    rows = visit.float() @ sizes.float()
    n = go.numel()
    pad = (-n) % WARP
    v = torch.nn.functional.pad(visit & go[:, None], (0, 0, 0, pad))
    union = v.view(-1, WARP, v.shape[1]).any(1)
    warps = torch.nn.functional.pad(go, (0, pad)).view(-1, WARP).any(1)
    return dict(lane=float(rows[go].mean()),
                warp=float((union.float() @ sizes.float())[warps].mean()),
                chunks=float(visit[go].float().sum(1).mean()),
                pairs=float((v.view(-1, WARP, v.shape[1]).float().sum((1, 2))
                             )[warps].mean()),
                all=int(sizes.sum()))


def replay(params, state, sizes=SIZES):
    """Rows visited per lane-step and per warp-step by each culled scan,
    for each chunk size of ``sizes``: ``{size: {scan: {lane, warp, chunks,
    pairs, all}}}``, with ``lanes``, the lanes that step; ``closest``,
    ``silhouette`` and ``silhouette_nearest_first`` replay a cull by
    distance alone, which the kernel does not run."""
    P = params
    dev = state["px"].device
    flat = {k: v.reshape(-1) for k, v in state.items()}
    px, py = flat["px"], flat["py"]
    dD, _, _ = wk._closest_point(P, px, py)
    go = (flat["quota"] > 0) & (dD > P.eps) & (flat["steps"] < P.max_steps)
    dir_t = torch.as_tensor(P.dir_table, device=dev)
    neu_t = torch.as_tensor(P.neu_table, device=dev)
    vert_t = torch.as_tensor(P.vert_table, device=dev)
    d2_dir = _rows_d2(*dir_t.T[:, None, :], px, py)
    out = {"lanes": int(go.sum())}
    r = torch.clamp(dD, min=P.rmin)
    if len(vert_t):
        bx, by = vert_t[:, 2], vert_t[:, 3]
        bpx, bpy = px[:, None] - bx, py[:, None] - by
        apx, apy = px[:, None] - vert_t[:, 0], py[:, None] - vert_t[:, 1]
        sgn = (((bx - vert_t[:, 0]) * apy - (by - vert_t[:, 1]) * apx)
               * ((vert_t[:, 4] - bx) * bpy - (vert_t[:, 5] - by) * bpx))
        d2_vert = torch.where(sgn < 0, bpx * bpx + bpy * bpy,
                              float(np.float32(3e38)))
        sil = torch.sqrt(d2_vert.min(1).values)
        r = torch.clamp(torch.minimum(dD, sil), min=P.rmin)
        past = torch.where(dD > 1e-18, dD * dD * np.float32(1.0000009536743),
                           float(np.float32(3e38)))
    # the step's direction, as walk_step.inc draws it
    ctr = (wk.rng.mul32(flat["ndone"].to(torch.int64), P.max_steps + 2)
           + flat["steps"].to(torch.int64)) & wk.rng.MASK32
    sid = flat["sid"].to(torch.int64) & wk.rng.MASK32
    (u1,) = wk._uniforms(P.seed, ctr, sid, (1,))
    phi = math.pi * u1
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    ob = flat["ob"] != 0
    dx = torch.where(ob, flat["nx"] * sphi + flat["ny"] * cphi,
                     1.0 - 2.0 * sphi * sphi)
    dy = torch.where(ob, flat["ny"] * sphi - flat["nx"] * cphi,
                     2.0 * sphi * cphi)
    tmw = torch.where(ob, P.t_min, 0.0)
    for per in sizes:
        rec = torch.as_tensor(wk.chunk_records(P.neu_table, per),
                              device=dev)

        def sizes(n):
            return torch.as_tensor([min(per, n - c * per)
                                    for c in range(-(-n // per))],
                                   device=dev)
        res = {}
        vis = _running(d2_dir, _box_d2(torch.as_tensor(
            _boxes(P.dir_table, per), device=dev), px, py), per)
        res["closest"] = _counts(vis, sizes(len(dir_t)), go)
        if len(neu_t):
            skip = _hit_skips(rec, px, py, dx, dy, tmw, r)
            res["first_hit"] = _counts(~skip, sizes(len(neu_t)), go)
        if len(vert_t):
            bound = _box_d2(torch.as_tensor(
                _boxes(P.vert_table[:, 2:4], per), device=dev), px, py)
            vis = _running(d2_vert, bound, per, past)
            res["silhouette"] = _counts(vis, sizes(len(vert_t)), go)
            vis = _running(d2_vert, bound, per, past, nearest_first=True)
            res["silhouette_nearest_first"] = _counts(vis, sizes(len(vert_t)),
                                                      go)
        out[per] = res
    return out


def replay_closest(params, state, steps=32, lanes=8192):
    """The culled closest point's reads over ``steps`` iterations of
    ``walk_plain`` (a bank or a step each) from ``lanes`` lanes of
    ``state`` (whole warps of ``WARP`` consecutive lanes, spread evenly
    over it), a copy: the kernel's chunk order from the chunk of the least
    ``box_d2`` (k, k + 1, k - 1, ...), a chunk skipped where its record's
    ``box_d2`` exceeds the running minimum. ``{lane, warp, lane_records,
    warp_records, all, calls}``: rows a lane reads a closest point and a
    warp (the row loop of an iteration runs when any of its lanes visits),
    the record tests of each (every chunk's, twice: the least box first),
    the rows of a full scan, and the lanes' calls counted."""
    P = params
    flat = {k: v.reshape(-1) for k, v in state.items()}
    n_warps = max(1, min(lanes, flat["px"].numel()) // WARP)
    first = torch.linspace(0, flat["px"].numel() // WARP - 1, n_warps,
                           device=flat["px"].device).long() * WARP
    idx = (first[:, None] + torch.arange(WARP, device=first.device)).ravel()
    sub = {k: v[idx].clone() for k, v in flat.items()}
    dev = sub["px"].device
    n = sub["px"].numel()
    per = wk.CHUNK_ROWS
    ax, ay, bx, by = P.columns("dir_table", dev)
    n_dir = ax.shape[1]
    box = torch.as_tensor(wk.chunk_records(P.dir_table)[:, :4], device=dev)
    n_ch = box.shape[0]
    size = torch.as_tensor([min(per, n_dir - c * per) for c in range(n_ch)],
                           device=dev)
    pad = (-n) % WARP
    lane_rows = warp_rows = calls = warp_calls = 0.0
    for _ in range(steps):
        go = sub["quota"] > 0
        if not bool(go.any()):
            break
        px, py = sub["px"], sub["py"]
        d2 = _rows_d2(ax, ay, bx, by, px, py)
        cmin = torch.nn.functional.pad(d2, (0, n_ch * per - n_dir),
                                       value=float("inf")).view(
                                           n, n_ch, per).min(2).values
        ex = torch.clamp(torch.maximum(box[None, :, 0] - px[:, None],
                                       px[:, None] - box[None, :, 2]), min=0)
        ey = torch.clamp(torch.maximum(box[None, :, 1] - py[:, None],
                                       py[:, None] - box[None, :, 3]), min=0)
        bd = ex * ex + ey * ey
        k0 = bd.argmin(1)
        best = torch.full((n,), float(np.float32(3e38)), device=dev)
        rows = torch.zeros(n, device=dev)
        warp = torch.zeros((n + pad) // WARP, device=dev)
        for i in range(n_ch):
            o = (i + 1) // 2
            ch = torch.remainder(k0 + (o if i % 2 else -o), n_ch)[:, None]
            visit = ~(bd.gather(1, ch)[:, 0] > best) & go
            best = torch.where(visit, torch.minimum(
                best, cmin.gather(1, ch)[:, 0]), best)
            took = torch.where(visit, size[ch[:, 0]], 0).float()
            rows += took
            warp += torch.nn.functional.pad(took, (0, pad)).view(
                -1, WARP).max(1).values
        warps = torch.nn.functional.pad(go, (0, pad)).view(-1, WARP).any(1)
        lane_rows += float(rows[go].sum())
        calls += float(go.sum())
        warp_rows += float(warp[warps].sum())
        warp_calls += float(warps.sum())
        wk.walk_plain(sub, P, 1)
    return dict(lane=lane_rows / max(calls, 1.0),
                warp=warp_rows / max(warp_calls, 1.0), lane_records=2 * n_ch,
                warp_records=2 * n_ch, all=n_dir, calls=int(calls))


def _step_inputs(P, state):
    """The lanes that step from ``state`` and their scans' inputs: ``go,
    px, py, dD, r, dx, dy, tmw`` (float32, as the kernel forms them)."""
    dev = state["px"].device
    flat = {k: v.reshape(-1) for k, v in state.items()}
    px, py = flat["px"], flat["py"]
    dD, _, _ = wk._closest_point(P, px, py)
    go = (flat["quota"] > 0) & (dD > P.eps) & (flat["steps"] < P.max_steps)
    r = dD
    if len(P.vert_table):
        r = torch.minimum(dD, wk._silhouette(P, px, py))
    r = torch.clamp(r, min=P.rmin)
    ctr = (wk.rng.mul32(flat["ndone"].to(torch.int64), P.max_steps + 2)
           + flat["steps"].to(torch.int64)) & wk.rng.MASK32
    sid = flat["sid"].to(torch.int64) & wk.rng.MASK32
    (u1,) = wk._uniforms(P.seed, ctr, sid, (1,))
    phi = math.pi * u1
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    ob = flat["ob"] != 0
    dx = torch.where(ob, flat["nx"] * sphi + flat["ny"] * cphi,
                     1.0 - 2.0 * sphi * sphi)
    dy = torch.where(ob, flat["ny"] * sphi - flat["nx"] * cphi,
                     2.0 * sphi * cphi)
    tmw = torch.where(ob, torch.tensor(P.t_min, device=dev),
                      torch.tensor(0.0, device=dev)).float()
    return go, px, py, dD, r, dx, dy, tmw


def replay_large(params, state):
    """Rows and records a step of the large-table build's scans reads
    from ``state``: ``{"lanes", "silhouette": {...}, "first_hit": {...}}``,
    each with ``lane`` and ``warp`` (rows a lane visits; the rows of the
    union of a warp's lanes' chunks, which the warp runs), ``lane_records``
    and ``warp_records`` (group and chunk records tested; a warp tests a
    chunk's record where any of its lanes enters the chunk's group),
    ``groups`` (a lane's visited groups) and ``all`` (the rows)."""
    P = params
    dev = state["px"].device
    go, px, py, dD, r, dx, dy, tmw = _step_inputs(P, state)
    n_l = px.numel()
    out = {"lanes": int(go.sum())}
    grp = wk.GROUP_CHUNKS

    def counts(chunk_visit, group_visit, rows_per, n_rows):
        n_ch = chunk_visit.shape[1]
        sizes = torch.as_tensor([min(rows_per, n_rows - c * rows_per)
                                 for c in range(n_ch)], device=dev).float()
        gsz = torch.as_tensor([min(grp, n_ch - g * grp)
                               for g in range(group_visit.shape[1])],
                              device=dev).float()
        union_c, warps = _warp_any(chunk_visit, go)
        union_g, _ = _warp_any(group_visit, go)
        n_g = group_visit.shape[1]
        return dict(
            lane=float((chunk_visit.float() @ sizes)[go].mean()),
            warp=float((union_c.float() @ sizes)[warps].mean()),
            lane_records=float(n_g + (group_visit.float() @ gsz)[go].mean()),
            warp_records=float(n_g + (union_g.float() @ gsz)[warps].mean()),
            groups=float(group_visit[go].float().sum(1).mean()),
            all=int(n_rows))

    if len(P.neu_table):
        hit = torch.as_tensor(wk.chunk_records(P.neu_table), device=dev)
        hgrp = torch.as_tensor(wk.chunk_records(P.neu_table,
                                                wk.CHUNK_ROWS * grp),
                               device=dev)
        gvis = ~_group_skips(hgrp, px, py, dx, dy, tmw, r)
        cvis = ~_hit_skips(hit, px, py, dx, dy, tmw, r)
        cvis &= gvis.repeat_interleave(grp, 1)[:, :cvis.shape[1]]
        out["first_hit"] = counts(cvis, gvis, wk.CHUNK_ROWS,
                                  len(P.neu_table))
    if len(P.vert_table):
        vt = torch.as_tensor(P.vert_table, device=dev)
        ax, ay, bx, by, cx, cy = vt.T
        apx, apy = px[:, None] - ax, py[:, None] - ay
        bpx, bpy = px[:, None] - bx, py[:, None] - by
        sgn = (((bx - ax) * apy - (by - ay) * apx)
               * ((cx - bx) * bpy - (cy - by) * bpx))
        d2 = torch.where(sgn < 0, bpx * bpx + bpy * bpy,
                         float(np.float32(3e38)))
        best = torch.full((n_l,), float(np.float32(3e38)), device=dev)
        seed = torch.minimum(best, dD * dD * np.float32(1.0 + 2.0 ** -20))
        best = torch.where(torch.sqrt(seed) >= dD, seed, best)
        sch = torch.as_tensor(wk.silhouette_records(P.vert_table),
                              device=dev)
        sgr = torch.as_tensor(wk.silhouette_records(
            P.vert_table, wk.SIL_ROWS * grp), device=dev)
        n_ch, n_g = len(sch), len(sgr)
        cvis = torch.zeros(n_l, n_ch, dtype=torch.bool, device=dev)
        gvis = torch.zeros(n_l, n_g, dtype=torch.bool, device=dev)
        for g in range(n_g):
            gvis[:, g] = ~_sil_skips(sgr[g], px, py, best)
            for ch in range(g * grp, min(n_ch, (g + 1) * grp)):
                v = gvis[:, g] & ~_sil_skips(sch[ch], px, py, best)
                cvis[:, ch] = v
                rows = d2[:, ch * wk.SIL_ROWS:(ch + 1) * wk.SIL_ROWS]
                low = torch.where(v[:, None], rows, float("inf")).min(1)
                best = torch.minimum(best, low.values)
        full = torch.sqrt(d2.min(1).values)
        same = torch.minimum(dD, torch.sqrt(best)) == torch.minimum(dD, full)
        assert bool(same[go].all()), "the replayed cull changed a radius"
        out["silhouette"] = counts(cvis, gvis, wk.SIL_ROWS,
                                   len(P.vert_table))
    return out


def main():
    import chip_smoke as cs
    from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
        topographic_survey_problem
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver

    dev = torch.device("cuda", 0)
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    prob, h = topographic_survey_problem()
    pts = drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), nudge=0.5)
    solver = WoStSolver(prob, SolverOptions(target_slots=1 << 21),
                        device=dev)
    state, params, _, _ = solver._setup(pts, 1 << 17, 600, 0.5, 5)
    record = {"card": card, "start": replay(params, state)}
    wk.run_walk(state, params, 256)
    torch.cuda.synchronize()
    record["after_256"] = replay(params, state)
    for when in ("start", "after_256"):
        rec = record[when]
        print(f"{when}: {rec['lanes']} stepping lanes ({card})")
        for per in SIZES:
            print(f"  chunks of {per}: " + "; ".join(
                f"{k} lane {v['lane']:.1f} warp {v['warp']:.1f} of "
                f"{v['all']}" for k, v in rec[per].items()))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "table_cull.json", "w") as f:
        json.dump(record, f, default=str)


if __name__ == "__main__":
    main()
