#!/usr/bin/env python3
"""The host loop's launches of the freeze builds, one by one, for one
checkout; and the bit-for-bit comparison of two checkouts' runs.

For each group (``flagship``: ``chip_smoke.py`` phase 15, ``cylinder``:
phase 34, ``split``: phase 40, ``terrain``: phase 41) at its full size:

- a warm-up solve (seed 0) through the host launch loop, each launch
  recorded by this checkout's ``chip_smoke.py::launch_anatomy``: its
  kernel ms (CUDA events), whether it ran at ``thr = +inf`` (every
  steppable lane heavy), the lanes steppable at its start, its lane-steps
  and iterations, its longest lane, and the warp efficiencies computed
  from the per-lane deltas: ``eff_life``, lane-steps over 32 x the
  longest lane of each warp of 32 lanes (one thread per lane for the
  whole launch), ``eff_lane`` the same in iterations, and ``eff_sched``,
  iterations over the thread-slots the tree's own schedule issues
  (``repack_schedule`` of its built library, which exports it: the repack
  loop's rounds, replayed in lane order; one thread per lane for a
  library from before the export), on the card's SM count. The
  efficiencies are a model replayed on the host, not a hardware counter;
- two timed solves (seeds 1 and 2): s/solve, walker-steps/s, kernel
  share, and the solve's steps, launches, clones, ``max_banked``, means
  and stderrs (kept for the comparison);
- 256 steps at the full-size state (seed 5, the freeze at 4), best of 3,
  and the end state (saved under ``_archive/anatomy/``, a hash per plane
  in the record);
- ``t1``: the kernel's ms per iteration of one lane alone (every other
  lane without quota, ``thr = +inf``), the median over 8 lanes: the
  latency floor of a launch is its longest lane's iterations x ``t1``.

Each run writes ``chiprun_out/anatomy_<tag>.json``. Run two checkouts in
turns in one call, then compare (equal planes on every lane, equal
solves):

    for t in "_archive/parent p1" ". c1" ". c2" "_archive/parent p2"; do
        set -- $t; python3 chip_probes/flagship_launch_anatomy.py $1 $2
    done
    python3 chip_probes/flagship_launch_anatomy.py --compare p1 c1

A third argument names the groups (comma-separated).
"""

import hashlib
import json
import math
import os
import sys
import time

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chiprun_out")
STATES = os.path.join(os.path.dirname(OUT), "_archive", "anatomy")
GROUPS = ("flagship", "cylinder", "split", "terrain")


def compare(tag_a, tag_b):
    import torch

    recs = []
    for tag in (tag_a, tag_b):
        with open(os.path.join(OUT, f"anatomy_{tag}.json")) as f:
            recs.append(json.load(f))
    ok = True
    for group in recs[0]["groups"]:
        if group not in recs[1]["groups"]:
            continue
        a, b = recs[0]["groups"][group], recs[1]["groups"][group]
        sa = torch.load(os.path.join(STATES, f"{tag_a}-{group}.pt"))
        sb = torch.load(os.path.join(STATES, f"{tag_b}-{group}.pt"))
        differ = {k: int((sa[k] != sb[k]).sum()) for k in sa}
        bad = {k: v for k, v in differ.items() if v}
        same_solves = a["solves"] == b["solves"]
        ok &= not bad and same_solves
        print(f"compare {tag_a} {tag_b} {group}: 256-step planes "
              f"{'equal on every lane' if not bad else 'differ: ' + str(bad)}"
              f" ({len(sa)} planes x {sa['px'].numel()} lanes); solves "
              f"(steps, launches, clones, max_banked, means, stderrs) "
              f"{'equal' if same_solves else 'differ'}: "
              f"{[(s['seed'], s['total_steps'], s['launches'], s['clones']) for s in a['solves']]}"
              f"{'' if same_solves else ' vs ' + str([(s['seed'], s['total_steps'], s['launches'], s['clones']) for s in b['solves']])}",
              flush=True)
    print(f"compare {tag_a} {tag_b}: {'EQUAL' if ok else 'DIFFERENT'}",
          flush=True)
    return ok


def main():
    tree = os.path.abspath(sys.argv[1])
    tag = sys.argv[2]
    only = sys.argv[3].split(",") if len(sys.argv) > 3 else GROUPS
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np
    import torch

    from dcrmontecarlo_tpu_torch.models import notebook_survey, \
        geophysical_scenario
    from dcrmontecarlo_tpu_torch.models import drape_electrodes
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
    from dcrmontecarlo_tpu_torch.solver import WoStSolver
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    from dcrmontecarlo_tpu_torch.survey import survey_default_options
    from this_checkout import chip_smoke

    assert wk.__file__.startswith(tree), wk.__file__
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()

    def flagship():
        s, e = notebook_survey()
        s.local_majorant, s.source_mis = "auto", True
        opts = survey_default_options(target_slots=1 << 21, min_quota=32,
                                      split_threshold=4.0)
        return s.make_solver(opts, device=dev), np.asarray(e, np.float32), \
            1 << 20, 6000, 1.0, 4.0

    def cylinder():
        prob, pins = cs.cylinder_problem()
        opts = survey_default_options(target_slots=1 << 21, min_quota=32,
                                      split_threshold=4.0)
        return WoStSolver(prob, opts, device=dev), \
            pins["electrodes"].astype(np.float32), 1 << 20, 6000, 1.0, 4.0

    def split():
        s, e = geophysical_scenario(sharpness=0.5)
        return WoStSolver(s.build_problem(), cs.survey_split_options(),
                          device=dev), cs.survey_points(e, -0.5), \
            cs.P1_WALKS, cs.P1_MAX_STEPS, cs.P1_EPS, cs.P1_SPLIT

    def terrain():
        prob, h = cs.terrain_flagship_problem()
        opts = survey_default_options(target_slots=1 << 21,
                                      split_threshold=cs.P2_SPLIT)
        return WoStSolver(prob, opts, device=dev), \
            drape_electrodes(h, cs.TOPO_XS, nudge=0.5), cs.P2_WALKS, \
            cs.P2_MAX_STEPS, cs.P2_EPS, cs.P2_SPLIT

    makers = dict(flagship=flagship, cylinder=cylinder, split=split,
                  terrain=terrain)
    record = dict(tag=tag, tree=tree, card=card, sms=sms,
                  device=torch.cuda.get_device_name(0), groups={})
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(STATES, exist_ok=True)
    for group in only:
        solver, pts, n_walks, max_steps, eps, thr = makers[group]()
        state, params, _, _ = solver._setup(pts, n_walks, max_steps, eps, 5)
        t0 = time.time()
        wk.build_library([params.variant])
        build_s = time.time() - t0
        regs, smem = cs.library_resources(wk, params.variant)
        lib = wk._library(wk._canonical(params.variant))
        # a library without the export is PR 9's kernel: one thread a lane
        # for the whole launch, 128 a block
        schedule = cs.repack_schedule(lib) \
            if hasattr(lib, "walk_schedule") else (128, None, None)
        resident = cs.resident_blocks(schedule[0], regs, smem, sms)
        budget = solver.options.pallas_inner_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launches, _ = cs.launch_anatomy(wk, solver, pts, n_walks, max_steps,
                                        eps, 0, schedule, resident)
        anatomy_s = time.perf_counter() - t0

        # two timed solves, the kernel's share from CUDA events
        events = []

        def timed_walk(st, p, n, cur_thr=None):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(st, p, n, cur_thr)
            b.record()
            events.append((a, b))
            return st

        solves = []
        for seed in (1, 2):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver._solve_raw(pts, n_walks, max_steps, eps, seed,
                                    walk=timed_walk)
            wall = time.perf_counter() - t0
            kern = sum(a.elapsed_time(b) for a, b in events) / 1e3
            solves.append(dict(
                seed=seed, total_steps=res.total_steps,
                launches=solver.last_solve_stats["launches"],
                clones=solver.last_solve_stats["clones"],
                max_banked=res.max_banked,
                mean=np.asarray(res.mean).tobytes().hex(),
                stderr=np.asarray(res.stderr).tobytes().hex(),
                s=wall, share=kern / wall, rate=res.total_steps / wall))

        # 256 steps at the full-size state, best of 3, the end state kept
        def run256():
            s = {k: v.clone() for k, v in state.items()}
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(s, params, 256, freeze_thr=thr)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), s

        run256()
        ms256, end = min((run256() for _ in range(3)), key=lambda r: r[0])
        names = state_planes(params.n_src)
        torch.save({k: end[k].cpu() for k in names},
                   os.path.join(STATES, f"{tag}-{group}.pt"))
        hashes = {k: hashlib.sha256(end[k].cpu().numpy().tobytes())
                  .hexdigest()[:16] for k in names}
        steps256 = int((end["life"].long() - state["life"].long()).sum())

        # one lane alone: the latency of a lane's iteration
        live = torch.nonzero(state["quota"].reshape(-1) > 0).squeeze(1)
        t1s = []
        for j in live[torch.linspace(0, live.numel() - 1, 8).long()]:
            s = {k: v.clone() for k, v in state.items()}
            q = s["quota"].reshape(-1)
            keep = int(q[j])
            q.zero_()
            q[j] = keep
            life0, nd0 = int(s["life"].reshape(-1)[j]), \
                int(s["ndone"].reshape(-1)[j])
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(s, params, 256, freeze_thr=math.inf)
            b.record()
            torch.cuda.synchronize()
            n_it = (int(s["life"].reshape(-1)[j]) - life0
                    + int(s["ndone"].reshape(-1)[j]) - nd0)
            t1s.append(a.elapsed_time(b) / max(n_it, 1))
        t1 = float(np.median(t1s))

        ms = np.array([r["ms"] for r in launches])
        eff = np.array([r["iters"] / max(r["issued_sched"], 1)
                        for r in launches])
        floor = np.minimum(ms, np.array([r["longest_it"]
                                         for r in launches]) * t1)
        summary = dict(
            variant=params.kernel_name, build_s=build_s, budget=budget,
            registers=regs, smem=smem, resident=resident,
            launches=len(launches), anatomy_s=anatomy_s,
            kernel_ms=float(ms.sum()), ms_median=float(np.median(ms)),
            ms_max=float(ms.max()),
            inf_launches=sum(r["inf"] for r in launches),
            steppable_median=float(np.median([r["steppable"]
                                              for r in launches])),
            lane_steps=sum(r["lane_steps"] for r in launches),
            longest_median=float(np.median([r["longest"]
                                            for r in launches])),
            longest_at_budget=sum(r["longest_it"] >= budget
                                  for r in launches),
            eff_life=sum(r["lane_steps"] for r in launches)
            / max(sum(r["issued_life"] for r in launches), 1),
            eff_lane=sum(r["iters"] for r in launches)
            / max(sum(r["issued_lane"] for r in launches), 1),
            eff_sched=sum(r["iters"] for r in launches)
            / max(sum(r["issued_sched"] for r in launches), 1),
            idle_share=float((ms * (1.0 - eff)).sum() / ms.sum()),
            t1_ms=t1, latency_share=float(floor.sum() / ms.sum()),
            ms256=ms256, steps256=steps256, hashes=hashes)
        record["groups"][group] = dict(schedule=schedule, summary=summary,
                                       solves=[
            {k: v for k, v in s.items() if k not in ("s", "share", "rate")}
            for s in solves], timing=[
            {k: s[k] for k in ("seed", "s", "share", "rate")}
            for s in solves], launches=launches)
        print(tag, group, {k: (round(v, 5) if isinstance(v, float) else v)
                           for k, v in summary.items() if k != "hashes"},
              [(s["seed"], round(s["s"], 4), round(s["share"], 4),
                f"{s['rate']:.5g}", s["total_steps"], s["launches"],
                s["clones"]) for s in solves], card, flush=True)
        del solver, state, end
        torch.cuda.empty_cache()
    with open(os.path.join(OUT, f"anatomy_{tag}.json"), "w") as f:
        json.dump(record, f)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    main()
