#!/usr/bin/env python3
"""The table form's large-table build against a parent checkout and
against its culled build, on one card, bit for bit.

One run times one checkout (``TREE``, with its own package) at
``chip_smoke.py`` phase 45's configuration (the terrain over a 5 cm DEM,
16,002 rows) and hashes every result:

- ``p45``: a warm-up solve (seed 0) and timed solves with seeds 1-3 at
  phase 20's walks (294,912 lanes; CUDA events around every launch);
- ``p45_256``: 256 steps at phase 45's 8,192 fresh lanes (seed 5), best
  of 3, and the launch's build;
- ``p45_sharded``: phase 45's sharded check, ``make_mesh(4)`` at 9 x 2^15
  walks, seed 7;
- ``p20``, ``p20_256``, ``p16_256``: phase 20's solves and 256 steps and
  phase 16's 256 steps (402 rows), which keep the culled build.

With ``--sweep``, a checkout with the large-table build
(``walk_kernel.large_scans``) adds ``sweep:RES``: the topographic survey at resolution ``RES`` (2 m to 5 cm)
with phase 20's 294,912 lanes, 256 steps from seed 5's planes in each of
the two builds of the culled variant in turns (the threshold forced each
way), best of 3, their end planes equal; the threshold
(``LARGE_TABLE_ROWS``) is the least row count at which the large-table
build runs faster. Writes ``chiprun_out/large_table_ab_TAG.json``;
``--compare TAG ...`` prints the runs side by side and checks that every
hash agrees across them. Run parent, change, change, parent in one call:

    for t in "_archive/parent p1" ". c1" ". c2" "_archive/parent p2"; do
        set -- $t; python3 chip_probes/large_table_ab.py $1 $2 --sweep; done
    python3 chip_probes/large_table_ab.py --compare p1 c1 c2 p2
"""

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
SWEEP = (2.0, 1.0, 0.5, 0.4, 1 / 3, 0.25, 0.1, 0.05)


def compare(tags):
    runs = {t: json.load(open(os.path.join(OUT, f"large_table_ab_{t}.json")))
            for t in tags}
    first = runs[tags[0]]
    print(f"card: {first['card']}")
    bad = []
    for key in first["items"]:
        row = [runs[t]["items"].get(key) for t in tags]
        hashes = {json.dumps(r.get("hash")) for r in row if r}
        if len(hashes) != 1 or any(r is None for r in row):
            bad.append(key)
        print(key + ("" if len(hashes) == 1 else "  HASHES DIFFER"))
        for f in [k for k in first["items"][key] if k != "hash"]:
            print(f"  {f:12s} " + " | ".join(
                f"{t}: {json.dumps(r.get(f)) if r else None}"
                for t, r in zip(tags, row)))
    print("every hash equal" if not bad else f"DIFFER: {bad}")
    return 0 if not bad else 1


def run(tree, tag, sweep=False):
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
        topographic_survey_problem
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
    from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
        make_mesh
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
    sys.path.insert(0, os.path.join(ROOT, "chip_probes"))
    from this_checkout import chip_smoke

    assert wk.__file__.startswith(tree), wk.__file__
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    culled = (0, False, False, False, True, True, False, False, False)
    large = hasattr(wk, "large_scans")
    t0 = time.time()
    if large:
        wk.build_library([culled], large=[culled])
    else:
        wk.build_library([culled])
    code = wk.variant_code(culled)
    logs = {"culled": wk.build_logs.get(code, ""),
            "large": wk.build_logs.get(code + 4096, "") if large else ""}
    out = dict(card=card, tree=tree, build_s=time.time() - t0,
               ptxas={k: cs.ptxas_report(v) for k, v in logs.items() if v},
               items={})
    items = out["items"]

    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
        return h.hexdigest()[:16]

    def planes_hash(state):
        return digest(state[k].cpu().numpy() for k in sorted(state))

    def builds():
        return (dict(wk.run_walk.build_launches)
                if hasattr(wk.run_walk, "build_launches")
                else dict(wk.run_walk.variant_launches))

    def solves(solver, pts, n_walks, max_steps, eps, seeds=(1, 2, 3)):
        before = builds()
        r0 = solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                          seed=0)
        rec = dict(warm_hash=digest([r0.mean, r0.stderr, [r0.total_steps]]),
                   s=[], kernel_ms=[], steps=[], hash=[])
        for seed in seeds:
            events = []

            def walk(state, params, n, thr=None):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                wk.run_walk(state, params, n, thr)
                b.record()
                events.append((a, b))
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = solver._solve_raw(pts, n_walks, max_steps, eps, seed,
                                  walk=walk)
            rec["s"].append(time.perf_counter() - t)
            rec["kernel_ms"].append(sum(a.elapsed_time(b)
                                        for a, b in events))
            rec["steps"].append(r.total_steps)
            rec["hash"].append(digest([
                r.mean, r.stderr, r.walk_sum, r.walk_sumsq,
                [r.total_steps, r.max_banked, r.iterations]]))
        rec["rate"] = sum(rec["steps"]) / sum(rec["s"])
        after = builds()
        rec["builds"] = {k: after.get(k, 0) - before.get(k, 0)
                         for k in after if after.get(k, 0) != before.get(k, 0)}
        return rec

    def steps256(state, params, reps=3):
        def once():
            s = {k: v.clone() for k, v in state.items()}
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(s, params, 256)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), s
        once()
        runs = [once() for _ in range(reps)]
        return dict(ms=[round(m, 4) for m, _ in runs],
                    build=getattr(params, "build_name", params.kernel_name),
                    hash=planes_hash(runs[0][1]))

    args = (cs.P2_WALKS, cs.P2_MAX_STEPS, cs.P2_EPS)
    prob, h = topographic_survey_problem(resolution=0.05)
    pts = drape_electrodes(h, cs.TOPO_XS, nudge=0.5)
    opts = SolverOptions(target_slots=1 << 21)
    s45 = WoStSolver(prob, opts, device=dev)
    items["p45"] = solves(s45, pts, *args)
    st, p = s45._setup(pts, *args, 5)[:2]
    items["p45_256"] = steps256({k: v[:64].clone() for k, v in st.items()},
                                p)
    kw = dict(n_walks=1 << 15, max_steps=cs.P2_MAX_STEPS, eps=cs.P2_EPS,
              seed=7)
    sharded = ShardedWoStSolver(prob, make_mesh(4), opts)
    t = time.perf_counter()
    r = sharded.solve(pts, **kw)
    items["p45_sharded"] = dict(s=time.perf_counter() - t,
                                stats=sharded.last_solve_stats,
                                hash=digest([r.mean, r.stderr,
                                             [r.total_steps]]))
    topo, h20 = topographic_survey_problem()
    pts20 = drape_electrodes(h20, cs.TOPO_XS, nudge=0.5)
    s20 = WoStSolver(topo, opts, device=dev)
    items["p20"] = solves(s20, pts20, *args, seeds=(1, 2))
    st, p = s20._setup(pts20, *args, 5)[:2]
    items["p20_256"] = steps256(st, p)
    s16 = WoStSolver(topo, SolverOptions(target_slots=8192), device=dev)
    st, p = s16._setup(pts20, 8192, 600, 0.5, 3)[:2]
    items["p16_256"] = steps256(st, p)
    if large and sweep:
        sweep = out["sweep"] = {}
        keep = wk.LARGE_TABLE_ROWS
        for res in SWEEP:
            pr, hr = topographic_survey_problem(resolution=res)
            ptr = drape_electrodes(hr, cs.TOPO_XS, nudge=0.5)
            st, p = WoStSolver(pr, opts, device=dev)._setup(ptr, *args,
                                                            5)[:2]
            ms, hashes = {False: [], True: []}, {}
            for rep in range(4):
                for big in (False, True):
                    wk.LARGE_TABLE_ROWS = 0 if big else 1 << 30
                    p._cache.clear()
                    assert p.large == big
                    r = steps256(st, p, reps=1)
                    if rep:  # the first of each, a warm-up
                        ms[big].append(r["ms"][0])
                    hashes[big] = r["hash"]
            wk.LARGE_TABLE_ROWS = keep
            p._cache.clear()
            sweep[res] = dict(rows=wk.geometry_size(pr),
                              neu=len(p.neu_table), vert=len(p.vert_table),
                              culled_ms=ms[False], large_ms=ms[True],
                              equal=hashes[False] == hashes[True])
            print(f"{tag} sweep {res} m: {sweep[res]}", flush=True)
            assert hashes[False] == hashes[True], res
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"large_table_ab_{tag}.json"), "w") as f:
        json.dump(out, f, default=str)
    for k, v in items.items():
        print(tag, k, {f: v[f] for f in v if f != "hash"}, flush=True)
    print(tag, "ptxas", out["ptxas"], flush=True)
    print(f"{tag}: {len(items)} items in {time.time() - t0:.1f} s "
          f"(builds {out['build_s']:.1f} s; {card})", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    run(os.path.abspath(sys.argv[1]), sys.argv[2], "--sweep" in sys.argv[3:])
