#!/usr/bin/env python3
"""K9's fused sharded launch and the table form's culled scans against a
parent checkout, A/B on one card, bit for bit.

One run times one checkout (``TREE``, with its own package) at
``chip_smoke.py``'s full-size states, and hashes every result:

- ``p6``: phase 6's survey (147,456 lanes), a warm-up and solves with
  seeds 1 and 2;
- ``p38_survey``, ``p38_flagship``: phase 38's 4-shard meshes on the card
  (the survey, and the flagship with the split without the freeze), the
  same solves, and 256 steps of the four shards from seed 5's planes: one
  fused launch where the checkout fuses them, else four in turn;
- ``p20``, ``p41``: phase 20's terrain and phase 41's terrain with the
  flagship's estimator (294,912 lanes), the same solves, and 256 steps from
  seed 5's planes (best of 3; phase 41 at the freeze 4.0);
- ``p18``: phase 18's chain on the table form (8,192 lanes), 256 steps and
  its 9 x 512 solve; ``p16``: phase 16's table form at 8,192 lanes, 256
  steps; ``p42:NAME``: the sweep's table-form variants, 64 steps;
- ``p11_256``, ``p15_256``: 256 steps of builds the change must leave as
  they were, the accuracy path's (phase 11) and the flagship's at the
  freeze 4.0 (phase 15), 688,128 lanes each.

Each solve gives its wall time, its kernel time (CUDA events around every
launch), steps, launches, clones (per shard on a mesh), ``max_banked`` and
a hash of its means and stderrs; each launch its time and a hash of its
end planes. Writes ``chiprun_out/k9_table_ab_TAG.json``. ``--compare
TAG ...`` prints the runs side by side and checks that every hash agrees
across them. Run parent, change, change, parent in one call:

    for t in "_archive/parent p1" ". c1" ". c2" "_archive/parent p2"; do
        set -- $t; python3 chip_probes/k9_table_ab.py $1 $2; done
    python3 chip_probes/k9_table_ab.py --compare p1 c1 c2 p2
"""

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")


def compare(tags):
    runs = {t: json.load(open(os.path.join(OUT, f"k9_table_ab_{t}.json")))
            for t in tags}
    first = runs[tags[0]]
    print(f"card: {first['card']}")
    bad = []
    for key in first["items"]:
        row = [runs[t]["items"].get(key) for t in tags]
        hashes = {json.dumps(r.get("hash")) for r in row if r}
        if len(hashes) != 1 or any(r is None for r in row):
            bad.append(key)
        fields = [k for k in first["items"][key] if k not in ("hash",)]
        print(key + ("" if len(hashes) == 1 else "  HASHES DIFFER"))
        for f in fields:
            print(f"  {f:12s} " + " | ".join(
                f"{t}: {json.dumps(r.get(f)) if r else None}"
                for t, r in zip(tags, row)))
    print("every hash equal" if not bad else f"DIFFER: {bad}")
    return 0 if not bad else 1


def run(tree, tag):
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
        geophysical_scenario, notebook_survey, topographic_survey_problem
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
    from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
        make_mesh
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu_torch.survey import survey_default_options
    sys.path.insert(0, os.path.join(ROOT, "chip_probes"))
    from this_checkout import chip_smoke

    assert wk.__file__.startswith(tree), wk.__file__
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    sweep = [c for c in cs.SWEEP if c[1][4]]
    t0 = time.time()
    cs.build_variants(wk, cs.PATH_VARIANTS + tuple(
        c[1] for c in sweep) + ((0, True, True, True, True, True, False,
                                 False, False),))
    out = dict(card=card, tree=tree, build_s=time.time() - t0, items={})

    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
        return h.hexdigest()[:16]

    def planes_hash(state):
        return digest(state[k].cpu().numpy() for k in sorted(state))

    def solves(solver, pts, n_walks, max_steps, eps):
        solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                     seed=0)
        rec = dict(s=[], kernel_ms=[], steps=[], stats=[], max_banked=[],
                   hash=[])
        for seed in (1, 2):
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
            rec["stats"].append(getattr(solver, "last_solve_stats", None))
            rec["max_banked"].append(r.max_banked)
            rec["hash"].append(digest([
                r.mean, r.stderr, r.walk_sum, r.walk_sumsq,
                [r.total_steps, r.max_banked, r.iterations],
                np.frombuffer(json.dumps(rec["stats"][-1]).encode(),
                              np.uint8)]))
        rec["rate"] = sum(rec["steps"]) / sum(rec["s"])
        return rec

    def steps256(state, params, n=256, thr=None, reps=3):
        def once():
            s = {k: v.clone() for k, v in state.items()}
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(s, params, n, thr)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), s
        once()
        runs = [once() for _ in range(reps)]
        return dict(ms=[round(m, 4) for m, _ in runs],
                    hash=planes_hash(runs[0][1]))

    def shards256(solver, pts, n_walks, max_steps, eps):
        """256 steps of the mesh's four shards from seed 5's planes: one
        fused launch where the checkout fuses, else four in turn."""
        plan = solver._plan(pts, n_walks, max_steps, eps, 5)
        shards = [solver._shard(plan, d) for d in range(4)]
        if hasattr(solver, "_groups"):
            (g,) = solver._groups(plan, shards)
            launches = [(g.state, g.params)]
        else:
            launches = [(s.state, s.params) for s in shards]

        def once():
            ss = [({k: v.clone() for k, v in st.items()}, p)
                  for st, p in launches]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for st, p in ss:
                wk.run_walk(st, p, 256)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), ss
        once()
        runs = [once() for _ in range(3)]
        ends = runs[0][1]
        flat = {k: torch.cat([st[k].reshape(-1) for st, _ in ends])
                for k in ends[0][0]}
        return dict(ms=[round(m, 4) for m, _ in runs],
                    launches=len(launches),
                    lanes=sum(st["px"].numel() for st, _ in launches),
                    hash=planes_hash(flat))

    items = out["items"]
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    prob = survey.build_problem()
    pts6 = cs.survey_points(electrodes, -0.5)
    opts6 = SolverOptions(target_slots=1 << 21, min_quota=32,
                          rejection_rounds=1)
    args6 = (pts6, 1 << 19, 500, 0.9)
    items["p6"] = solves(WoStSolver(prob, opts6, device=dev), *args6)
    mesh = make_mesh(4)
    s38 = ShardedWoStSolver(prob, mesh, opts6)
    items["p38_survey"] = solves(s38, *args6)
    items["p38_survey_256"] = shards256(s38, *args6)
    nb, nb_el = notebook_survey()
    nb.local_majorant = "auto"
    nb.source_mis = True
    nb_pts = np.asarray(nb_el, np.float32)
    s38f = ShardedWoStSolver(nb.build_problem(), mesh, survey_default_options(
        target_slots=1 << 21, min_quota=32, split_threshold=4.0))
    args38f = (nb_pts, 1 << 20, 6000, 1.0)
    items["p38_flagship"] = solves(s38f, *args38f)
    items["p38_flagship_256"] = shards256(s38f, *args38f)
    topo, h = topographic_survey_problem()
    topo_pts = drape_electrodes(h, cs.TOPO_XS, nudge=0.5)
    s20 = WoStSolver(topo, SolverOptions(target_slots=1 << 21), device=dev)
    args20 = (topo_pts, cs.P2_WALKS, cs.P2_MAX_STEPS, cs.P2_EPS)
    items["p20"] = solves(s20, *args20)
    st, p = s20._setup(*args20, 5)[:2]
    items["p20_256"] = steps256(st, p)
    flag, _ = cs.terrain_flagship_problem()
    s41 = WoStSolver(flag, survey_default_options(
        target_slots=1 << 21, split_threshold=cs.P2_SPLIT), device=dev)
    items["p41"] = solves(s41, *args20)
    st, p = s41._setup(*args20, 5)[:2]
    items["p41_256"] = steps256(st, p, thr=cs.P2_SPLIT)
    small = dict(half_width=100.0, depth=150.0)
    prob18, h18 = topographic_survey_problem(resolution=4.0, **small)
    pts18 = drape_electrodes(h18, cs.TOPO_XS, nudge=0.5)
    s18 = WoStSolver(prob18, SolverOptions(robin_correction="chain",
                                           target_slots=8192), device=dev)
    st, p = s18._setup(pts18, 8192, 600, 0.5, 3)[:2]
    items["p18_256"] = steps256(st, p)
    items["p18_solve"] = solves(WoStSolver(prob18, SolverOptions(
        robin_correction="chain"), device=dev), pts18, 512, 600, 0.5)
    s16 = WoStSolver(topo, SolverOptions(target_slots=8192), device=dev)
    st, p = s16._setup(topo_pts, 8192, 600, 0.5, 3)[:2]
    items["p16_256"] = steps256(st, p)
    acc, _ = notebook_survey()
    acc.local_majorant = "auto"
    st, p = acc.make_solver(survey_default_options(
        target_slots=1 << 21, min_quota=32), device=dev)._setup(
        nb_pts, 1 << 20, 6000, 1.0, 5)[:2]
    items["p11_256"] = steps256(st, p)
    s15 = WoStSolver(nb.build_problem(), survey_default_options(
        target_slots=1 << 21, min_quota=32, split_threshold=4.0), device=dev)
    st, p = s15._setup(nb_pts, 1 << 20, 6000, 1.0, 5)[:2]
    items["p15_256"] = steps256(st, p, thr=4.0)
    for case in sweep:
        spec = cs.sweep_spec(case)
        solver = WoStSolver(cs.sweep_problem(spec), cs.sweep_options(
            spec, target_slots=8192), device=dev)
        st, p = solver._setup(cs.SWEEP_POINTS, 1 << 13, cs.SWEEP_MAX_STEPS,
                              cs.SWEEP_EPS, 3)[:2]
        items[f"p42:{case[0]}"] = steps256(
            st, p, n=64, thr=spec["split"] if p.freeze else None)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"k9_table_ab_{tag}.json"), "w") as f:
        json.dump(out, f)
    print(f"{tag}: {len(items)} items in {time.time() - t0:.1f} s "
          f"(builds {out['build_s']:.1f} s; {card})", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    run(os.path.abspath(sys.argv[1]), sys.argv[2])
