#!/usr/bin/env python3
"""The repack loop on the builds that run one thread a lane, A/B on one
card, each held to the one-thread loop bit for bit.

``csrc/walk_kernel.cu`` runs the repack loop (``walk_repacked``) in the
builds of ``walk_variant.h::repacked`` (the freeze builds, and the chain +
MIS builds without the freeze); the others keep one thread a lane for the
whole launch. This probe asks whether that fork pays. It copies the
checkout's ``csrc/`` with the repack loop switched on for every build (a
launch
without the freeze passes ``thr = +inf``, so the loop's freeze test never
fires), builds the non-freeze variants of ``chip_smoke.py``'s full-size
paths from both sources in parallel, and runs each library through this
checkout's wrapper on the same state (seed 5):

- ``survey``: the main path (phases 6 and 38's variant);
- ``accuracy``: the accuracy path (phase 11);
- ``flagship_no_freeze``: the flagship's switches without the freeze (the
  sharded flagship's variant);
- ``line``: the notebook pseudosection, the wide form (phase 30);
- ``no_delta``: the short-walk harmonic preset (phase 25).

For each: 256 steps (best of 3) in turns, one-thread, repack, repack,
one-thread, and whether every run's end planes equal the first's on every
lane; then the accuracy path's solve at seed 1 in the same turns (s,
kernel ms from CUDA events, steps, launches, and whether the means and
stderrs are equal). Writes ``chiprun_out/repack_on_plain_builds.json``.

    python3 chip_probes/repack_on_plain_builds.py
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.geometry import square_loop  # noqa: E402
from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.problems import Problem, fields  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.solver.state import state_planes  # noqa
from dcrmontecarlo_tpu_torch.survey import dcr as sdcr  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa
import chip_smoke as cs  # noqa: E402
from repack_tuning import WORK, build, use  # noqa: E402

# the repack loop for every build
FORCE = (("  if constexpr (repacked(ROBIN, MIS, FREEZE)) {\n    walk_repacked",
          "  if constexpr (true) {\n    walk_repacked"),
         ("__launch_bounds__(repacked(ROBIN, MIS, FREEZE)\n"
          "                                      ? REPACK_THREADS\n"
          "                                      : THREADS)",
          "__launch_bounds__(REPACK_THREADS)"),
         ("constexpr bool REPACKED = repacked(WALK_ROBIN, WALK_MIS != 0, "
          "WALK_FREEZE != 0);", "constexpr bool REPACKED = true;"))
TURNS = ("one_thread", "repack", "repack", "one_thread")


def forced_source():
    dst = WORK / "repack_everywhere"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(wk._SRC.parent, dst)
    src = (dst / "walk_kernel.cu").read_text()
    for old, new in FORCE:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (dst / "walk_kernel.cu").write_text(src)
    return dst


def groups(dev):
    """``name: (solver, points, n_walks, max_steps, eps)``."""
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    main = WoStSolver(survey.build_problem(), SolverOptions(
        target_slots=1 << 21, min_quota=32, rejection_rounds=1), device=dev)
    full = survey_default_options(target_slots=1 << 21, min_quota=32)
    nb, nb_pts = notebook_survey()
    nb_pts = np.asarray(nb_pts, np.float32)
    nb.local_majorant = "auto"
    accuracy = nb.make_solver(full, device=dev)
    nb.source_mis = True
    flagship = nb.make_solver(full, device=dev)
    line_survey, line_elec = notebook_survey()
    line_survey.source_mis = True
    line_prob, line_pts, _, _ = sdcr._line_problem(line_survey, line_elec, 8)
    line = WoStSolver(line_prob, SolverOptions(
        target_slots=1 << 21, min_quota=32, common_random_numbers=True),
        device=dev)
    harmonic = WoStSolver(Problem(
        dirichlet=square_loop(1.0),
        bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 2.0})),
        SolverOptions(target_slots=1 << 19, min_quota=32), device=dev)
    return dict(
        survey=(main, cs.survey_points(electrodes, -0.5), 1 << 19, 500, 0.9),
        accuracy=(accuracy, nb_pts, 1 << 20, 6000, 1.0),
        flagship_no_freeze=(flagship, nb_pts, 1 << 20, 6000, 1.0),
        line=(line, line_pts, 1 << 20, 6000, 1.0),
        no_delta=(harmonic, np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]],
                                     np.float32), 1 << 21, 200, 1e-3))


def steps256(state, params):
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
    ms, end = min((once() for _ in range(3)), key=lambda r: r[0])
    return ms, hashlib.sha256(b"".join(
        end[k].cpu().numpy().tobytes()
        for k in state_planes(params.n_src))).hexdigest()[:16]


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {"one_thread": wk._SRC.parent, "repack": forced_source()}
    made = groups(dev)
    states = {}
    for name, (solver, pts, n_walks, max_steps, eps) in made.items():
        state, params, _, _ = solver._setup(pts, n_walks, max_steps, eps, 5)
        assert not params.freeze, name
        states[name] = state, params
    variants = {p.variant for _, p in states.values()}

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = {(tag, v): pool.submit(build, tag, csrc, v)
                for tag, csrc in sources.items() for v in variants}
        built = {k: f.result() for k, f in jobs.items()}
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s "
          f"({card})", flush=True)
    for (tag, v), (_, report) in sorted(built.items(),
                                        key=lambda kv: kv[0][0]):
        print(tag, wk.kernel_name(v), report, flush=True)

    def libraries(tag):
        use({wk.variant_code(v): built[(tag, v)][0] for v in variants})

    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  groups={})
    for name, (state, params) in states.items():
        runs = []
        for tag in TURNS:
            libraries(tag)
            runs.append((tag, *steps256(state, params)))
        equal = len({h for _, _, h in runs}) == 1
        record["groups"][name] = dict(kernel=params.kernel_name,
                                      lanes=state["px"].numel(), runs=runs,
                                      equal=equal)
        print(f"{name} ({params.kernel_name}, {state['px'].numel()} lanes): "
              f"256 steps ms {[(t, round(ms, 4)) for t, ms, _ in runs]}; "
              f"end planes {'equal' if equal else 'DIFFER'} ({card})",
              flush=True)

    solver, pts, n_walks, max_steps, eps = made["accuracy"]
    solves, first = [], None
    for tag in TURNS:
        libraries(tag)
        events = []

        def timed(state, params, n, thr=None):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(state, params, n, thr)
            b.record()
            events.append((a, b))
            return state

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver._solve_raw(pts, n_walks, max_steps, eps, 1, walk=timed)
        wall = time.perf_counter() - t0
        kern = sum(a.elapsed_time(b) for a, b in events)
        key = (res.total_steps, solver.last_solve_stats["launches"],
               np.asarray(res.mean).tobytes(),
               np.asarray(res.stderr).tobytes())
        first = first or key
        solves.append(dict(tag=tag, s=wall, kernel_ms=kern,
                           steps=float(res.total_steps),
                           launches=solver.last_solve_stats["launches"],
                           equal=key == first))
        print(f"accuracy solve seed 1, {tag}: {wall:.4f} s, kernel "
              f"{kern:.1f} ms, {res.total_steps:.0f} steps, "
              f"{solver.last_solve_stats['launches']} launches; means and "
              f"stderrs {'equal to' if key == first else 'DIFFER from'} the "
              f"first ({card})", flush=True)
    record["accuracy_solve"] = solves
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "repack_on_plain_builds.json", "w") as f:
        json.dump(record, f)


if __name__ == "__main__":
    main()
