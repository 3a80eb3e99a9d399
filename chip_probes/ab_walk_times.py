#!/usr/bin/env python3
"""256-step walk-kernel times of one checkout, for A/B runs on one card.

Builds the checkout's kernels and times 256 steps (best of 3, CUDA events)
at the full-size states of ``chip_smoke.py``: the survey (phase 7) and
the survey with MIS at its state, the accuracy path (phase 11) and the
reflectance fold at its state, the flagship with the freeze at 4 (phase
15), the short walk without delta tracking (phase 25), and the wall time
of one
accuracy-path solve and of two flagship solves (seeds 1 and 2, after a
warm-up). To compare two commits, unpack the other into a git-ignored
folder (``git archive <commit> | tar -x -C _archive/parent``) and run both
in one call, in turns:

    for t in "_archive/parent parent1" ". change1" ". change2" \\
             "_archive/parent parent2"; do
        set -- $t; python3 chip_probes/ab_walk_times.py $1 $2; done

Two more arguments time only some groups (``survey``, ``no_delta``,
``accuracy``, ``flagship``, comma-separated), each 256-step time that many
times over (every sample a best of 3), for the spread of one
instantiation: ``ab_walk_times.py . change1 no_delta 10``.
"""

import os
import sys
import time
import dataclasses

tree = os.path.abspath(sys.argv[1])
tag = sys.argv[2]
only = sys.argv[3].split(",") if len(sys.argv) > 3 else None
rounds = int(sys.argv[4]) if len(sys.argv) > 4 else 1
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.geometry import square_loop  # noqa: E402
from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey  # noqa: E402
from dcrmontecarlo_tpu_torch.problems import Problem, fields  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa

assert wk.__file__.startswith(tree), wk.__file__
dev = torch.device("cuda", 0)
from this_checkout import chip_smoke  # noqa: E402

build_variants = chip_smoke().build_variants

t0 = time.time()
build_variants(wk)
build_s = time.time() - t0


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def best_of_3(state, params, thr):
    out = []
    for _ in range(3):
        s = clone(state)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wk.run_walk(s, params, 256, freeze_thr=thr)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return min(out)


def best_256(state, params, thr=None):
    wk.run_walk(clone(state), params, 16, freeze_thr=thr)
    if rounds == 1:
        return best_of_3(state, params, thr)
    samples = [best_of_3(state, params, thr) for _ in range(rounds)]
    spread.append((params.kernel_name, [round(v, 4) for v in samples]))
    return float(np.median(samples))


def want(group):
    return only is None or group in only


res, spread = {}, []
if want("survey"):
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = -0.5
    solver = WoStSolver(survey.build_problem(), SolverOptions(
        target_slots=1 << 21, min_quota=32, rejection_rounds=1), device=dev)
    state, params, _, _ = solver._setup(pts, 1 << 19, 500, 0.9, 5)
    res["survey"] = best_256(state, params)
    survey.source_mis = True
    solver = WoStSolver(survey.build_problem(), solver.options, device=dev)
    state, params, _, _ = solver._setup(pts, 1 << 19, 500, 0.9, 5)
    res["survey_mis"] = best_256(state, params)
if want("no_delta"):
    harmonic = Problem(dirichlet=square_loop(1.0),
                       bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                       (0, 1): 2.0}))
    solver = WoStSolver(harmonic, SolverOptions(target_slots=1 << 19,
                                                min_quota=32), device=dev)
    state, params, _, _ = solver._setup(
        np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]], np.float32), 1 << 21,
        200, 1e-3, 5)
    res["no_delta"] = best_256(state, params)
nb, nb_pts = notebook_survey()
nb.local_majorant = "auto"
nb_pts = np.asarray(nb_pts, np.float32)
full = survey_default_options(target_slots=1 << 21, min_quota=32)
if want("accuracy"):
    solver = nb.make_solver(full, device=dev)
    state, params, _, _ = solver._setup(nb_pts, 1 << 20, 6000, 1.0, 5)
    res["accuracy"] = best_256(state, params)
    res["reflectance"] = best_256(state, dataclasses.replace(
        params, robin=wk.ROBIN_REFLECTANCE))
    solver.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0, seed=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    solver.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0, seed=1)
    res["accuracy_solve_s"] = time.perf_counter() - t
if want("flagship"):
    nb.source_mis = True
    solver = nb.make_solver(dataclasses.replace(full, split_threshold=4.0),
                            device=dev)
    state, params, _, _ = solver._setup(nb_pts, 1 << 20, 6000, 1.0, 5)
    res["flagship"] = best_256(state, params, thr=4.0)
    solver.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0, seed=0)
    for seed in (1, 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solver.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0,
                     seed=seed)
        res[f"flagship_solve_s{seed}"] = time.perf_counter() - t
print(tag, f"build {build_s:.1f} s",
      {k: round(v, 3) for k, v in res.items()}, torch.cuda.get_device_name(0),
      flush=True)
for name, samples in spread:
    print(tag, name, "256-step samples (ms, each a best of 3):", samples,
          flush=True)
