#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``dcrmontecarlo_tpu_torch`` through the DCR-survey forward solve,
its main path, in seven phases, each reported on its own line:

1. environment: torch, CUDA, nvcc and the card (name and power limit);
2. build of the walk kernel from ``csrc/walk_kernel.cu``;
3. kernel vs plain version, one 32-step launch at 8,192 lanes of the
   survey problem with its default options (``walk_kernel.compare_planes``:
   every plane agrees on >= 99% of lanes to rel 1e-4 above a floor of
   1e-6 x the plane's largest value);
4. kernel vs plain version, a whole solve of 9 points x 512 walks: both
   draw the same counter-hash streams, so total steps must be equal and
   each mean within 1e-3 x (|mean| + combined stderr);
5. physics: the survey against the finite-volume oracle (>= 8/9
   electrodes within 4 sigma + 2e-4);
6. full size: the benchmark configuration (9 points x 2^19 walks,
   147,456 walker lanes) through ``WoStSolver.solve``, walker-steps/s;
7. kernel vs plain version for 256 steps at the full-size state of
   phase 6 (rounds 1, no CRN or roulette): both timed, then held to the
   rule of phase 3. The kernels' record takes its numbers from here.

The second to last line of standard output is the card's
``nvidia-smi --query-gpu=name,power.limit`` line, the line before it the
kernels' JSON record, and the last line ``{"ok": true, "device": ...}``.
Any failure exits non-zero before that line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.

    python3 chip_smoke.py              # every phase, on one GPU
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NVSMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def survey_points(electrodes, y):
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = y
    return pts


def check_planes(wk, a, b, names, what):
    """Hold two walker states to ``walk_kernel.compare_planes``'s rule;
    returns (worst plane's agreeing fraction, max |err| on agreeing
    lanes)."""
    frac, max_err, finite = wk.compare_planes(a, b, names)
    check(finite, f"{what}: a plane holds non-finite values")
    worst = min(frac, key=frac.get)
    check(frac[worst] >= wk.PLANE_MIN_FRAC,
          f"{what}: plane {worst} agrees on only {frac[worst]:.4f} of "
          f"lanes (need {wk.PLANE_MIN_FRAC})")
    return frac[worst], max_err


def clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def cuda_ms(fn, reps=1):
    """Milliseconds per call of ``fn`` on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)

    from dcrmontecarlo_tpu_torch.models import geophysical_scenario
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    from dcrmontecarlo_tpu_torch.survey import survey_default_options

    check("jax" not in sys.modules, "jax was imported")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    nvsmi = subprocess.run(NVSMI_QUERY, capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    check(bool(nvsmi), "nvidia-smi gave no card line")
    card = nvsmi[0].strip()
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    t_start = time.perf_counter()

    # ---- 1. environment ------------------------------------------------
    nvcc = subprocess.run([wk._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} x{torch.cuda.device_count()} | card: {card} | "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # ---- 2. build -------------------------------------------------------
    so, build_s, build_log = wk.build_library()
    regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    log(f"[2] built {os.path.relpath(so, ROOT)} in {build_s:.1f} s; "
        f"ptxas: {' | '.join(regs) or 'cached build'}")

    # ---- 3. kernel vs plain, one launch, survey defaults --------------
    solver = WoStSolver(survey.build_problem(),
                        survey_default_options(target_slots=8192),
                        device=dev)
    state, params, _, _ = solver._setup(survey_points(electrodes, -0.1),
                                        8192, 500, 0.9, 3)
    check(state["px"].numel() == 8192, "phase 3 state is not 8192 lanes")
    wk.walk_plain(state, params, 200)      # reach mid-walk states
    ref = clone_state(state)
    before = wk.run_walk.launches
    wk.run_walk(state, params, 32)
    torch.cuda.synchronize()
    check(wk.run_walk.launches == before + 1, "launch count did not grow")
    wk.walk_plain(ref, params, 32)
    worst, max_err = check_planes(wk, state, ref, state_planes(params.n_src),
                                  "phase 3")
    log(f"[3] one 32-step launch, 8192 lanes, survey defaults: worst plane "
        f"agreement {worst:.5f}, max |err| on agreeing lanes {max_err:.3g}")

    # ---- 4. kernel vs plain, whole solve ------------------------------
    solver = WoStSolver(survey.build_problem(), survey_default_options(),
                        device=dev)
    pts = survey_points(electrodes, -0.1)
    rk = solver._solve_raw(pts, 512, 500, 0.9, 11)
    rp = solver._solve_raw(pts, 512, 500, 0.9, 11, walk=wk.walk_plain)
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "kernel solve not finite")
    # the same counter-hash streams on both sides: the means differ by the
    # rounding of the sums alone, the step counts not at all
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"total steps differ: {rk.total_steps} vs {rp.total_steps}")
    log(f"[4] solve 9x512: max |dmean| {float(dm.max()):.3g}, max "
        f"|dmean|/(|mean|+se) {float((dm / scale).max()):.3g} (bound 1e-3), "
        f"max se {float(rp.stderr.max()):.3g}, steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}")

    # ---- 5. physics: finite-volume oracle ------------------------------
    # The oracle is loaded by path, not through its package (whose
    # __init__ imports jax): validation/fdm.py must import only numpy and
    # scipy, which tests/test_torch_hygiene.py checks.
    spec = importlib.util.spec_from_file_location(
        "fdm", os.path.join(ROOT, "dcrmontecarlo_tpu", "validation",
                            "fdm.py"))
    fdm_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fdm_mod)
    res = survey.run(electrodes, n_walks=1500, max_steps=800, eps=0.5,
                     seed=0, options=SolverOptions(target_slots=16384),
                     device=dev)
    prob = survey.build_problem()

    def np_field(f):
        return lambda X, Y: f(torch.as_tensor(X, dtype=torch.float32),
                              torch.as_tensor(Y, dtype=torch.float32)
                              ).numpy()

    fdm = fdm_mod.fdm_solve(bounds=((-100.0, 100.0), (-200.0, 0.0)),
                            alpha=np_field(prob.alpha),
                            source=np_field(prob.source),
                            neumann_top=True, nx=321, ny=321)
    ref = fdm(res.electrodes)
    err = np.abs(res.potentials - ref)
    tol = 4.0 * res.potentials_stderr + 2e-4
    n_ok = int((err < tol).sum())
    check(n_ok >= 8, f"only {n_ok}/9 electrodes match the oracle: "
                     f"{res.potentials} vs {ref}")
    log(f"[5] oracle gate: {n_ok}/9 electrodes within 4 sigma + 2e-4")

    # ---- 6. full size: the main path ----------------------------------
    full = SolverOptions(target_slots=1 << 21, min_quota=32,
                         rejection_rounds=1)
    solver = WoStSolver(survey.build_problem(), full, device=dev)
    pts = survey_points(electrodes, -0.5)
    n_walks, max_steps, eps = 1 << 19, 500, 0.9
    wk.run_walk.launches = 0
    solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                 seed=0)                                       # warm-up
    steps, times, lane_steps = 0.0, [], 0.0
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(pts, n_walks=n_walks, max_steps=max_steps,
                           eps=eps, seed=rep + 1)
        times.append(time.perf_counter() - t0)
        steps += res.total_steps
        lane_steps += 147456.0 * res.iterations
        check(np.isfinite(res.mean).all()
              and np.isfinite(res.stderr).all(), "full solve not finite")
    launches = wk.run_walk.launches
    check(launches > 0, "the full-size solve never launched the kernel")
    rate = steps / sum(times)
    log(f"[6] full size 9x{n_walks} walks, 147456 lanes: "
        f"dcr_survey_walker_steps_per_sec_per_chip {rate:.6g} "
        f"s/solve {times} steps/solve {steps / 3:.6g} "
        f"longest lane {res.iterations} steps, lane occupancy "
        f"{steps / lane_steps:.4f}, launches {launches} ({card})")

    # ---- 7. kernel vs plain at the full-size state ---------------------
    state, params, _, bound = solver._setup(pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 147456, "full state is not 147456 lanes")
    ks, ps = clone_state(state), clone_state(state)
    # warm both paths once, then time the same 256 steps from one state
    wk.run_walk(clone_state(state), params, 16)
    wk.walk_plain(clone_state(state), params, 16)
    ms = cuda_ms(lambda: wk.run_walk(ks, params, 256))
    plain_ms = cuda_ms(lambda: wk.walk_plain(ps, params, 256))
    worst, max_err = check_planes(wk, ks, ps, state_planes(params.n_src),
                                  "phase 7")
    # the whole solve's single launch, for the kernel's share of a solve
    solve_ms = cuda_ms(lambda: wk.run_walk(state, params, bound))
    log(f"[7] 256 steps x 147456 lanes: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms ({plain_ms / ms:.1f}x); worst plane agreement "
        f"{worst:.5f}, max |err| on agreeing lanes {max_err:.3g}; one "
        f"whole-solve launch {solve_ms:.3f} ms ({card})")
    record = {"name": "walk_kernel", "route": "cuda",
              "source": "dcrmontecarlo_tpu_torch/csrc/walk_kernel.cu",
              "replaces": "dcrmontecarlo_tpu/ops/pallas_walk.py:1295",
              "launches": launches, "max_abs_err": max_err, "ms": ms,
              "plain_ms": plain_ms, "agree_frac": worst,
              "tolerance": f">={wk.PLANE_MIN_FRAC:.0%} of lanes per plane "
                           f"within rel {wk.PLANE_RTOL:g} + "
                           f"{wk.PLANE_FLOOR:g} x plane max"}

    log(f"total {time.perf_counter() - t_start:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
