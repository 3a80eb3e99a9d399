#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``dcrmontecarlo_tpu_torch`` through its two paths, each on the
kernel variant it runs: the DCR-survey forward solve (phases 3-7) and the
1000 m notebook survey's accuracy path, the Robin chord chain with the
two-level local majorant (phases 8-11). Each phase reports on its own line:

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
   rule of phase 3. The survey variant's record takes its numbers from
   here.
8. kernel vs plain version, one 32-step launch at 8,192 lanes of the
   notebook accuracy configuration (``local_majorant="auto"``, survey
   defaults) after 200 plain steps, with the chord chain and with the
   reflectance fold, under the rule of phase 3; and each mechanism ran:
   the same launch with the Robin correction, or the majorant, switched
   off differs on >= 1% of lanes in ``atten`` or ``px``;
9. kernel vs plain version, a whole solve of 21 points x 512 walks at the
   accuracy configuration: equal total steps, each mean within
   1e-3 x (|mean| + combined stderr);
10. physics: the ``bench.py --preset accuracy`` configuration (8 seeds x
    4096 walks, ``target_slots=1<<17``) through ``DCRSurvey.run`` at the
    survey's electrodes, against the pinned 401^2 finite-volume oracle
    (``validation/pins/notebook_oracle.npz``); every seed must hold all 20
    dipole voltages within 4 sigma + 0.25, a median signed potential error
    in (-25, +3) and >= 19/21 potentials within 4 sigma + 3.5;
11. full size of the accuracy path: 21 points x 2^20 walks,
    ``target_slots=1<<21, min_quota=32`` (688,128 lanes), one warm-up and
    3 timed solves (walker-steps/s, s/solve, lane occupancy), then 256
    steps of kernel and plain version at that state, timed and held to
    the rule of phase 3 (on the first 147,456 lanes if the plain version
    would take over 30 s). The accuracy variant's record takes its
    numbers from here.

The second to last line of standard output is the card's
``nvidia-smi --query-gpu=name,power.limit`` line, the line before it the
kernels' JSON record (one entry per kernel variant), and the last line
``{"ok": true, "device": ...}``.
Any failure exits non-zero before that line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.

    python3 chip_smoke.py              # every phase, on one GPU
"""

import dataclasses
import importlib.util
import json
import os
import re
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


def ptxas_registers(build_log):
    """Registers per compiled kernel instantiation, from ``ptxas -v``:
    ``{"<robin>,<majorant>": n}`` (template arguments of walk_kernel)."""
    regs, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            t = re.search(r"walk_kernelILi(\d)ELb(\d)E", entry)
            regs[f"{t.group(1)},{t.group(2)}" if t else entry] = \
                int(m.group(1))
            entry = None
    return regs


def lanes_differ(a, b):
    """Share of lanes whose ``atten`` or ``px`` differ between two states."""
    d = (a["atten"] != b["atten"]) | (a["px"] != b["px"])
    return float(d.double().mean())


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

    from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
        notebook_survey
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
    regs = ptxas_registers(build_log)
    check(len(regs) == 6 or not build_log,
          f"expected 6 kernel instantiations, ptxas reported {regs}")
    log(f"[2] built {os.path.relpath(so, ROOT)} in {build_s:.1f} s; "
        f"ptxas registers per walk_kernel<robin,majorant>: "
        f"{regs or 'cached build'}")

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
    tolerance = (f">={wk.PLANE_MIN_FRAC:.0%} of lanes per plane within "
                 f"rel {wk.PLANE_RTOL:g} + {wk.PLANE_FLOOR:g} x plane max")
    records = [{"name": "walk_kernel", "variant": "survey", "route": "cuda",
                "source": "dcrmontecarlo_tpu_torch/csrc/walk_kernel.cu",
                "replaces": "dcrmontecarlo_tpu/ops/pallas_walk.py:1295",
                "launches": launches, "max_abs_err": max_err, "ms": ms,
                "plain_ms": plain_ms, "agree_frac": worst,
                "registers": regs.get("0,0"), "tolerance": tolerance}]

    # ---- the accuracy path: the notebook survey ------------------------
    nb_survey, nb_electrodes = notebook_survey()
    nb_survey.local_majorant = "auto"
    nb_prob = nb_survey.build_problem()
    mj = nb_prob.local_majorant
    check(mj is not None and len(mj.boxes) == 2 and not mj.bands,
          f"notebook majorant is {mj}, expected 2 boxes and no band")
    nb_pts = np.asarray(nb_electrodes, np.float32)

    # ---- 8. kernel vs plain, one launch, chain and reflectance ---------
    for mode in ("auto", "reflectance"):
        solver = WoStSolver(nb_prob, survey_default_options(
            target_slots=8192, robin_correction=mode), device=dev)
        check(solver._robin_enabled() == ("chain" if mode == "auto"
                                          else mode),
              f"robin_correction={mode!r} resolved to "
              f"{solver._robin_enabled()!r}")
        state, params, _, _ = solver._setup(nb_pts, 8192, 6000, 1.0, 3)
        check(state["px"].numel() == 8192, "phase 8 state is not 8192 lanes")
        wk.walk_plain(state, params, 200)
        start = clone_state(state)
        ref = clone_state(state)
        before = wk.run_walk.launches
        wk.run_walk(state, params, 32)
        torch.cuda.synchronize()
        check(wk.run_walk.launches == before + 1, "launch count did not grow")
        wk.walk_plain(ref, params, 32)
        worst8, err8 = check_planes(wk, state, ref,
                                    state_planes(params.n_src),
                                    f"phase 8 ({mode})")
        shares = {}
        for off, p_off in (("robin", dataclasses.replace(
                params, robin=wk.ROBIN_OFF)), ("majorant",
                dataclasses.replace(params, majorant=None))):
            other = clone_state(start)
            wk.run_walk(other, p_off, 32)
            shares[off] = lanes_differ(state, other)
            check(shares[off] >= 0.01,
                  f"phase 8 ({mode}): switching the {off} off changed only "
                  f"{shares[off]:.4f} of lanes")
        log(f"[8] one 32-step launch, 8192 lanes, notebook {params.robin=} "
            f"(1 chain, 2 reflectance) + majorant: worst plane agreement "
            f"{worst8:.5f}, max |err| on agreeing lanes {err8:.3g}; lanes "
            f"changed with the mechanism off: {shares}")

    # ---- 9. kernel vs plain, whole solve, accuracy configuration ------
    solver = WoStSolver(nb_prob, survey_default_options(target_slots=1 << 17),
                        device=dev)
    rk = solver._solve_raw(nb_pts, 512, 6000, 1.0, 11)
    rp = solver._solve_raw(nb_pts, 512, 6000, 1.0, 11, walk=wk.walk_plain)
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "phase 9 kernel solve not finite")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"phase 9 solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"phase 9 total steps differ: {rk.total_steps} vs {rp.total_steps}")
    log(f"[9] solve 21x512 (chain + majorant): max |dmean| "
        f"{float(dm.max()):.3g}, max |dmean|/(|mean|+se) "
        f"{float((dm / scale).max()):.3g} (bound 1e-3), steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}")

    # ---- 10. physics: the accuracy preset against the pinned oracle ----
    with np.load(os.path.join(ROOT, "dcrmontecarlo_tpu", "validation",
                              "pins", "notebook_oracle.npz")) as z:
        pins = {k: z[k] for k in z.files}
    check(np.allclose(pins["electrodes"], nb_electrodes, atol=1e-5),
          "pinned electrodes differ from the survey's")
    solver = nb_survey.make_solver(survey_default_options(
        target_slots=1 << 17), device=dev)
    nb_survey.run(nb_electrodes, n_walks=4096, max_steps=6000, eps=1.0,
                  seed=999, solver=solver)                    # warm-up
    dv_errs, times, steps10 = [], [], 0.0
    for seed in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nb_survey.run(nb_electrodes, n_walks=4096, max_steps=6000,
                            eps=1.0, seed=seed, solver=solver)
        times.append(time.perf_counter() - t0)
        steps10 += res.solve.total_steps
        err = res.potentials - pins["fdm_401"]
        n_pot = int((np.abs(err) < 4.0 * res.potentials_stderr + 3.5).sum())
        cm = float(np.median(err))
        dv_dev = np.abs(res.voltages - pins["dv_401"]) / (
            4.0 * res.voltages_stderr + 0.25)
        check(np.isfinite(res.potentials).all(), f"seed {seed} not finite")
        check((dv_dev < 1.0).all(),
              f"seed {seed}: dipole voltages off the oracle, worst "
              f"|err|/(4 sigma + 0.25) {float(dv_dev.max()):.3f}")
        check(-25.0 < cm < 3.0,
              f"seed {seed}: median signed potential error {cm:.3f}")
        check(n_pot >= 19,
              f"seed {seed}: only {n_pot}/21 potentials within 4 sigma + 3.5")
        dv_errs.append(np.abs(res.voltages - pins["dv_401"]))
        log(f"[10] seed {seed}: dV worst |err|/(4 sigma + 0.25) "
            f"{float(dv_dev.max()):.3f}, median signed potential error "
            f"{cm:.3f}, potentials within 4 sigma + 3.5: {n_pot}/21, "
            f"steps {res.solve.total_steps:.0f}, {times[-1]:.4f} s")
    med_err = float(np.median(np.stack(dv_errs)))
    t_solve = sum(times) / len(times)
    log(f"[10] accuracy preset, 8 seeds x 4096 walks: med|dV err| "
        f"{med_err:.4g}, s/solve {t_solve:.4f}, err*sqrt(t) "
        f"{med_err * np.sqrt(t_solve):.4g}, steps/solve {steps10 / 8:.6g} "
        f"({card})")

    # ---- 11. full size: the accuracy path ------------------------------
    full = survey_default_options(target_slots=1 << 21, min_quota=32)
    solver = nb_survey.make_solver(full, device=dev)
    n_walks, max_steps, eps = 1 << 20, 6000, 1.0
    wk.run_walk.launches = 0
    solver.solve(nb_pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                 seed=0)                                       # warm-up
    steps, times, lane_steps = 0.0, [], 0.0
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(nb_pts, n_walks=n_walks, max_steps=max_steps,
                           eps=eps, seed=rep + 1)
        times.append(time.perf_counter() - t0)
        steps += res.total_steps
        lane_steps += 688128.0 * res.iterations
        check(np.isfinite(res.mean).all()
              and np.isfinite(res.stderr).all(), "phase 11 solve not finite")
    launches11 = wk.run_walk.launches
    check(launches11 > 0, "the full-size accuracy solve never launched the "
                          "kernel")
    rate = steps / sum(times)
    log(f"[11] full size 21x{n_walks} walks, 688128 lanes, chain + "
        f"majorant: walker_steps_per_sec {rate:.6g} s/solve {times} "
        f"steps/solve {steps / 3:.6g} longest lane {res.iterations} steps, "
        f"lane occupancy {steps / lane_steps:.4f}, launches {launches11} "
        f"({card})")
    state, params, _, _ = solver._setup(nb_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 688128, "phase 11 state is not 688128 lanes")
    check(params.robin == wk.ROBIN_CHAIN and params.majorant is not None,
          "phase 11 does not run the chain + majorant variant")
    wk.run_walk(clone_state(state), params, 16)          # warm both
    t16 = cuda_ms(lambda: wk.walk_plain(clone_state(state), params, 16))
    subset = t16 * 16 > 30e3
    if subset:   # the plain version would take over 30 s: 147,456 lanes
        state = {k: v[:1152].clone() for k, v in state.items()}
    ks, ps = clone_state(state), clone_state(state)
    ms11 = cuda_ms(lambda: wk.run_walk(ks, params, 256))
    plain_ms11 = cuda_ms(lambda: wk.walk_plain(ps, params, 256))
    worst11, err11 = check_planes(wk, ks, ps, state_planes(params.n_src),
                                  "phase 11")
    log(f"[11] 256 steps x {state['px'].numel()} lanes"
        f"{' (first 147456: plain 16 steps took %.0f ms)' % t16 if subset else ''}"
        f": kernel {ms11:.3f} ms, plain {plain_ms11:.3f} ms "
        f"({plain_ms11 / ms11:.1f}x); worst plane agreement {worst11:.5f}, "
        f"max |err| on agreeing lanes {err11:.3g} ({card})")
    records.append({
        "name": "walk_kernel", "variant": "robin_chain+local_majorant",
        "route": "cuda",
        "source": "dcrmontecarlo_tpu_torch/csrc/walk_kernel.cu",
        "replaces": "dcrmontecarlo_tpu/ops/pallas_walk.py:1295",
        "launches": launches11, "max_abs_err": err11, "ms": ms11,
        "plain_ms": plain_ms11, "agree_frac": worst11,
        "lanes": state["px"].numel(), "registers": regs.get("1,1"),
        "tolerance": tolerance})

    log(f"total {time.perf_counter() - t_start:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
