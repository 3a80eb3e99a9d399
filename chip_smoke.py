#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``dcrmontecarlo_tpu_torch`` through its four paths, each on the
kernel variant it runs: the DCR-survey forward solve (phases 3-7), the
1000 m notebook survey's accuracy path, the Robin chord chain with the
two-level local majorant (phases 8-11), the flagship notebook gate's
path, which adds MIS next-event estimation and the high-weight split
(the host launch loop with the in-launch freeze; phases 12-15), and the
topographic survey: DC resistivity over rolling hills, a heightmap
Neumann surface with silhouette vertices, walked in the kernel's table
form (phases 16-20). Each phase reports on its own line:

1. environment: torch, CUDA, nvcc and the card (name and power limit);
2. build of the walk kernel from ``csrc/walk_kernel.cu``, one library per
   instantiation, all compiled at once;
3. kernel vs plain version, one 32-step launch at 8,192 lanes of the
   survey problem with its default options (``walk_kernel.compare_planes``:
   every plane agrees on >= 99% of lanes to rel 1e-4 above a floor of
   1e-6 x the plane's largest value);
4. kernel vs plain version, a whole solve of 9 points x 512 walks: both
   draw the same counter-hash streams, so total steps must be equal and
   each mean within 1e-3 x (|mean| + combined stderr);
5. physics: the survey against the finite-volume oracle (the port's own
   copy, ``dcrmontecarlo_tpu_torch.validation``; >= 8/9 electrodes within
   4 sigma + 2e-4);
6. full size: the benchmark configuration (9 points x 2^19 walks,
   147,456 walker lanes): one warm-up solve through ``WoStSolver.solve``
   (its launches counted), then 3 timed solves (walker-steps/s, s/solve,
   lane occupancy, the kernel's share of the wall time);
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
    ``target_slots=1<<21, min_quota=32`` (688,128 lanes), a warm-up and
    3 timed solves as in phase 6, then 256
    steps of kernel and plain version at that state, timed and held to
    the rule of phase 3 (on the first 147,456 lanes if the plain version
    would take over 30 s). The accuracy variant's record takes its
    numbers from here; the reflectance fold with the majorant and the
    majorant alone, which no path launches, get their times and bounds
    from the same state (a log line each, no record).
12. kernel vs plain version, one 32-step launch at 8,192 lanes of the
    flagship configuration (``source_mis=True``, ``local_majorant="auto"``,
    ``split_threshold=4.0``: chain + majorant + MIS + freeze) after 200
    plain steps, with the freeze at 4.0, under the rule of phase 3; and
    each mechanism ran: without the mixture >= 1% of lanes bank otherwise,
    >= 1 lane ends the launch frozen, the same launch at ``thr = +inf``
    differs. Then the same for the survey with ``source_mis`` (MIS on the
    survey path), whose record takes its times from 256 steps at phase
    7's full-size state with the mixture, and its launches from a survey
    solve with ``source_mis``.
13. kernel vs plain version, a whole host-loop solve of the flagship
    configuration, 21 points x 512 walks, ``target_slots=1<<17``, with
    ``max_steps=300``: equal total steps and clone counts, each mean
    within 1e-3 x (|mean| + combined stderr); launches and clones
    printed. (The host loop runs ~quota x max_steps steps while the
    splits go on, and the plain version's step is a few hundred small
    kernels: at ``max_steps=6000`` it had not finished after 950 s.)
14. physics: the flagship notebook gate (``tests/test_dcr_survey.py``
    ``test_notebook_survey_matches_fdm_oracle``) on the card:
    ``survey_default_options(target_slots=65536, split_threshold=4.0)``,
    2500 walks, max_steps 6000, eps 1.0, seeds 0, 1, 2, each against the
    pinned 401^2 oracle: >= 19/21 potentials within 4 sigma + 3.5, median
    signed potential error in (-25, +3), all 20 dipole voltages within
    4 sigma + 0.25.
15. full size of the flagship path: 21 points x 2^20 walks,
    ``survey_default_options(target_slots=1<<21, min_quota=32,
    split_threshold=4.0)`` (688,128 lanes), one warm-up solve through
    ``WoStSolver.solve`` and 3 timed solves (walker-steps/s, s/solve,
    launches and clones per solve, lane occupancy, and the kernel's share
    of the wall time: summed CUDA-event kernel time over the solve's), then
    256 steps of kernel and plain version at that state with the freeze at
    4.0, timed and held to the rule of phase 3 (on the first 147,456 lanes
    if the plain version would take over 30 s). The flagship variant's
    record takes its numbers from here.
16. the table form, one launch: ``topographic_survey_problem()`` at its
    defaults (200 Neumann segments, 199 vertices: 402 rows), 9 electrodes
    draped at x = -40..40, 8,192 lanes, 256 steps of kernel and plain
    version, timed and held to the rule of phase 3; the silhouettes act
    (the same launch without the vertex table changes >= 1% of lanes in
    ``px`` or ``atten``); and a 100-segment square whose right edge is its
    table's last three rows keeps every walker inside.
17. the static form with silhouettes, the same at ``half_width=100,
    depth=150, resolution=8`` (52 rows), its launches counted over a solve
    through ``WoStSolver.solve``.
18. the chord chain on a table geometry: the test size (``resolution=4``,
    102 rows) with ``robin_correction="chain"``, the same, the chain shown
    to act (Robin off changes >= 1% of lanes).
19. kernel vs plain version, a whole solve at the test size: 9 draped
    electrodes x 512 walks, eps 0.5, max_steps 600, under phase 4's rule.
20. full size of the topographic path: the defaults, the 9 electrodes x
    2^17 walks, ``SolverOptions(target_slots=1<<21)`` (294,912 lanes),
    eps 0.5, max_steps 600: a warm-up and 3 timed solves as in phase 6
    (with the share of walks the step cap truncated), the physics of
    ``tests/test_topography.py`` (the +20 m side positive, the -20 m side
    negative, every |potential| < 1), then 256 steps of kernel and plain
    version at that state. The topographic variant's record takes its
    numbers from here.

The second to last line of standard output is the card's
``nvidia-smi --query-gpu=name,power.limit`` line, the line before it the
kernels' JSON record (one entry per kernel variant on a path: name,
route, source, the TPU code it replaces, launches on its path's main run,
max |err| against the plain version, kernel and plain times, the bound
and what sets it, ``library_ms`` null: no single PyTorch call computes
the walk), and the last line ``{"ok": true, "device": ...}``.
Any failure exits non-zero before that line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.

    python3 chip_smoke.py              # every phase, on one GPU
"""

import dataclasses
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
# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
SOURCE = "dcrmontecarlo_tpu_torch/csrc/walk_kernel.cu"
REPLACES = "dcrmontecarlo_tpu/ops/pallas_walk.py:1295"


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
    """Registers per compiled kernel instantiation, from ``ptxas -v``,
    keyed as ``WalkParams.kernel_name``: ``walk_kernel<robin,majorant,
    mis,freeze,table>``."""
    regs, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            t = re.search(r"walk_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                          entry)
            if t:
                r, *b = t.groups()
                flags = ",".join("true" if v == "1" else "false" for v in b)
                entry = f"walk_kernel<{r},{flags}>"
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def fp32_ops_per_step(params):
    """A lower bound on the FP32 operations of one walker-step of the
    instantiation ``params`` selects, counted by hand from
    ``csrc/walk_kernel.cu``: every add, multiply, compare or select,
    divide, square root and transcendental (exp, log, sin, cos) is one
    operation (the precise divide and transcendentals take several); only
    the work every stepping lane does counts: the rejection's first round,
    the cheaper of the two moves, and not the Robin chord mass, the
    arrival weight, the chain branch, later rejection rounds or the
    roulette's kill, whose share depends on the walk. The geometry loops
    count every row: in the table form a closest-point row forms its edge
    (4 more), a first-hit row its edge but divides instead of taking a
    reciprocal (1 more), a silhouette row its two edges (4 more)."""
    n_dir, n_neu = len(params.dir_table), len(params.neu_table)
    n_vert = len(params.vert_table)
    kind, tab = params.specs[1].table()
    alpha = 3 + 16 * ((len(tab) - 1) // 6)     # alpha_c: a bump is 16
    dipole = 20                                 # a source evaluation
    cp_row, hit_row, sil_row = (22, 23, 20) if params.table else (18, 22, 16)
    ops = cp_row * n_dir + 2                    # closest point
    ops += 9 + 6 + hit_row * n_neu              # radius, direction, hit
    ops += sil_row * n_vert + (2 if n_vert else 0)  # silhouette radius
    ops += 165                                  # screened radius, round 0
    ops += 6 + alpha                            # sample point, alpha there
    ops += 34 + alpha + 3 + 12                  # interior test, edge move,
                                                # roulette and counters
    if params.majorant is not None:
        boxes, bands = params.majorant.table()
        ops += 6 + 13 * len(boxes) + 3 * len(bands)
    if params.mis_table is not None:
        k = len(params.mis_table)
        ops += (36 + 102 + 31 + 2 + hit_row * n_neu + 11 * k + 13 + alpha
                + dipole * params.n_src)        # MIS NEE
    else:
        ops += 35 + dipole * params.n_src       # NEE
    if params.freeze:
        ops += 2
    return ops


def bound(params, lanes, walker_steps, launches):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``walker_steps`` steps of ``params``' instantiation over ``lanes``
    lanes in ``launches`` launches, the larger of the operations over the
    FP32 peak and the planes' bytes (inputs read once, outputs written
    once, per launch) over the memory rate."""
    state = 5 + 3 * params.n_src + 9            # read and written
    const = 3 + (3 if params.snap else 0)       # read
    rows = sum(t.nbytes for t in params.device_tables("cpu"))  # table form
    nbytes = (4.0 * lanes * (2 * state + const) + rows) * launches
    t_ops = fp32_ops_per_step(params) * walker_steps / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_record(params, variant, launches, timed, regs, tolerance):
    """The kernels line's entry for ``params``' instantiation: its
    launches on its path's main run and ``timed``, a ``steps_256``
    result."""
    bound_ms, bound_by = bound(params, timed["lanes"], timed["steps"], 1)
    return {"name": params.kernel_name, "variant": variant, "route": "cuda",
            "source": SOURCE, "replaces": REPLACES, "launches": launches,
            "max_abs_err": timed["max_err"], "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "lanes": timed["lanes"], "walker_steps": timed["steps"],
            "agree_frac": timed["worst"],
            "registers": regs.get(params.kernel_name),
            "tolerance": tolerance}


def life_steps(before, after):
    """Walker-steps taken between two states (sum of ``life``)."""
    return int((after["life"].long() - before["life"].long()).sum())


def lanes_differ(a, b, names=("atten", "px")):
    """Share of lanes on which any plane of ``names`` differs."""
    d = torch.zeros_like(a["px"], dtype=torch.bool)
    for k in names:
        d |= a[k] != b[k]
    return float(d.double().mean())


def full_size_solves(wk, solver, pts, n_walks, max_steps, eps, lanes, what):
    """A path at full size: one warm-up solve through ``WoStSolver.solve``
    with the launch counts set to 0 just before it and read just after,
    then 3 timed solves whose walk launches are bracketed by CUDA events.
    Returns a dict of the counts, each solve's launches and clones, the
    walker-steps/s, s/solve, steps/solve, lane occupancy (steps over
    lanes x longest lane), the kernel's share of each solve's wall time
    and the longest lane."""
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    warm = solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                        seed=0)                                # warm-up
    counts = dict(wk.run_walk.variant_launches)
    check(sum(counts.values()) == wk.run_walk.launches > 0,
          f"{what}: the full-size solve launched {counts}")
    stats, events = [solver.last_solve_stats], []

    def timed_walk(state, params, n, thr=None):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        wk.run_walk(state, params, n, thr)
        stop.record()
        events.append((start, stop))

    steps, times, lane_steps, share, trunc = 0.0, [], 0.0, [], []
    for rep in range(3):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver._solve_raw(pts, n_walks, max_steps, eps, rep + 1,
                                walk=timed_walk)
        times.append(time.perf_counter() - t0)
        share.append(sum(a.elapsed_time(b) for a, b in events) / 1e3
                     / times[-1])
        stats.append(solver.last_solve_stats)
        steps += res.total_steps
        trunc.append(res.truncated_walks / (len(pts) * n_walks))
        lane_steps += float(lanes) * res.iterations
        check(np.isfinite(res.mean).all() and np.isfinite(res.stderr).all(),
              f"{what}: full-size solve not finite")
    return dict(counts=counts, stats=stats, rate=steps / sum(times),
                times=times, steps=steps / 3, occupancy=steps / lane_steps,
                share=share, longest=res.iterations, warm=warm, trunc=trunc)


def steps_256(wk, state, params, what, thr=None, subset=False):
    """256 steps of the kernel and of the plain version from one state,
    each warmed on a copy for 16 steps, timed, and held to phase 3's
    rule. With ``subset``, the first 147,456 lanes when the plain version
    would take over 30 s. Returns a dict of the lanes, ms, plain_ms, the
    worst plane's agreeing share, the max |err| on agreeing lanes, the
    walker-steps the kernel took, the plain 16-step time when cut and the
    kernel's end state."""
    from dcrmontecarlo_tpu_torch.solver.state import state_planes

    wk.run_walk(clone_state(state), params, 16, freeze_thr=thr)
    t16 = cuda_ms(lambda: wk.walk_plain(clone_state(state), params, 16,
                                        freeze_thr=thr))
    cut = subset and t16 * 16 > 30e3
    if cut:
        state = {k: v[:1152].clone() for k, v in state.items()}
    ks, ps = clone_state(state), clone_state(state)
    ms = cuda_ms(lambda: wk.run_walk(ks, params, 256, freeze_thr=thr))
    plain_ms = cuda_ms(lambda: wk.walk_plain(ps, params, 256,
                                             freeze_thr=thr))
    worst, max_err = check_planes(wk, ks, ps, state_planes(params.n_src),
                                  what)
    return dict(lanes=state["px"].numel(), ms=ms, plain_ms=plain_ms,
                worst=worst, max_err=max_err, steps=life_steps(state, ks),
                t16=t16 if cut else None, end=ks)


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

    from dcrmontecarlo_tpu_torch.geometry import Polyline
    from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
        geophysical_scenario, notebook_survey, topographic_survey_problem
    from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
    from dcrmontecarlo_tpu_torch.problems import Problem, fields
    from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    from dcrmontecarlo_tpu_torch.survey import survey_default_options
    from dcrmontecarlo_tpu_torch.validation import fdm_solve

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
    libs, build_s, build_log = wk.build_library()
    regs = ptxas_registers(build_log)
    check(set(regs) == {wk.kernel_name(v) for v in wk.KERNEL_VARIANTS}
          or not build_log,
          f"expected {len(wk.KERNEL_VARIANTS)} kernel instantiations, "
          f"ptxas reported {regs}")
    log(f"[2] built {len(libs)} libraries, one per instantiation, in "
        f"{os.path.relpath(os.path.dirname(libs[0]), ROOT)} in {build_s:.1f} "
        f"s (all nvcc processes at once); ptxas registers per "
        f"instantiation: {regs or 'cached build'}")

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
    res = survey.run(electrodes, n_walks=1500, max_steps=800, eps=0.5,
                     seed=0, options=SolverOptions(target_slots=16384),
                     device=dev)
    prob = survey.build_problem()

    def np_field(f):
        return lambda X, Y: f(torch.as_tensor(X, dtype=torch.float32),
                              torch.as_tensor(Y, dtype=torch.float32)
                              ).numpy()

    fdm = fdm_solve(bounds=((-100.0, 100.0), (-200.0, 0.0)),
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
    f6 = full_size_solves(wk, solver, pts, n_walks, max_steps, eps, 147456,
                          "phase 6")
    log(f"[6] full size 9x{n_walks} walks, 147456 lanes: "
        f"dcr_survey_walker_steps_per_sec_per_chip {f6['rate']:.6g} "
        f"s/solve {f6['times']} steps/solve {f6['steps']:.6g} longest lane "
        f"{f6['longest']} steps, lane occupancy {f6['occupancy']:.4f}, "
        f"kernel share {[round(v, 4) for v in f6['share']]}, launches of "
        f"the warm-up solve {f6['counts']} ({card})")

    # ---- 7. kernel vs plain at the full-size state ---------------------
    state, params, _, step_bound = solver._setup(pts, n_walks, max_steps,
                                                 eps, 5)
    check(state["px"].numel() == 147456, "full state is not 147456 lanes")
    check(set(f6["counts"]) == {params.kernel_name},
          f"the survey path launched {f6['counts']}, expected "
          f"{params.kernel_name} only")
    t7 = steps_256(wk, state, params, "phase 7")
    # the whole solve's single launch, for the kernel's share of a solve
    solve_ms = cuda_ms(lambda: wk.run_walk(state, params, step_bound))
    log(f"[7] 256 steps x 147456 lanes: kernel {t7['ms']:.3f} ms, plain "
        f"{t7['plain_ms']:.3f} ms ({t7['plain_ms'] / t7['ms']:.1f}x); worst "
        f"plane agreement {t7['worst']:.5f}, max |err| on agreeing lanes "
        f"{t7['max_err']:.3g}; one whole-solve launch {solve_ms:.3f} ms "
        f"({card})")
    tolerance = (f">={wk.PLANE_MIN_FRAC:.0%} of lanes per plane within "
                 f"rel {wk.PLANE_RTOL:g} + {wk.PLANE_FLOOR:g} x plane max")
    records = [kernel_record(params, "survey",
                             f6["counts"][params.kernel_name], t7, regs,
                             tolerance)]
    survey_full = (solver, pts, params)   # phase 12 reuses the full state

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
    f11 = full_size_solves(wk, solver, nb_pts, n_walks, max_steps, eps,
                           688128, "phase 11")
    log(f"[11] full size 21x{n_walks} walks, 688128 lanes, chain + "
        f"majorant: walker_steps_per_sec {f11['rate']:.6g} s/solve "
        f"{f11['times']} steps/solve {f11['steps']:.6g} longest lane "
        f"{f11['longest']} steps, lane occupancy {f11['occupancy']:.4f}, "
        f"kernel share {[round(v, 4) for v in f11['share']]}, launches of "
        f"the warm-up solve {f11['counts']} ({card})")
    state, params, _, _ = solver._setup(nb_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 688128, "phase 11 state is not 688128 lanes")
    check(params.robin == wk.ROBIN_CHAIN and params.majorant is not None,
          "phase 11 does not run the chain + majorant variant")
    check(set(f11["counts"]) == {params.kernel_name},
          f"the accuracy path launched {f11['counts']}")
    t11 = steps_256(wk, state, params, "phase 11", subset=True)
    log(f"[11] 256 steps x {t11['lanes']} lanes"
        f"{' (plain 16 steps took %.0f ms)' % t11['t16'] if t11['t16'] else ''}"
        f": kernel {t11['ms']:.3f} ms, plain {t11['plain_ms']:.3f} ms "
        f"({t11['plain_ms'] / t11['ms']:.1f}x); worst plane agreement "
        f"{t11['worst']:.5f}, max |err| on agreeing lanes "
        f"{t11['max_err']:.3g} ({card})")
    records.append(kernel_record(
        params, "robin_chain+local_majorant",
        f11["counts"][params.kernel_name], t11, regs, tolerance))
    # the two instantiations no main path launches, timed at that state
    # for their bounds (they take no record: no path counts their launches)
    for what, robin in (("reflectance+majorant", wk.ROBIN_REFLECTANCE),
                        ("majorant alone", wk.ROBIN_OFF)):
        p11 = dataclasses.replace(params, robin=robin)
        t = steps_256(wk, state, p11, f"phase 11 ({what})", subset=True)
        b_ms, b_by = bound(p11, t["lanes"], t["steps"], 1)
        log(f"[11] {what} ({p11.kernel_name}), 256 steps x {t['lanes']} "
            f"lanes: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms; "
            f"worst plane agreement {t['worst']:.5f}; {t['steps']} "
            f"walker-steps, bound {b_ms:.4f} ms ({b_by}), "
            f"{regs.get(p11.kernel_name)} registers ({card})")

    # ---- the flagship notebook gate's path -------------------------------
    flag_survey, _ = notebook_survey()
    flag_survey.local_majorant = "auto"
    flag_survey.source_mis = True
    flag_prob = flag_survey.build_problem()
    check(flag_prob.source_importance is not None
          and flag_prob.local_majorant is not None,
          "the flagship problem has no mixture or no majorant")

    # ---- 12. kernel vs plain, one launch with MIS (and the freeze) ------
    mis_survey, _ = geophysical_scenario(sharpness=0.5)
    mis_survey.source_mis = True
    cases12 = (("flagship", flag_prob, nb_pts, dict(split_threshold=4.0),
                6000, 1.0),
               ("survey+mis", mis_survey.build_problem(),
                survey_points(electrodes, -0.1), {}, 500, 0.9))
    for what, prob12, pts12, extra, ms12, eps12 in cases12:
        solver = WoStSolver(prob12, survey_default_options(
            target_slots=8192, **extra), device=dev)
        state, params, _, _ = solver._setup(pts12, 8192, ms12, eps12, 3)
        check(state["px"].numel() == 8192, "phase 12 state is not 8192 lanes")
        check(params.mis_table is not None
              and params.freeze == ("split_threshold" in extra),
              f"phase 12 ({what}) runs {params.kernel_name}")
        thr = 4.0 if params.freeze else None
        wk.walk_plain(state, params, 200)      # mid-walk states, no freeze
        start = clone_state(state)
        ref = clone_state(state)
        before = wk.run_walk.launches
        wk.run_walk(state, params, 32, freeze_thr=thr)
        torch.cuda.synchronize()
        check(wk.run_walk.launches == before + 1, "launch count did not grow")
        wk.walk_plain(ref, params, 32, freeze_thr=thr)
        worst12, err12 = check_planes(wk, state, ref,
                                      state_planes(params.n_src),
                                      f"phase 12 ({what})")
        no_mix = clone_state(start)
        wk.walk_plain(no_mix, dataclasses.replace(params, mis_table=None),
                      32, freeze_thr=thr)
        shares = {"mis": lanes_differ(state, no_mix, ("acc0", "asum0"))}
        check(shares["mis"] >= 0.01,
              f"phase 12 ({what}): without the mixture only "
              f"{shares['mis']:.4f} of lanes bank otherwise")
        if params.freeze:
            frozen = int(((state["quota"] > 0)
                          & (state["atten"].abs() > thr)).sum())
            check(frozen >= 1, f"phase 12 ({what}): no lane ended frozen")
            open_ = clone_state(start)
            wk.run_walk(open_, params, 32, freeze_thr=float("inf"))
            shares["freeze"] = lanes_differ(state, open_)
            shares["frozen_lanes"] = frozen
            check(shares["freeze"] > 0.0,
                  f"phase 12 ({what}): thr = +inf changed nothing")
        log(f"[12] one 32-step launch, 8192 lanes, {what} "
            f"({params.kernel_name}): worst plane agreement {worst12:.5f}, "
            f"max |err| on agreeing lanes {err12:.3g}; mechanisms: {shares}")

    # MIS on the survey path: launches from a solve through the entry
    # point, times at phase 7's full-size state with the mixture
    wk.run_walk.launches = 0
    wk.run_walk.variant_launches.clear()
    res = mis_survey.run(electrodes, n_walks=2048, max_steps=500, eps=0.9,
                         seed=0, device=dev)
    check(np.isfinite(res.potentials).all(), "survey+mis solve not finite")
    counts12 = dict(wk.run_walk.variant_launches)
    solver7, pts7, params7 = survey_full
    solver = WoStSolver(mis_survey.build_problem(), solver7.options,
                        device=dev)
    state, params, _, _ = solver._setup(pts7, 1 << 19, 500, 0.9, 5)
    check(params.variant == dataclasses.replace(
        params7, mis_table=params.mis_table).variant,
          "the survey+mis state is not phase 7's configuration with MIS")
    mis_name = params.kernel_name
    check(set(counts12) == {mis_name},
          f"the survey with source_mis launched {counts12}")
    t12 = steps_256(wk, state, params, "phase 12 (survey+mis, full size)")
    log(f"[12] survey+mis 256 steps x 147456 lanes: kernel {t12['ms']:.3f} "
        f"ms, plain {t12['plain_ms']:.3f} ms "
        f"({t12['plain_ms'] / t12['ms']:.1f}x); worst plane agreement "
        f"{t12['worst']:.5f}, max |err| {t12['max_err']:.3g}; the survey "
        f"solve with source_mis launched {counts12} ({card})")
    records.append(kernel_record(params, "survey+mis", counts12[mis_name],
                                 t12, regs, tolerance))

    # ---- 13. kernel vs plain, whole host-loop solve, flagship ----------
    solver = WoStSolver(flag_prob, survey_default_options(
        target_slots=1 << 17, split_threshold=4.0), device=dev)
    t0 = time.perf_counter()
    rk = solver._solve_raw(nb_pts, 512, 300, 1.0, 11)
    stats_k = solver.last_solve_stats
    t_k = time.perf_counter() - t0
    rp = solver._solve_raw(nb_pts, 512, 300, 1.0, 11, walk=wk.walk_plain)
    stats_p = solver.last_solve_stats
    t_p = time.perf_counter() - t0 - t_k
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "phase 13 kernel solve not finite")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"phase 13 solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"phase 13 total steps differ: {rk.total_steps} vs "
          f"{rp.total_steps}")
    check(stats_k["clones"] == stats_p["clones"] > 0,
          f"phase 13 clones differ or none: {stats_k} vs {stats_p}")
    log(f"[13] host-loop solve 21x512, max_steps 300 (flagship): max "
        f"|dmean|/(|mean|+se) "
        f"{float((dm / scale).max()):.3g} (bound 1e-3), steps kernel "
        f"{rk.total_steps:.0f} plain {rp.total_steps:.0f}, kernel "
        f"{stats_k}, plain {stats_p}; {t_k:.2f} s kernel, {t_p:.2f} s plain")

    # ---- 14. physics: the flagship gate against the pinned oracle -------
    solver = flag_survey.make_solver(survey_default_options(
        target_slots=65536, split_threshold=4.0), device=dev)
    check(solver._robin_enabled() == "chain", "flagship Robin is not chain")
    x = nb_electrodes[:, 0]
    for seed in (0, 1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = flag_survey.run(nb_electrodes, n_walks=2500, max_steps=6000,
                              eps=1.0, seed=seed, solver=solver)
        t14 = time.perf_counter() - t0
        check(np.isfinite(res.potentials).all(), f"seed {seed} not finite")
        # the gate's three bounds (test_dcr_survey.py:233-243); the
        # potentials at the current electrodes are printed, not held to
        # a sign: the host loop's heavy tail can flip one (PERF.md)
        at_src = (float(res.potentials[np.abs(x + 200) <= 40].mean()),
                  float(res.potentials[np.abs(x - 200) <= 40].mean()))
        err = res.potentials - pins["fdm_401"]
        n_pot = int((np.abs(err) < 4.0 * res.potentials_stderr + 3.5).sum())
        cm = float(np.median(err))
        dv_dev = np.abs(res.voltages - pins["dv_401"]) / (
            4.0 * res.voltages_stderr + 0.25)
        check(n_pot >= 19,
              f"seed {seed}: only {n_pot}/21 potentials within 4 sigma + 3.5")
        check(-25.0 < cm < 3.0,
              f"seed {seed}: median signed potential error {cm:.3f}")
        check((dv_dev < 1.0).all(),
              f"seed {seed}: dipole voltages off the oracle, worst "
              f"|err|/(4 sigma + 0.25) {float(dv_dev.max()):.3f}")
        log(f"[14] flagship gate seed {seed}: potentials within 4 sigma + "
            f"3.5: {n_pot}/21, median signed error {cm:.3f}, dV worst "
            f"|err|/(4 sigma + 0.25) {float(dv_dev.max()):.3f}, med|dV err| "
            f"{float(np.median(np.abs(res.voltages - pins['dv_401']))):.4g}, "
            f"potentials at the electrodes x = -200, +200: "
            f"{at_src[0]:.4g}, {at_src[1]:.4g}, max banked "
            f"{res.solve.max_banked:.3g}, steps {res.solve.total_steps:.0f}, "
            f"{solver.last_solve_stats}, {t14:.3f} s ({card})")

    # ---- 15. full size: the flagship path -------------------------------
    full = survey_default_options(target_slots=1 << 21, min_quota=32,
                                  split_threshold=4.0)
    solver = flag_survey.make_solver(full, device=dev)
    n_walks, max_steps, eps = 1 << 20, 6000, 1.0
    f15 = full_size_solves(wk, solver, nb_pts, n_walks, max_steps, eps,
                           688128, "phase 15")
    log(f"[15] full size 21x{n_walks} walks, 688128 lanes, flagship: "
        f"walker_steps_per_sec {f15['rate']:.6g} s/solve {f15['times']} "
        f"steps/solve {f15['steps']:.6g} longest lane {f15['longest']} "
        f"steps, lane occupancy {f15['occupancy']:.4f}, launches and clones "
        f"per solve {f15['stats']}, kernel share of wall time "
        f"{[round(v, 4) for v in f15['share']]} ({card})")
    state, params, _, _ = solver._setup(nb_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 688128, "phase 15 state is not 688128 lanes")
    check(params.variant == (wk.ROBIN_CHAIN, True, True, True, False),
          f"phase 15 runs {params.kernel_name}")
    check(f15["counts"] == {params.kernel_name: f15["stats"][0]["launches"]}
          and f15["stats"][0]["launches"] > 1,
          f"the flagship solve launched {f15['counts']}, {f15['stats'][0]}")
    t15 = steps_256(wk, state, params, "phase 15", thr=4.0, subset=True)
    log(f"[15] 256 steps x {t15['lanes']} lanes, freeze 4.0"
        f"{' (plain 16 steps took %.0f ms)' % t15['t16'] if t15['t16'] else ''}"
        f": kernel {t15['ms']:.3f} ms, plain {t15['plain_ms']:.3f} ms "
        f"({t15['plain_ms'] / t15['ms']:.1f}x); worst plane agreement "
        f"{t15['worst']:.5f}, max |err| on agreeing lanes "
        f"{t15['max_err']:.3g}, {t15['steps']} walker-steps ({card})")
    records.append(kernel_record(
        params, "robin_chain+local_majorant+mis+freeze",
        f15["counts"][params.kernel_name], t15, regs, tolerance))
    # ---- the topographic survey: silhouettes, the two geometry forms ----
    xs_topo = np.arange(-40.0, 41.0, 10.0)
    topo_small = dict(half_width=100.0, depth=150.0)

    def topo_launch(prob, pts, opts, what, off_params):
        """Phases 16-18: 256 steps of kernel and plain version from a fresh
        8,192-lane state, timed and held to phase 3's rule; the same launch
        with ``off_params(params)`` must change >= 1% of lanes."""
        solver = WoStSolver(prob, dataclasses.replace(opts, target_slots=8192),
                            device=dev)
        state, params, _, _ = solver._setup(pts, 8192, 600, 0.5, 3)
        check(state["px"].numel() == 8192, f"{what}: not 8192 lanes")
        t = steps_256(wk, state, params, what)
        other = clone_state(state)
        wk.run_walk(other, off_params(params), 256)
        t["acts"] = lanes_differ(t["end"], other)
        check(t["acts"] >= 0.01, f"{what}: switching the mechanism off "
                                 f"changed only {t['acts']:.4f} of lanes")
        return solver, params, t

    def main_path_launches(solver, pts, n_walks, name):
        """Launches of instantiation ``name`` in one solve through
        ``WoStSolver.solve``, the counts set to 0 just before it."""
        wk.run_walk.launches = 0
        wk.run_walk.variant_launches.clear()
        res = solver.solve(pts, n_walks=n_walks, max_steps=600, eps=0.5,
                           seed=0)
        counts = dict(wk.run_walk.variant_launches)
        check(np.isfinite(res.mean).all(), f"{name}: solve not finite")
        check(set(counts) == {name}, f"the solve launched {counts}, "
                                     f"expected {name}")
        return counts[name]

    no_vertices = lambda p: dataclasses.replace(p, vert_table=p.vert_table[:0])

    # ---- 16. the table form, one launch, the defaults -------------------
    topo_prob, topo_h = topographic_survey_problem()
    topo_pts = drape_electrodes(topo_h, xs_topo, nudge=0.5)
    check(wk.geometry_size(topo_prob) == 402, "the terrain is not 402 rows")
    _, p16, t16 = topo_launch(topo_prob, topo_pts, SolverOptions(),
                              "phase 16", no_vertices)
    check(p16.table and p16.variant == (wk.ROBIN_OFF, False, False, False,
                                        True), f"phase 16 runs {p16}")
    # the JAX regression test_pallas_smem_sees_trailing_segments: a square
    # whose right edge is its table's last three rows
    sq = []
    for (a, b, n, first) in (((1, 1), (-1, 1), 32, True),
                             ((-1, 1), (-1, -1), 32, False),
                             ((-1, -1), (1, -1), 33, False),
                             ((1, -1), (1, 1), 3, False)):
        for k in range(0 if first else 1, n + 1):
            sq.append([a[0] + k / n * (b[0] - a[0]),
                       a[1] + k / n * (b[1] - a[1])])
    sq_prob = Problem(dirichlet=Polyline.from_points(sq),
                      bc_dirichlet=fields.constant(1.0),
                      alpha=fields.constant(1.0))
    sq_solver = WoStSolver(sq_prob, SolverOptions(target_slots=8192),
                           device=dev)
    state, p_sq, _, _ = sq_solver._setup(np.zeros((1, 2), np.float32), 8192,
                                         60, 1e-3, 0)
    check(p_sq.table and len(p_sq.dir_table) == 100, "square not tabled")
    ref = clone_state(state)
    wk.run_walk(state, p_sq, 60)
    wk.walk_plain(ref, p_sq, 60)
    worst_sq, _ = check_planes(wk, state, ref, state_planes(1), "phase 16 "
                               "(trailing rows)")
    reach = float(torch.maximum(state["px"].abs(), state["py"].abs()).max())
    check(reach <= 1.0 + 1e-5, f"a walker left the square: |x| {reach}")
    log(f"[16] table form, defaults (402 rows), 256 steps x 8192 lanes: "
        f"kernel {t16['ms']:.3f} ms, plain {t16['plain_ms']:.3f} ms; worst "
        f"plane agreement {t16['worst']:.5f}, max |err| {t16['max_err']:.3g}"
        f"; without the vertices {t16['acts']:.4f} of lanes change; "
        f"trailing rows: agreement {worst_sq:.5f}, farthest walker at "
        f"{reach:.6f} of the half-width ({card})")

    # ---- 17. the static form with silhouettes ----------------------------
    prob17, h17 = topographic_survey_problem(resolution=8.0, **topo_small)
    pts17 = drape_electrodes(h17, xs_topo, nudge=0.5)
    check(wk.geometry_size(prob17) == 52, "resolution 8 is not 52 rows")
    solver17, p17, t17 = topo_launch(prob17, pts17, SolverOptions(),
                                     "phase 17", no_vertices)
    check(not p17.table and len(p17.vert_table) == 24,
          f"phase 17 runs {p17.kernel_name}")
    n17 = main_path_launches(solver17, pts17, 512, p17.kernel_name)
    log(f"[17] static form with silhouettes (52 rows), 256 steps x 8192 "
        f"lanes: kernel {t17['ms']:.3f} ms, plain {t17['plain_ms']:.3f} ms; "
        f"worst plane agreement {t17['worst']:.5f}, max |err| "
        f"{t17['max_err']:.3g}; without the vertices {t17['acts']:.4f} of "
        f"lanes change; a 9x512 solve launched {n17} ({card})")

    # ---- 18. the chord chain on a table geometry -------------------------
    prob18, h18 = topographic_survey_problem(resolution=4.0, **topo_small)
    pts18 = drape_electrodes(h18, xs_topo, nudge=0.5)
    solver18, p18, t18 = topo_launch(
        prob18, pts18, SolverOptions(robin_correction="chain"), "phase 18",
        lambda p: dataclasses.replace(p, robin=wk.ROBIN_OFF))
    check(p18.variant == (wk.ROBIN_CHAIN, False, False, False, True),
          f"phase 18 runs {p18.kernel_name}")
    n18 = main_path_launches(solver18, pts18, 512, p18.kernel_name)
    log(f"[18] chain on the table form (102 rows), 256 steps x 8192 lanes: "
        f"kernel {t18['ms']:.3f} ms, plain {t18['plain_ms']:.3f} ms; worst "
        f"plane agreement {t18['worst']:.5f}, max |err| {t18['max_err']:.3g}"
        f"; Robin off changes {t18['acts']:.4f} of lanes; a 9x512 solve "
        f"launched {n18} ({card})")

    # ---- 19. kernel vs plain, whole solve, test size ---------------------
    solver = WoStSolver(prob18, SolverOptions(), device=dev)
    rk = solver._solve_raw(pts18, 512, 600, 0.5, 11)
    rp = solver._solve_raw(pts18, 512, 600, 0.5, 11, walk=wk.walk_plain)
    check(np.isfinite(rk.mean).all() and np.isfinite(rk.stderr).all(),
          "phase 19 kernel solve not finite")
    dm = np.abs(rk.mean - rp.mean)
    scale = np.abs(rp.mean) + np.sqrt(rk.stderr ** 2 + rp.stderr ** 2)
    check((dm <= 1e-3 * scale).all(),
          f"phase 19 solve means differ: {dm} > 1e-3 x {scale}")
    check(rk.total_steps == rp.total_steps,
          f"phase 19 total steps differ: {rk.total_steps} vs "
          f"{rp.total_steps}")
    log(f"[19] solve 9x512 on the terrain (table form): max |dmean|/"
        f"(|mean|+se) {float((dm / scale).max()):.3g} (bound 1e-3), steps "
        f"kernel {rk.total_steps:.0f} plain {rp.total_steps:.0f}")

    # ---- 20. full size: the topographic path -----------------------------
    solver = WoStSolver(topo_prob, SolverOptions(target_slots=1 << 21),
                        device=dev)
    n_walks, max_steps, eps = 1 << 17, 600, 0.5
    f20 = full_size_solves(wk, solver, topo_pts, n_walks, max_steps, eps,
                           294912, "phase 20")
    mean20 = f20["warm"].mean
    i_pos = int(np.argmin(np.abs(xs_topo + 20)))
    i_neg = int(np.argmin(np.abs(xs_topo - 20)))
    check(mean20[i_pos] > 0 and mean20[i_neg] < 0
          and np.abs(mean20).max() < 1.0,
          f"phase 20 potentials break the survey's physics: {mean20}")
    state, params, _, _ = solver._setup(topo_pts, n_walks, max_steps, eps, 5)
    check(state["px"].numel() == 294912, "phase 20 state is not 294912 lanes")
    check(set(f20["counts"]) == {params.kernel_name} and params.table,
          f"the topographic path launched {f20['counts']}")
    log(f"[20] full size 9x{n_walks} walks, 294912 lanes, table form: "
        f"walker_steps_per_sec {f20['rate']:.6g} s/solve {f20['times']} "
        f"steps/solve {f20['steps']:.6g} longest lane {f20['longest']} "
        f"steps, lane occupancy {f20['occupancy']:.4f}, truncated share "
        f"{[round(v, 4) for v in f20['trunc']]}, kernel share "
        f"{[round(v, 4) for v in f20['share']]}, launches of the warm-up "
        f"solve {f20['counts']}; potentials {np.round(mean20, 5).tolist()} "
        f"({card})")
    t20 = steps_256(wk, state, params, "phase 20", subset=True)
    log(f"[20] 256 steps x {t20['lanes']} lanes"
        f"{' (plain 16 steps took %.0f ms)' % t20['t16'] if t20['t16'] else ''}"
        f": kernel {t20['ms']:.3f} ms, plain {t20['plain_ms']:.3f} ms "
        f"({t20['plain_ms'] / t20['ms']:.1f}x); worst plane agreement "
        f"{t20['worst']:.5f}, max |err| {t20['max_err']:.3g}, "
        f"{t20['steps']} walker-steps ({card})")
    records.append(kernel_record(params, "topography_table",
                                 f20["counts"][params.kernel_name], t20,
                                 regs, tolerance))
    records.append(kernel_record(p18, "topography_table+robin_chain", n18,
                                 t18, regs, tolerance))
    records.append(kernel_record(p17, "topography_static_silhouettes", n17,
                                 t17, regs, tolerance))
    log(f"[guard] phase 6 {f6['rate']:.6g} (earlier runs: 6.62e9-6.83e9), "
        f"phase 11 {f11['rate']:.6g} (earlier runs: 1.06e9-1.08e9) "
        f"walker-steps/s; survey "
        f"registers {regs.get(wk.kernel_name(survey_full[2].variant))}")

    for r in records:
        log(f"[bound] {r['name']} ({r['variant']}): {r['ms']:.3f} ms against "
            f"a bound of {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['registers']} registers")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
