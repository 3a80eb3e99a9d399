#!/usr/bin/env python3
"""The walk kernel's wide form against its narrow form, at 1 and 4 sources.

The wide form (a run-time loop over sources adding to their planes, the
mixture in a larger table) is launched only past ``MAX_SRC`` sources or
``MAX_MIX`` mixture components; below that the narrow form (accumulators
in registers) runs. To time both on the same state, this probe builds the
three wide instantiations once more from a copy of
``csrc/walk_kernel.cu`` whose ``walk_launch`` picks the wide form at any
size (one changed line, under the gitignored ``_build/``), and launches
them in place of the narrow ones. It times 256 steps (CUDA events) of
narrow and wide in alternating turns, ``PAIRS`` pairs, on:

- the survey at phase 7's full-size state of ``chip_smoke.py`` (147,456
  lanes): its one source, and the scenario line's first four dipoles;
- the survey with MIS at the same state (one source);
- chain + MIS on the notebook survey at phase 30's sizing (688,128 lanes,
  one source).

It also holds each wide launch against the narrow one on the same state
(``compare_planes``). Run from the repository's root on the card:
``python3 chip_probes/wide_vs_narrow.py [PAIRS]`` (default 10).
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.solver.state import state_planes  # noqa: E402
from dcrmontecarlo_tpu_torch.survey.dcr import _line_problem  # noqa: E402

PAIRS = int(sys.argv[1]) if len(sys.argv) > 1 else 10
WIDE_PICK = "const bool wide = h.n_src > MAX_SRC || h.n_mix > MAX_MIX;"
dev = torch.device("cuda", 0)


# the narrow variants whose wide forms the paths launch
NARROW = ((0, False, False, False, False, True, False, False, False),
          (0, False, True, False, False, True, False, False, False),
          (1, False, True, False, False, True, False, False, False))


def build_forced_wide():
    """The wide variants from a copy of the source that launches the wide
    form at any size, by the narrow variant."""
    src = wk._SRC.read_text()
    assert src.count(WIDE_PICK) == 1, "walk_launch's wide pick moved"
    out = wk._BUILD_DIR / "forced_wide"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "walk_kernel.cu"
    cu.write_text(src.replace(WIDE_PICK, "const bool wide = true;"))
    procs = {}
    for narrow in NARROW:
        wide = narrow[:7] + (True, False)
        so = out / f"walk_kernel-forced-{wk.variant_code(narrow)}.so"
        procs[narrow] = (so, subprocess.Popen(
            [wk._nvcc(), *wk.NVCC_FLAGS, *wk.variant_macros(wide), "-I",
             str(wk._SRC.parent), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for narrow, (so, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        lib.walk_launch.argtypes = wk._library(narrow).walk_launch.argtypes
        lib.walk_launch.restype = ctypes.c_int
        libs[narrow] = lib
    return libs


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def launch(state, params, steps, wide):
    """``run_walk`` with the narrow library or its forced-wide copy."""
    narrow_library = wk._library
    if wide:
        wk._library = forced.__getitem__
    try:
        wk.run_walk(state, params, steps)
    finally:
        wk._library = narrow_library


def time_256(state, params, wide):
    s = clone(state)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    launch(s, params, 256, wide)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), s


def quartiles(v):
    return [round(float(q), 4) for q in np.percentile(v, (25, 50, 75))]


t0 = time.time()
wk.build_library(NARROW)
forced = build_forced_wide()
build_s = time.time() - t0

cases = {}
survey, electrodes = geophysical_scenario(sharpness=0.5)
pts = np.asarray(electrodes, np.float32).copy()
pts[:, 1] = -0.5
opts7 = SolverOptions(target_slots=1 << 21, min_quota=32, rejection_rounds=1)
cases["survey, 1 source"] = (survey.build_problem(), pts, opts7, 1 << 19,
                             500, 0.9)
line, _, _, _ = _line_problem(survey, electrodes, 3)
line.set_source_term(line.source_fields[:wk.MAX_SRC])
cases["survey, 4 sources"] = (line, pts, opts7, 1 << 19, 500, 0.9)
survey.source_mis = True
cases["survey + MIS, 1 source"] = (survey.build_problem(), pts, opts7,
                                   1 << 19, 500, 0.9)
nb, nb_pts = notebook_survey()
nb.source_mis = True
cases["chain + MIS, notebook survey, 1 source"] = (
    nb.build_problem(), np.asarray(nb_pts, np.float32),
    SolverOptions(target_slots=1 << 21, min_quota=32,
                  common_random_numbers=True), 1 << 20, 6000, 1.0)

card = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60).stdout.strip()
print(f"built the forced-wide copies in {build_s:.1f} s; {card}", flush=True)
for what, (prob, p, opts, n_walks, max_steps, eps) in cases.items():
    solver = WoStSolver(prob, opts, device=dev)
    state, params, _, _ = solver._setup(p, n_walks, max_steps, eps, 5)
    assert not params.wide and params.variant[:7] + (True, False) in \
        wk.KERNEL_VARIANTS, params.kernel_name
    for wide in (False, True):  # warm both
        launch(clone(state), params, 16, wide)
    times, ends = {False: [], True: []}, {}
    for i in range(PAIRS):
        for wide in ((False, True) if i % 2 == 0 else (True, False)):
            ms, ends[wide] = time_256(state, params, wide)
            times[wide].append(ms)
    frac, max_err, finite = wk.compare_planes(
        ends[True], ends[False], state_planes(params.n_src))
    n, w = np.median(times[False]), np.median(times[True])
    k = 0 if params.mis_table is None else len(params.mis_table)
    print(f"{what} ({params.kernel_name}, {params.n_src} sources, {k} "
          f"components, {state['px'].numel()} lanes): narrow quartiles "
          f"{quartiles(times[False])} ms, wide {quartiles(times[True])} ms, "
          f"wide/narrow {w / n:.4f}; wide vs narrow planes: worst agreement "
          f"{min(frac.values()):.5f}, max |err| {max_err:.3g}, finite "
          f"{finite}", flush=True)
