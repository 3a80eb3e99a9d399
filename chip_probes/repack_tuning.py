#!/usr/bin/env python3
"""The freeze builds' repack constants, tried on one card, each held to a
reference kernel bit for bit.

``csrc/walk_kernel.cu`` fixes the constants of the freeze builds' loop
(``walk_repacked``): ``REPACK_THREADS`` (threads per block),
``REPACK_STEPS`` (iterations per round) and ``REPACK_REFILL`` (free
threads at which a block refills from the launch's pool). This probe
copies the checkout's ``csrc/`` once per setting with these replaced,
builds the flagship's and the grid flagship's variants of every copy (and of the
reference tree's ``csrc/``, ``REF``, if given: the parent checkout) in
parallel, and runs each library through this checkout's wrapper on the
same inputs:

- 256 steps at ``chip_smoke.py`` phase 15's and phase 34's full-size
  states (seed 5, the freeze at 4): ms, best of 3, and whether the end
  planes equal the first library's on every lane;
- phase 15's solve at seed 1: s, summed kernel ms (CUDA events), total
  steps, launches, clones, and whether the means and stderrs equal the
  first library's.

    python3 chip_probes/repack_tuning.py [REF]

Each build's ``ptxas`` report (registers, spills) is printed.
"""

import hashlib
import os
import re
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

from dcrmontecarlo_tpu_torch.models import notebook_survey  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.solver.state import state_planes  # noqa
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa
import chip_smoke as cs  # noqa: E402

# (threads, steps, refill)
SETTINGS = ((256, 1, 32), (256, 1, 16), (256, 1, 64), (128, 1, 32),
            (256, 2, 32))
WORK = ROOT / "_archive" / "repack_tuning"


def copy_source(tag, threads, steps, refill):
    dst = WORK / tag
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(wk._SRC.parent, dst)
    src = (dst / "walk_kernel.cu").read_text()
    for name, value in (("int REPACK_THREADS", threads),
                        ("int REPACK_STEPS", steps),
                        ("int REPACK_REFILL", refill)):
        src, n = re.subn(rf"constexpr {name} = \w+;",
                         f"constexpr {name} = {value};", src)
        assert n == 1, name
    (dst / "walk_kernel.cu").write_text(src)
    return dst


def build(tag, csrc, variant):
    out = WORK / f"{tag}-{wk.variant_code(variant)}.so"
    cmd = [wk._nvcc(), *wk.NVCC_FLAGS, *wk.variant_macros(variant), "-o",
           str(out), str(csrc / "walk_kernel.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stdout}{proc.stderr}")
    report = " | ".join(line.strip() for line in
                        (proc.stdout + proc.stderr).splitlines()
                        if "registers" in line or "spill" in line)
    return out, report


def use(paths):
    """Make ``wk.run_walk`` launch the libraries ``paths`` (by variant
    code)."""
    wk._library.cache_clear()
    wk._library_path = lambda v: paths[wk.variant_code(v)]


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {}
    if len(sys.argv) > 1:
        sources["ref"] = Path(sys.argv[1]).resolve() / \
            "dcrmontecarlo_tpu_torch" / "csrc"
    for t, s, r in SETTINGS:
        tag = f"t{t}-s{s}-r{r}"
        sources[tag] = copy_source(tag, t, s, r)

    s15, e15 = notebook_survey()
    s15.local_majorant, s15.source_mis = "auto", True
    full = survey_default_options(target_slots=1 << 21, min_quota=32,
                                  split_threshold=4.0)
    flag = s15.make_solver(full, device=dev)
    pts15 = np.asarray(e15, np.float32)
    prob34, pins = cs.cylinder_problem()
    cyl = WoStSolver(prob34, full, device=dev)
    pts34 = pins["electrodes"].astype(np.float32)
    st15, p15, _, _ = flag._setup(pts15, 1 << 20, 6000, 1.0, 5)
    st34, p34, _, _ = cyl._setup(pts34, 1 << 20, 6000, 1.0, 5)
    variants = (p15.variant, p34.variant)

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = {(tag, v): pool.submit(build, tag, csrc, v)
                for tag, csrc in sources.items() for v in variants}
        built = {k: f.result() for k, f in jobs.items()}
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s "
          f"({card})", flush=True)
    for (tag, v), (_, report) in built.items():
        print(tag, wk.kernel_name(v), report, flush=True)

    def steps256(state, params):
        def once():
            s = {k: v.clone() for k, v in state.items()}
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(s, params, 256, freeze_thr=4.0)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), s
        once()
        ms, end = min((once() for _ in range(3)), key=lambda r: r[0])
        return ms, hashlib.sha256(b"".join(
            end[k].cpu().numpy().tobytes()
            for k in state_planes(params.n_src))).hexdigest()[:16]

    first = None
    for tag in sources:
        use({wk.variant_code(v): built[(tag, v)][0] for v in variants})
        ms15, h15 = steps256(st15, p15)
        ms34, h34 = steps256(st34, p34)
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
        res = flag._solve_raw(pts15, 1 << 20, 6000, 1.0, 1, walk=timed)
        wall = time.perf_counter() - t0
        kern = sum(a.elapsed_time(b) for a, b in events)
        key = (h15, h34, res.total_steps, flag.last_solve_stats["launches"],
               flag.last_solve_stats["clones"], res.max_banked,
               np.asarray(res.mean).tobytes(),
               np.asarray(res.stderr).tobytes())
        first = first or key
        print(f"{tag}: 256 steps phase 15 {ms15:.3f} ms, phase 34 "
              f"{ms34:.3f} ms; phase 15 solve seed 1 {wall:.4f} s, kernel "
              f"{kern:.1f} ms, {res.total_steps:.0f} steps, "
              f"{flag.last_solve_stats}; planes and solve "
              f"{'equal to' if key == first else 'DIFFER from'} the first "
              f"({card})", flush=True)


if __name__ == "__main__":
    main()
