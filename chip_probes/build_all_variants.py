#!/usr/bin/env python3
"""Build every variant of the walk kernel once, on the card machine.

Every switch combination the JAX kernel traces is a variant of
``csrc/walk_kernel.cu`` (``walk_kernel.KERNEL_VARIANTS``: 400
combinations and the TERMS forms of the 368 that lack the kind), built
as a library of its own. This probe builds them all from an empty build
directory of its own (under the gitignored ``_build/``), one ``nvcc``
process per CPU at a time, and prints the number built, the failures
(with nvcc's log), the wall time per library and in all, the range of
registers and spill stores (``ptxas -v``), and the card's name and power
limit. Run from the repository's root:

    python3 chip_probes/build_all_variants.py

The per-library times and registers go to
``chiprun_out/build_all_variants.json``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ptxas_registers  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402

jobs = os.cpu_count()
card = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60).stdout.strip()
variants = sorted(wk.KERNEL_VARIANTS, key=wk.variant_code)
wk._BUILD_DIR = wk._BUILD_DIR / "all_variants"
shutil.rmtree(wk._BUILD_DIR, ignore_errors=True)


def timed(v):
    t0 = time.perf_counter()
    try:
        _, path, log, _ = wk._build_one(v)
        return v, time.perf_counter() - t0, log, None, path
    except RuntimeError as exc:
        return v, time.perf_counter() - t0, "", str(exc), None


print(f"{len(variants)} variants, {jobs} nvcc processes at a time; "
      f"{card}", flush=True)
t0 = time.perf_counter()
with ThreadPoolExecutor(max_workers=jobs) as pool:
    results = list(pool.map(timed, variants))
wall = time.perf_counter() - t0
rows, failures = [], []
for v, secs, log, err, path in results:
    regs = ptxas_registers(log)
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    rows.append(dict(name=wk.kernel_name(v), code=wk.variant_code(v),
                     seconds=round(secs, 3),
                     registers=regs.get(wk.kernel_name(v)),
                     spill_stores=max(spills, default=None),
                     bytes=os.path.getsize(path) if path else None))
    if err:
        failures.append((wk.kernel_name(v), err[-3000:]))
secs = sorted(r["seconds"] for r in rows)
regs = sorted(r["registers"] for r in rows if r["registers"] is not None)
for name, err in failures:
    print(f"FAILED {name}:\n{err}", flush=True)
print(f"built {len(rows) - len(failures)} of {len(rows)} variants, "
      f"{len(failures)} failures, in {wall:.1f} s wall; per library "
      f"min {secs[0]:.1f} s, median {secs[len(secs) // 2]:.1f} s, max "
      f"{secs[-1]:.1f} s; registers {regs[0] if regs else None}-"
      f"{regs[-1] if regs else None} (median "
      f"{regs[len(regs) // 2] if regs else None}); variants with spill "
      f"stores: {sum(1 for r in rows if r['spill_stores'])}; "
      f"{sum(r['bytes'] or 0 for r in rows) / 2**20:.1f} MiB; {card}",
      flush=True)
by_regs = {}
for r in rows:
    by_regs.setdefault(r["registers"], []).append(r["name"])
for n in sorted(by_regs, key=lambda x: (x is None, x)):
    print(f"  {n} registers: {len(by_regs[n])} variants", flush=True)
os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
with open(os.path.join(ROOT, "chiprun_out", "build_all_variants.json"),
          "w") as f:
    json.dump(dict(card=card, jobs=jobs, wall_s=wall, rows=rows), f,
              indent=1)
shutil.rmtree(wk._BUILD_DIR, ignore_errors=True)
sys.exit(1 if failures else 0)
