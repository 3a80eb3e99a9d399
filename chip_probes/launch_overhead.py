#!/usr/bin/env python3
"""Where a short kernel's 256-step time goes: the launch's host part, the
kernel alone, and the compiled code, for one checkout.

At the short walk's full-size state (``chip_smoke.py`` phase 25: 196,608
lanes of the no-delta instantiation) it times, with CUDA events:

- ``budget0``: ``run_walk`` with no steps, which packs the parameters,
  lists the plane pointers and copies the constant block but launches no
  kernel (median of 50);
- ``one``: one 256-step ``run_walk`` from a fresh copy of the state, as
  ``ab_walk_times.py`` times it (median of 30);
- ``pipelined``: 20 such launches queued back to back on 20 copies, the
  total over 20: the kernel without the host's gaps (median of 5);

and prints the instantiation's SASS instruction count and a hash of its
instructions without addresses (``cuobjdump -sass``). To compare two
commits, run both trees in one call, in turns, as ``ab_walk_times.py``:

    for t in "_archive/parent p1" ". c1" ". c2" "_archive/parent p2"; do
        set -- $t; python3 chip_probes/launch_overhead.py $1 $2; done
"""

import hashlib
import os
import re
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
tag = sys.argv[2]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.geometry import square_loop  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.problems import Problem, fields  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402

assert wk.__file__.startswith(tree), wk.__file__
dev = torch.device("cuda", 0)
from this_checkout import chip_smoke  # noqa: E402

build_variants = chip_smoke().build_variants

build_variants(wk)
harmonic = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=fields.polynomial({(1, 0): 1.0,
                                                   (0, 1): 2.0}))
solver = WoStSolver(harmonic, SolverOptions(target_slots=1 << 19,
                                            min_quota=32), device=dev)
state, params, _, _ = solver._setup(
    np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]], np.float32), 1 << 21,
    200, 1e-3, 5)


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def timed(fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


wk.run_walk(clone(state), params, 16)
s0 = clone(state)
budget0 = [timed(lambda: wk.run_walk(s0, params, 0)) for _ in range(50)]
one = []
for _ in range(30):
    s = clone(state)
    one.append(timed(lambda: wk.run_walk(s, params, 256)))
pipelined = []
for _ in range(5):
    copies = [clone(state) for _ in range(20)]
    pipelined.append(timed(lambda: [wk.run_walk(c, params, 256)
                                    for c in copies]) / 20)
    del copies

so = wk._library_path(params.variant if hasattr(wk, "valid_variant")
                      else wk.variant_code(params.variant))
cuobjdump = os.path.join(os.path.dirname(wk._nvcc()), "cuobjdump")
sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                      text=True, timeout=120).stdout
ops = [re.sub(r"/\*[0-9a-f]+\*/|;.*$", "", line).strip()
       for line in sass.splitlines()
       if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line)]
print(tag, params.kernel_name, {
    "budget0_ms": round(float(np.median(budget0)), 4),
    "one_ms": round(float(np.median(one)), 4),
    "one_quartiles": [round(float(q), 4)
                      for q in np.percentile(one, (25, 75))],
    "pipelined_ms": round(float(np.median(pipelined)), 4),
    "sass_instructions": len(ops),
    "sass_hash": hashlib.sha256("\n".join(ops).encode()).hexdigest()[:12]},
    torch.cuda.get_device_name(0), flush=True)
