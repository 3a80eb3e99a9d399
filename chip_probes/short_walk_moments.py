#!/usr/bin/env python3
"""Where the short-walk solve's time goes, and what the moment sums cost.

``bench.py --preset short``'s configuration (``x + 2y`` on the unit
square, 3 points x 2^21 walks, ``SolverOptions(target_slots=1<<19,
min_quota=32)``: 196,608 lanes) on the card: 7 timed solves (median and
min s/solve) with each way of summing the per-point moments, in turns:
``point_sums`` (the solver's: float64 prefix sums, no atomics), ``index_add_``
(float atomics, nondeterministic) and ``index_put_(accumulate=True)``
(sorted, deterministic); whether each gives bit-equal sums on repeated
calls; a ``torch.profiler`` trace of 3 solves (the device's busy time,
kernels only, against the wall time, and the top operations); and the
flagship full-size solve (``chip_smoke.py`` phase 15) with ``point_sums``
and with ``index_add_`` in the solve and the split. Run from the
repository's root on a card: ``python3 chip_probes/short_walk_moments.py``.
"""

import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dcrmontecarlo_tpu_torch.geometry import square_loop  # noqa: E402
from dcrmontecarlo_tpu_torch.models import notebook_survey  # noqa: E402
from dcrmontecarlo_tpu_torch.problems import Problem, fields  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import split as split_mod  # noqa
from dcrmontecarlo_tpu_torch.solver import wost  # noqa: E402
from dcrmontecarlo_tpu_torch.solver.state import point_sums  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)


def add_sums(out, pid, values):
    return out.index_add_(1, pid, values)


def put_sums(out, pid, values):
    for k in range(out.shape[0]):
        out[k].index_put_((pid,), values[k], accumulate=True)
    return out


SUMS = {"point_sums": point_sums, "index_add_": add_sums,
        "index_put_": put_sums}


def use(fn):
    wost.point_sums = fn
    split_mod.point_sums = fn


dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(0)
vals = (torch.rand(2, 1 << 20, generator=g) * 100).to(dev)
pid = torch.randint(0, 9, (1 << 20,), generator=g).to(dev)
for name, fn in SUMS.items():
    a = fn(torch.zeros(2, 9, device=dev), pid, vals)
    b = fn(torch.zeros(2, 9, device=dev), pid, vals)
    print(f"{name}: repeated sums bit-equal {bool((a == b).all())}",
          flush=True)

prob = Problem(dirichlet=square_loop(1.0),
               bc_dirichlet=fields.polynomial({(1, 0): 1.0, (0, 1): 2.0}))
pts = np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]], np.float32)
solver = WoStSolver(prob, SolverOptions(target_slots=1 << 19, min_quota=32))


def solve(seed):
    return solver.solve(pts, n_walks=1 << 21, max_steps=200, eps=1e-3,
                        seed=seed)


solve(99)
for name in ("point_sums", "index_add_", "index_put_", "index_put_",
             "index_add_", "point_sums"):
    use(SUMS[name])
    ts = []
    for i in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve(i)
        ts.append(time.perf_counter() - t)
    print(f"short walk with {name}: median {statistics.median(ts):.5f} s, "
          f"min {min(ts):.5f} s per solve", flush=True)
use(point_sums)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    t = time.perf_counter()
    for i in range(3):
        solve(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
ka = p.key_averages()
busy = sum(e.self_device_time_total for e in ka
           if e.self_device_time_total > 0 and not e.key.startswith("aten::")
           and not e.key.startswith("cuda"))
print(f"3 short-walk solves: wall {wall * 1e3:.3f} ms, device busy "
      f"{busy / 1e3:.3f} ms (kernels and copies), idle share "
      f"{1 - busy / 1e3 / (wall * 1e3):.4f}", flush=True)
print(ka.table(sort_by="self_device_time_total", row_limit=10,
               max_name_column_width=60))
print(ka.table(sort_by="self_cpu_time_total", row_limit=12,
               max_name_column_width=60))

nb, nb_pts = notebook_survey()
nb.local_majorant = "auto"
nb.source_mis = True
nb_pts = np.asarray(nb_pts, np.float32)
flag = nb.make_solver(survey_default_options(
    target_slots=1 << 21, min_quota=32, split_threshold=4.0))
flag.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0, seed=0)
for name in ("point_sums", "index_add_", "index_add_", "point_sums"):
    use(SUMS[name])
    torch.cuda.synchronize()
    t = time.perf_counter()
    flag.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0, seed=1)
    print(f"flagship with {name}: {time.perf_counter() - t:.3f} s, "
          f"{flag.last_solve_stats}", flush=True)
