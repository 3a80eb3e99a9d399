#!/usr/bin/env python3
"""The walk kernel's wide form on one checkout, for A/B runs on one card.

Builds the checkout's kernels, prints each instantiation's registers
(``ptxas -v``), and times 256 steps (best of 3, CUDA events) of the three
wide instantiations at the states ``chip_smoke.py`` times them: the
scenario line's 6 sources at phase 7's full-size survey state (147,456
lanes), the Born demo's Jacobian stencil (8 sources, 9 components; 65,536
lanes) and the notebook line (18 sources, 19 components, chain + MIS) at
phase 30's state (688,128 lanes); then one full-size notebook-line solve
(21 x 2^20 walks) after a warm-up at 2^16. Run from the repository's root
with the checkout to time and a tag; to compare two designs, run both
trees in one call, in turns:

    for t in "_archive/other a1" ". b1" ". b2" "_archive/other a2"; do
        set -- $t; python3 chip_probes/wide_form_times.py $1 $2; done

The other tree of the comparison in PERF.md (the first design of the wide
form, 32 sources unrolled with the accumulators in registers) was a
working copy that was discarded and is not in the repository: its columns
there cannot be reproduced from a checkout, only the final design's.
"""

import os
import re
import sys
import time

tree = os.path.abspath(sys.argv[1])
tag = sys.argv[2]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.models import geophysical_scenario, \
    notebook_survey  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.problems import fields  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import DCRSurvey, \
    surface_electrode_line  # noqa: E402
from dcrmontecarlo_tpu_torch.survey.dcr import _line_problem  # noqa: E402
from dcrmontecarlo_tpu_torch.survey.sensitivity import \
    _jacobian_problem  # noqa: E402

assert wk.__file__.startswith(tree), wk.__file__
# this checkout's chip_smoke.py reads the registers and builds
from this_checkout import chip_smoke  # noqa: E402

ptxas_registers = chip_smoke().ptxas_registers
build_variants = chip_smoke().build_variants
dev = torch.device("cuda", 0)
t0 = time.time()
_, _, build_log = build_variants(wk)
build_s = time.time() - t0
regs = ptxas_registers(build_log)
# spill stores of the wide instantiations (the entries whose mangled names
# carry a seventh true)
spills, entry = {}, ""
for line in build_log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        entry = m.group(1)
    m = re.search(r"(\d+) bytes spill stores", line)
    if m and re.search(r"walk_kernelILi\d(?:ELb\d){6}ELb1E", entry):
        spills[entry[:40]] = int(m.group(1))


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def best_256(state, params, reps=3):
    wk.run_walk(clone(state), params, 16)
    out = []
    for _ in range(reps):
        s = clone(state)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wk.run_walk(s, params, 256)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return min(out), params.kernel_name


res = {}
survey, electrodes = geophysical_scenario(sharpness=0.5)
prob, _, _, _ = _line_problem(survey, electrodes, 3)
pts = np.asarray(electrodes, np.float32).copy()
pts[:, 1] = -0.5
solver = WoStSolver(prob, SolverOptions(target_slots=1 << 21, min_quota=32,
                                        rejection_rounds=1), device=dev)
state, params, _, _ = solver._setup(pts, 1 << 19, 500, 0.9, 5)
res["scenario_line_6src"] = best_256(state, params)

elec = surface_electrode_line((-20.0, 20.0), 5.0)
born = DCRSurvey(half_width=60.0, depth=60.0, current_a=tuple(elec[0]),
                 current_b=tuple(elec[1]), conductivity=fields.constant(1.0),
                 source_width=1.5, source_mis=True)
grid = np.stack([a.ravel() for a in np.meshgrid(
    np.linspace(-22.0, 22.0, 12), np.linspace(-20.0, -3.0, 7),
    indexing="ij")], 1)
stencil = np.concatenate([grid + d for d in (
    [0.0, 0.0], [1.5, 0.0], [-1.5, 0.0], [0.0, 1.5], [0.0, -1.5])])
solver = WoStSolver(_jacobian_problem(born, elec), SolverOptions(
    target_slots=1 << 16, common_random_numbers=True), device=dev)
state, params, _, _ = solver._setup(stencil.astype(np.float32), 1500, 500,
                                    0.3, 5)
res["born_demo_8src"] = best_256(state, params)

nb, nb_elec = notebook_survey()
nb.source_mis = True
prob, nb_pts, _, _ = _line_problem(nb, nb_elec, 8)
solver = WoStSolver(prob, SolverOptions(target_slots=1 << 21, min_quota=32,
                                        common_random_numbers=True),
                    device=dev)
state, params, _, _ = solver._setup(nb_pts, 1 << 20, 6000, 1.0, 5)
res["notebook_line_18src"] = best_256(state, params)
solver.solve(nb_pts, n_walks=1 << 16, max_steps=6000, eps=1.0, seed=0)
torch.cuda.synchronize()
t = time.perf_counter()
out = solver.solve(nb_pts, n_walks=1 << 20, max_steps=6000, eps=1.0, seed=1)
solve_s = time.perf_counter() - t
card = torch.cuda.get_device_name(0)
print(tag, f"build {build_s:.1f} s, spill stores {spills} bytes",
      {k: (round(v[0], 3), v[1], regs.get(v[1])) for k, v in res.items()},
      f"notebook line solve {solve_s:.3f} s, "
      f"{out.total_steps / solve_s:.4g} walker-steps/s", card, flush=True)
print(tag, "registers", regs, flush=True)
