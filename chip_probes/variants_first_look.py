#!/usr/bin/env python3
"""A first look at new walk-kernel variants on the card.

Builds every instantiation (printing ``ptxas`` registers and spills), then
runs 256 steps of kernel and plain version from fresh 8,192-lane states of
the analytic-check problems (no delta tracking in both geometry forms, the
transport sampler with the chain and with Robin off, the
variable-coefficient chain), comparing them under
``walk_kernel.compare_planes``; times 256 steps at the survey's full-size
state with the exact sampler (rounds 1 and 2) and the transport map; and
three short-walk solves (``bench.py --preset short``'s configuration).
Run from the repository's root on a card:
``python3 chip_probes/variants_first_look.py``.
"""
import dataclasses, os, re, sys, time
import numpy as np, torch
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the repository
sys.path.insert(0, ROOT)
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from dcrmontecarlo_tpu_torch.geometry import Polyline, square_loop
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch import models
from dcrmontecarlo_tpu_torch.survey import survey_default_options
import subprocess
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(), flush=True)
dev = torch.device("cuda", 0)
paths, secs, log = wk.build_library()
regs = {}
entry = None
for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m: entry = m.group(1)
    m = re.search(r"Used (\d+) registers", line)
    if m and entry:
        regs[entry] = int(m.group(1)); entry = None
print(f"build {secs:.1f} s, {len(paths)} libs", flush=True)
for k, v in sorted(regs.items()): print("regs", v, k)
for line in log.splitlines():
    if "spill" in line and not " 0 bytes spill stores, 0 bytes spill loads" in line: print(line)

def clone(s): return {k: v.clone() for k, v in s.items()}
def ms(fn):
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record(); fn(); b.record(); torch.cuda.synchronize(); return a.elapsed_time(b)

def case(name, prob, pts, opts, n_walks, max_steps, eps, steps=256, plain=True):
    solver = WoStSolver(prob, opts, device=dev)
    state, params, _, _ = solver._setup(pts, n_walks, max_steps, eps, 3)
    a, b = clone(state), clone(state)
    wk.run_walk(clone(state), params, 16)
    t_k = ms(lambda: wk.run_walk(a, params, steps))
    msg = f"{name:30s} {params.kernel_name} lanes {state['px'].numel()} kernel {t_k:.3f} ms steps {int(a['life'].sum())}"
    if plain:
        t_p = ms(lambda: wk.walk_plain(b, params, steps))
        frac, err, fin = wk.compare_planes(a, b, state_planes(params.n_src))
        bad = {k: round(v, 4) for k, v in frac.items() if v < 1}
        msg += f" plain {t_p:.1f} ms worst {min(frac.values()):.5f} fin {fin} {bad}"
    print(msg, flush=True)
    return state, params

o = SolverOptions(target_slots=8192)
BOX = [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
harm = Problem(dirichlet=square_loop(1.0), bc_dirichlet=fields.polynomial({(1,0):1.0,(0,1):2.0}))
case("harmonic", harm, np.array([[0,0],[0.5,0.3],[-0.7,-0.2],[0.2,-0.8]], np.float32), o, 8192, 200, 1e-3)
P4 = np.array([[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]], np.float32)
case("poisson", models.poisson_square()[0], P4, o, 8192, 300, 1e-3)
nbox = Problem(dirichlet=Polyline.from_points(BOX), neumann=Polyline.from_points([[-2.0,0.0],[2.0,0.0]]), bc_dirichlet=fields.polynomial({(1,0):1.0,(0,1):1.0}))
case("neumann_box", nbox, np.array([[0.0,-1.0],[0.5,-0.5],[-1.5,-0.02]], np.float32), o, 8192, 500, 1e-2)
case("obstacle", models.poisson_square(with_obstacle=True)[0], np.array([[1,1],[0.7,0],[0,-1.5],[-0.55,0.1]], np.float32), o, 8192, 500, 1e-3)
def tsq(half=2.0, per=25):
    c = [(half, half), (-half, half), (-half, -half), (half, -half)]; pts = []
    for s_ in range(4):
        (ax, ay), (bx, by) = c[s_], c[(s_+1)%4]
        for k in range(per): t = k/per; pts.append([ax+t*(bx-ax), ay+t*(by-ay)])
    pts.append(list(c[0])); return pts
tab = Problem(dirichlet=Polyline.from_points(tsq()), bc_dirichlet=fields.polynomial({(2,0):1.0,(0,2):1.0}), source=fields.constant(-4.0))
case("table_square", tab, P4, o, 8192, 300, 1e-3)
alpha = fields.terms(2.0, fields.term({(0,1):0.2}), fields.term(0.3, sx=("sin", 0.5)))
tp = Problem(dirichlet=Polyline.from_points(BOX), neumann=Polyline.from_points([[-2.0,0.0],[2.0,0.0]]), bc_dirichlet=fields.polynomial({(1,0):1.0,(0,1):1.0}), alpha=alpha)
for sampler in ("transport", "exact"):
    case(f"transport_box[{sampler}]", tp, np.array([[0.0,-1.0],[0.5,-0.5]], np.float32), SolverOptions(target_slots=8192, screened_sampler=sampler), 8192, 500, 1e-2)
case("poly_manufactured[transport]", models.polynomial_manufactured(2.0)[0], models.interior_grid(n_points=3), SolverOptions(target_slots=8192, screened_sampler="transport"), 8192, 800, 1e-3)
case("varcoeff chain", models.variable_coefficient_problem(), models.varcoeff_solve_points(n=5), SolverOptions(target_slots=8192, max_attenuation=50.0), 8192, 500, 1e-3)
sv, el = models.geophysical_scenario(sharpness=0.5)
pts = np.asarray(el, np.float32).copy(); pts[:, 1] = -0.5
for sampler, rounds in (("exact", 1), ("exact", 2), ("transport", 1), ("exact", 1)):
    case(f"survey full {sampler} r{rounds}", sv.build_problem(), pts, SolverOptions(target_slots=1 << 21, min_quota=32, rejection_rounds=rounds, screened_sampler=sampler), 1 << 19, 500, 0.9, plain=False)
# short-walk preset full size, one solve timing
s = WoStSolver(harm, SolverOptions(target_slots=1 << 19, min_quota=32), device=dev)
p3 = np.array([[0,0],[0.5,0.3],[-0.4,0.6]], np.float32)
for rep in range(3):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    r = s.solve(p3, n_walks=1 << 21, max_steps=200, eps=1e-3, seed=rep)
    t = time.perf_counter() - t0
    print("short", rep, f"{t:.4f} s", r.total_steps, r.mean, r.stderr, s.last_solve_stats, flush=True)
