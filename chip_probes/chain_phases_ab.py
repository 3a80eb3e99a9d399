#!/usr/bin/env python3
"""The chain + MIS builds' queued wall work against a parent checkout, A/B
on one card, bit for bit.

``csrc/walk_kernel.cu`` runs the variants of ``walk_variant.h::
chain_phases`` (the Robin chain and MIS without the freeze) in the repack
loop with their chain's wall work queued in shared memory
(``walk_step_chain``). This probe builds those variants from this
checkout and from ``PARENT`` (a checkout of the parent commit, e.g.
``git archive`` unpacked under ``_archive/``) in parallel and runs each
library through this checkout's wrapper on the same inputs, in turns
parent, change, change, parent:

- ``line``: 256 steps at ``chip_smoke.py`` phase 30's state (the notebook
  pseudosection, 688,128 lanes, 18 sources, 19 components), best of 3;
- ``flagship_shard``: 256 steps at phase 38's sharded flagship shard 0
  (172,032 lanes), best of 3;
- the siblings the rule also covers, 256 steps each on the sweep box of
  ``chip_smoke.py`` (8,192 lanes): the narrow chain + MIS and its table,
  ``TERMS``, grid and transport forms;
- phase 30's solve (seed 1, ``_solve_raw``) and phase 38's sharded
  flagship solve (seed 1): s, kernel ms (CUDA events), steps, launches,
  clones, ``max_banked``, and whether the means and stderrs equal the
  first turn's.

Every run's end planes must equal the first turn's on every lane. It
also checks the premise of the near-component mixture pdf: ``expf`` on
the card returns +0 for every float at or below -128 (one launch over all
of them). Prints each build's ``ptxas`` report and writes
``chiprun_out/chain_phases_ab.json``.

With ``--ablate`` it takes the change apart instead: copies of this
checkout's ``csrc/`` with one part undone (``ABLATIONS``: the mixture pdf
over every component, the chord mass or the arrival factor on its own
lane instead of queued, and all three), 256 steps of the two path builds
at their states in turns change, each copy, change, every end plane
equal to the change's; writes ``chiprun_out/chain_phases_ablate.json``.

    python3 chip_probes/chain_phases_ab.py PARENT
    python3 chip_probes/chain_phases_ab.py --ablate
"""

import json
import os
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
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
    make_mesh  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import dcr as sdcr  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa
import chip_smoke as cs  # noqa: E402
from step_sites import WORK, build, run256, use  # noqa: E402

TURNS = ("parent", "change", "change", "parent")
_F, _T = False, True
# the rule's other members on the sweep box: (name, variant, build)
SIBLINGS = (
    ("chain+mis", (1, _F, _T, _F, _F, _T, _F, _F, _F),
     dict(robin="chain", mis=True)),
    ("chain+mis table", (1, _F, _T, _F, _T, _T, _F, _F, _F),
     dict(robin="chain", mis=True, geometry="table")),
    ("chain+mis terms", (1, _F, _T, _F, _F, _T, _F, _F, _F, _T),
     dict(robin="chain", mis=True, alpha="terms")),
    ("chain+mis grid", (1, _F, _T, _F, _F, _T, _F, _F, _T),
     dict(robin="chain", mis=True, bc="grid")),
    ("chain+mis transport", (1, _F, _T, _F, _F, _T, _T, _F, _F),
     dict(robin="chain", mis=True, sampler="transport")),
)

# (name, edits of walk_kernel.cu): a part of the change undone
_NEAR_OFF = (("mis_nee<true, TABLE, WIDE, true>(",
              "mis_nee<true, TABLE, WIDE, false>("),)
_MASS_INLINE = (("  const bool mass = go && ob;\n",
                 "  if (go && ob) chord_mass<TERMS>(px, py, nx, ny, rmin, sbar, "
                 "r, c_mag);\n  const bool mass = false;\n"),)
_ARRIVAL_INLINE = (("      edge_hit = new_ob;\n",
                    "      if (new_ob) scale = scale * arrival_factor<TERMS>("
                    "hx, hy, hnx, hny, dx, dy, t_hit, r, sbar);\n"
                    "      edge_hit = false;\n"),)
ABLATIONS = (("pdf_all_components", _NEAR_OFF),
             ("chord_mass_on_lane", _MASS_INLINE),
             ("arrival_on_lane", _ARRIVAL_INLINE),
             ("all_three", _NEAR_OFF + _MASS_INLINE + _ARRIVAL_INLINE))

EXPF_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// every float x <= -128 (sign bit set, |x| >= 128, and -inf): how many
// give expf(x) != +0
__global__ void count_nonzero(unsigned long long* bad) {
  const uint32_t lo = 0xC3000000u;  // -128.0f
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lo + i <= 0xFF800000u; i += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)(lo + i));
    const float e = expf(x);
    if (__float_as_uint(e) != 0u) atomicAdd(bad, 1ull);
  }
}
extern "C" int expf_nonzero_below_minus_128(unsigned long long* out) {
  unsigned long long* d;
  if (cudaMalloc(&d, sizeof *d) != cudaSuccess) return -1;
  cudaMemset(d, 0, sizeof *d);
  count_nonzero<<<1024, 256>>>(d);
  cudaMemcpy(out, d, sizeof *d, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)cudaGetLastError();
}
"""


def expf_check():
    import ctypes

    src = WORK / "expf_check.cu"
    src.write_text(EXPF_CHECK)
    so = WORK / "expf_check.so"
    subprocess.run([wk._nvcc(), *wk.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    out = ctypes.c_ulonglong(0)
    assert lib.expf_nonzero_below_minus_128(ctypes.byref(out)) == 0
    return int(out.value)


def timed_solve(solve):
    """One solve through ``solve(walk)`` with each launch bracketed by
    CUDA events: ``(s, kernel ms, result)``."""
    events = []

    def walk(state, params, n, thr=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wk.run_walk(state, params, n, thr)
        b.record()
        events.append((a, b))
        return state

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(walk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, sum(a.elapsed_time(b) for a, b in events), res


def ablated_source(name, edits):
    dst = WORK / f"ablate_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(wk._SRC.parent, dst)
    src = (dst / "walk_kernel.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    (dst / "walk_kernel.cu").write_text(src)
    return dst


def path_states(dev):
    """The two path builds' full-size states: phase 30's line and phase
    38's flagship shard 0 (seed 5)."""
    line_survey, line_elec = notebook_survey()
    line_survey.source_mis = True
    line_prob, line_pts, _, _ = sdcr._line_problem(line_survey, line_elec, 8)
    line = WoStSolver(line_prob, SolverOptions(
        target_slots=1 << 21, min_quota=32, common_random_numbers=True),
        device=dev)
    flag_survey, nb_elec = notebook_survey()
    flag_survey.local_majorant = "auto"
    flag_survey.source_mis = True
    nb_pts = np.asarray(nb_elec, np.float32)
    sharded = ShardedWoStSolver(
        flag_survey.build_problem(), make_mesh(4, device=dev),
        survey_default_options(target_slots=1 << 21, min_quota=32,
                               split_threshold=4.0))
    shard = sharded._shard(sharded._plan(nb_pts, 1 << 20, 6000, 1.0, 5), 0)
    return (line, line_pts, sharded, nb_pts,
            {"line": line._setup(line_pts, 1 << 20, 6000, 1.0, 5)[:2],
             "flagship_shard": (shard.state, shard.params)})


def ablate(card):
    dev = torch.device("cuda", 0)
    sources = {"change": wk._SRC.parent}
    for name, edits in ABLATIONS:
        sources[name] = ablated_source(name, edits)
    groups = path_states(dev)[-1]
    variants = {p.variant for _, p in groups.values()}
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = {(tag, v): pool.submit(build, tag, src, v)
                for tag, src in sources.items() for v in variants}
        built = {k: f.result() for k, f in jobs.items()}
    for (tag, v), (_, report) in sorted(built.items(), key=str):
        print(tag, wk.kernel_name(v), report, flush=True)
    record = dict(card=card, groups={})
    for name, (state, params) in groups.items():
        runs = []
        for tag in ("change",) + tuple(a for a, _ in ABLATIONS) + (
                "change",):
            use({wk.variant_code(v): built[(tag, v)][0] for v in variants})
            runs.append((tag, *run256(state, params)[:2]))
        equal = len({h for _, _, h in runs}) == 1
        record["groups"][name] = dict(kernel=params.kernel_name, runs=runs,
                                      equal=equal)
        print(f"{name} ({params.kernel_name}): 256 steps ms "
              f"{[(t, round(ms, 4)) for t, ms, _ in runs]}; end planes "
              f"{'equal' if equal else 'DIFFER'} ({card})", flush=True)
    with open(ROOT / "chiprun_out" / "chain_phases_ablate.json", "w") as f:
        json.dump(record, f)


def main():
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    WORK.mkdir(parents=True, exist_ok=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    if sys.argv[1] == "--ablate":
        return ablate(card)
    parent = Path(sys.argv[1]).resolve()
    dev = torch.device("cuda", 0)
    sources = {"parent": parent / "dcrmontecarlo_tpu_torch" / "csrc",
               "change": wk._SRC.parent}
    line, line_pts, sharded, nb_pts, groups = path_states(dev)
    for name, variant, spec_kw in SIBLINGS:
        spec = cs.sweep_spec((name, variant, spec_kw))
        solver = WoStSolver(cs.sweep_problem(spec), cs.sweep_options(
            spec, target_slots=8192), device=dev)
        state, params, _, _ = solver._setup(
            cs.SWEEP_POINTS, 1 << 13, cs.SWEEP_MAX_STEPS, cs.SWEEP_EPS, 5)
        assert params.variant == wk._canonical(variant), (name,
                                                          params.variant)
        groups[name] = (state, params)
    variants = {p.variant for _, p in groups.values()}
    assert all(wk.chain_phases(v) for v in variants)

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = {(tag, v): pool.submit(build, tag, src, v)
                for tag, src in sources.items() for v in variants}
        nonzero = expf_check()
        built = {k: f.result() for k, f in jobs.items()}
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s "
          f"({card}); expf(x) != +0 for {nonzero} floats x <= -128",
          flush=True)
    for (tag, v), (_, report) in sorted(built.items(), key=str):
        print(tag, wk.kernel_name(v), report, flush=True)

    def libraries(tag):
        use({wk.variant_code(v): built[(tag, v)][0] for v in variants})

    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  expf_nonzero_below_minus_128=nonzero, groups={},
                  reports={f"{tag} {wk.kernel_name(v)}": r
                           for (tag, v), (_, r) in built.items()})
    for name, (state, params) in groups.items():
        runs = []
        for tag in TURNS:
            libraries(tag)
            runs.append((tag, *run256(state, params)[:2]))
        equal = len({h for _, _, h in runs}) == 1
        record["groups"][name] = dict(kernel=params.kernel_name,
                                      lanes=state["px"].numel(), runs=runs,
                                      equal=equal)
        print(f"{name} ({params.kernel_name}, {state['px'].numel()} lanes): "
              f"256 steps ms {[(t, round(ms, 4)) for t, ms, _ in runs]}; "
              f"end planes {'equal' if equal else 'DIFFER'} ({card})",
              flush=True)

    solves = {
        "phase 30": lambda walk: line._solve_raw(line_pts, 1 << 20, 6000,
                                                 1.0, 1, walk=walk),
        "phase 38 flagship": lambda walk: sharded._solve_raw(
            nb_pts, 1 << 20, 6000, 1.0, 1, walk=walk)}
    record["solves"] = {}
    for what, solve in solves.items():
        stats_of = line if what == "phase 30" else sharded
        out, first = [], None
        for tag in TURNS:
            libraries(tag)
            wall, kern, res = timed_solve(solve)
            st = stats_of.last_solve_stats
            key = (float(res.total_steps), json.dumps(st, sort_keys=True,
                                                      default=str),
                   float(res.max_banked), np.asarray(res.mean).tobytes(),
                   np.asarray(res.stderr).tobytes())
            first = first or key
            out.append(dict(tag=tag, s=wall, kernel_ms=kern,
                            steps=float(res.total_steps),
                            max_banked=float(res.max_banked),
                            stats=json.loads(key[1]), equal=key == first))
            print(f"{what} seed 1, {tag}: {wall:.4f} s, kernel "
                  f"{kern:.1f} ms, {res.total_steps:.0f} steps, "
                  f"max_banked {float(res.max_banked):.6g}, {st}; steps, "
                  f"stats, means and stderrs "
                  f"{'equal to' if key == first else 'DIFFER from'} the "
                  f"first ({card})", flush=True)
        record["solves"][what] = out
    with open(ROOT / "chiprun_out" / "chain_phases_ab.json", "w") as f:
        json.dump(record, f)


if __name__ == "__main__":
    main()
