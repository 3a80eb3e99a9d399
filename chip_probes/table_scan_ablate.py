#!/usr/bin/env python3
"""The table form's culled scans taken apart, on one card, bit for bit.

Builds the table builds that ``chip_smoke.py``'s paths and checks launch
(phase 20's survey on the terrain, phase 41's terrain flagship, phase
18's table chain, phase 21's no-delta table square and the sweep's table
variants) from this checkout's ``csrc/``, from ``PARENT``'s (the full
scans) and from copies of this checkout's with one part changed
(``ABLATIONS``: no culled scan at all, the first hit in full, the closest
point in full, chunks of 16 rows, the skip test off), and runs each at
its path's state (best of 3 after one, in turns parent, change, each
copy, change, parent): 256 steps at phase 20's state fresh and after 512
steps, at phase 41's (freeze 4.0), at phase 18's, phase 16's and phase
21's (8,192 lanes); 64 steps at the sweep's (8,192 lanes); every end
plane equal to the parent's. Prints each build's ``ptxas`` report;
writes ``chiprun_out/table_scan_ablate.json``.

    python3 chip_probes/table_scan_ablate.py PARENT [NAME ...]

Names after ``PARENT`` pick some of the ablations.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "chip_probes"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa
import chip_smoke as cs  # noqa: E402
from chain_phases_ab import ablated_source, build_all  # noqa: E402
from dcrmontecarlo_tpu_torch.geometry import Polyline  # noqa: E402
from dcrmontecarlo_tpu_torch.problems import Problem, fields  # noqa: E402

SWEEP_TABLE = [c for c in cs.SWEEP if c[1][4]]
from step_sites import WORK, use  # noqa: E402

# (name, chunk rows, edits of walk_kernel.cu)
_HIT_LOOP = ("  if constexpr (TABLE && CULLED) {\n    const int c0 = chunks_of("
             "C.n_dir), n_ch = chunks_of(C.n_neu);\n    for (int ch = 0; ch < "
             "n_ch; ++ch) {\n      const float4* rec")
_DIR_LOOP = ("  if constexpr (TABLE && CULLED) {\n    const int n_ch = "
             "chunks_of(C.n_dir);")
ABLATIONS = (
    ("no_cull", 8, (("constexpr bool CULLED =\n",
                     "constexpr bool CULLED = false &&\n"),)),
    ("hit_full", 8, ((_HIT_LOOP, _HIT_LOOP.replace("TABLE && CULLED",
                                                   "false")),)),
    ("closest_full", 8, ((_DIR_LOOP, _DIR_LOOP.replace("TABLE && CULLED",
                                                       "false")),)),
    ("chunks16", 16, (("constexpr int CHUNK_ROWS = 8,",
                       "constexpr int CHUNK_ROWS = 16,"),)),
    ("no_skip", 8, (("constexpr bool CHUNK_SKIP = true;",
                     "constexpr bool CHUNK_SKIP = false;"),)),
)
_F, _T = False, True
VARIANTS = [(0, _F, _F, _F, _T, _T, _F, _F, _F),
            (0, _T, _T, _T, _T, _T, _F, _F, _F),
            (1, _F, _F, _F, _T, _T, _F, _F, _F),
            (0, _F, _F, _F, _T, _F, _F, _F, _F)]


def groups(dev):
    prob, h = topographic_survey_problem()
    pts = drape_electrodes(h, cs.TOPO_XS, nudge=0.5)
    args = (pts, cs.P2_WALKS, cs.P2_MAX_STEPS, cs.P2_EPS, 5)
    s20 = WoStSolver(prob, SolverOptions(target_slots=1 << 21), device=dev)
    out = {"p20": s20._setup(*args)[:2] + (None,)}
    st, p = s20._setup(*args)[:2]
    wk.run_walk(st, p, 512)
    out["p20_spread"] = (st, p, None)
    flag, _ = cs.terrain_flagship_problem()
    s41 = WoStSolver(flag, survey_default_options(
        target_slots=1 << 21, split_threshold=cs.P2_SPLIT), device=dev)
    out["p41"] = s41._setup(*args)[:2] + (cs.P2_SPLIT,)
    small = dict(half_width=100.0, depth=150.0)
    prob18, h18 = topographic_survey_problem(resolution=4.0, **small)
    pts18 = drape_electrodes(h18, cs.TOPO_XS, nudge=0.5)
    s18 = WoStSolver(prob18, SolverOptions(robin_correction="chain",
                                           target_slots=8192), device=dev)
    out["p18"] = s18._setup(pts18, 8192, 600, 0.5, 3)[:2] + (None,)
    s16 = WoStSolver(prob, SolverOptions(target_slots=8192), device=dev)
    out["p16"] = s16._setup(pts, 8192, 600, 0.5, 3)[:2] + (None,)
    c = [(2.0, 2.0), (-2.0, 2.0), (-2.0, -2.0), (2.0, -2.0)]
    sq = [[a[0] + k / 25 * (b[0] - a[0]), a[1] + k / 25 * (b[1] - a[1])]
          for a, b in zip(c, c[1:] + c[:1]) for k in range(25)]
    square = Problem(dirichlet=Polyline.from_points(sq + [list(c[0])]),
                     bc_dirichlet=fields.polynomial({(2, 0): 1.0,
                                                     (0, 2): 1.0}),
                     source=fields.constant(-4.0))
    p4 = np.array([[0.0, 0.0], [1.0, 0.5], [-1.2, -0.7], [0.3, 1.5]],
                  np.float32)
    out["p21"] = WoStSolver(square, SolverOptions(target_slots=8192),
                            device=dev)._setup(p4, 1 << 16, 300, 1e-3,
                                               3)[:2] + (None,)
    for case in SWEEP_TABLE:
        spec = cs.sweep_spec(case)
        st, p = WoStSolver(cs.sweep_problem(spec), cs.sweep_options(
            spec, target_slots=8192), device=dev)._setup(
            cs.SWEEP_POINTS, 1 << 13, cs.SWEEP_MAX_STEPS, cs.SWEEP_EPS, 3)[:2]
        out[f"p42:{case[0]}"] = (st, p, spec["split"] if p.freeze else None,
                                 64)
    return out


def main():
    parent = Path(sys.argv[1]).resolve()
    ablations = [a for a in ABLATIONS if a[0] in sys.argv[2:]
                 or len(sys.argv) < 3]
    dev = torch.device("cuda", 0)
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {"parent": parent / "dcrmontecarlo_tpu_torch" / "csrc",
               "change": wk._SRC.parent}
    rows = {"parent": wk.CHUNK_ROWS, "change": wk.CHUNK_ROWS}
    for name, per, edits in ablations:
        sources[name] = ablated_source(name, edits)
        rows[name] = per
    variants = VARIANTS + [wk._canonical(c[1]) for c in SWEEP_TABLE]
    built = build_all(sources, variants)
    for (tag, v), (_, report) in sorted(built.items(), key=str):
        print(tag, wk.kernel_name(v), report, flush=True)
    shipped = wk.CHUNK_ROWS
    record = dict(card=card, groups={})
    turns = ("parent", "change") + tuple(a for a, _, _ in ablations) + (
        "change", "parent")
    for name, (state, params, thr, *steps) in groups(dev).items():
        n = steps[0] if steps else 256
        runs = []
        for tag in turns:
            wk.CHUNK_ROWS = rows[tag]
            params._cache.pop(("chunks", str(dev)), None)
            use({wk.variant_code(v): built[(tag, v)][0] for v in variants})
            ms = []
            for _ in range(4):
                s = {k: v.clone() for k, v in state.items()}
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                wk.run_walk(s, params, n, thr)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            h = hashlib.sha256(b"".join(
                s[k].cpu().numpy().tobytes() for k in sorted(s))).hexdigest()
            runs.append((tag, round(min(ms[1:]), 4), h[:16]))
        wk.CHUNK_ROWS = shipped
        equal = len({h for _, _, h in runs}) == 1
        record["groups"][name] = dict(kernel=params.kernel_name,
                                      lanes=state["px"].numel(), runs=runs,
                                      equal=equal)
        print(f"{name} ({params.kernel_name}, {state['px'].numel()} lanes): "
              f"256 steps ms {[(t, ms) for t, ms, _ in runs]}; end planes "
              f"{'equal' if equal else 'DIFFER'} ({card})", flush=True)
    with open(ROOT / "chiprun_out" / "table_scan_ablate.json", "w") as f:
        json.dump(record, f, default=str)


if __name__ == "__main__":
    main()
