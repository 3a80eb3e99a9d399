#!/usr/bin/env python3
"""The survey builds' whole-solve launches of one checkout, for A/B runs.

Two builds of ``csrc/walk_kernel.cu``: the main path's survey build
``<0,false,false,false,false,true,false>`` (``chip_smoke.py`` phase 6: 9
points x 2^19 walks on 147,456 lanes) and the Jacobian's wide survey with
MIS ``<0,false,true,false,false,true,false,true>`` (phase 31: a batch of
1,500 walks at the 420 stencil points, 65,536 lanes, 8 sources, 9
mixture components). For each: the registers (``cuobjdump -res-usage``)
and the SASS instruction mix by opcode class of each kernel function of
the checkout's library; the solve's single launch from a fresh state
(seed 5; best of 3, CUDA events), with a hash of its end planes and the
longest lane; 256 steps at that state (best of 3); then whole solves:
phase 6's (a warm-up, then seeds 1-3: s/solve, walker-steps/s, the
kernel's share of the wall time, truncated walks) and phase 31's
Jacobian call (seed 6 after a warm-up at 5), each with a hash of every
output it returns (means, stderrs, steps, truncated count and weight,
``max_weight``, ``max_banked``; the Jacobian's rows and stderrs); and the
budgeted launches of the survey's step that the dealt loop leaves alone:
256 steps of four shards of phase 6's state in one launch (phase 38's
kernel) and of phase 40's freeze build. To
compare two commits, unpack the parent into a git-ignored folder
(``git archive <commit> | tar -x -C _archive/parent``) and run in turns,
in one call:

    for t in "_archive/parent p1" ". c1" ". c2" "_archive/parent p2"; do
        set -- $t; python3 chip_probes/survey_ab.py $1 $2; done

``--build transport`` or ``--build mis`` times, in place of the two
builds above, the survey build with the transport sampler
``<0,false,false,false,false,true,true>`` or with the survey's MIS mixture
``<0,false,true,false,false,true,false>`` at the same full-size state
(``chip_smoke.py::survey_config``, phase 43's solves): its registers and
SASS mix, the single launch, 256 steps and the three solves, no Jacobian
or budgeted launches.

``--ablate PIECE[,PIECE]`` (this checkout) builds the two libraries from
a copy of ``csrc/`` under ``_archive/survey_ab/`` with the named pieces of
the dealt loop taken out, the shipped source untouched: ``one_pass``
(alpha and sigma' at a colliding sample in two passes, as the one-thread
loop does), ``ball_once`` (the survey MIS build's interior probability
anew for the MIS norm and the interior test) and ``sincos`` (its
Box-Muller pair by ``cosf`` and ``sinf``) and ``min_blocks_1`` (the
transport build's dealt loop with launch bounds of 1 block a SM in place
of 8). Writes
``chiprun_out/survey_ab_TAG.json``.

    python3 chip_probes/survey_ab.py . ablate --ablate one_pass
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ap = argparse.ArgumentParser()
ap.add_argument("tree")
ap.add_argument("tag")
ap.add_argument("--ablate", default="")
ap.add_argument("--build", choices=("survey", "transport", "mis"),
                default="survey")
args = ap.parse_args()
tree = os.path.abspath(args.tree)
sys.path.insert(0, tree)
HERE = Path(__file__).resolve().parents[1]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_jacobian  # noqa: E402

assert wk.__file__.startswith(tree), wk.__file__
sys.path.insert(1, str(HERE / "chip_probes"))
from this_checkout import chip_smoke  # noqa: E402

cs = chip_smoke()
dev = torch.device("cuda", 0)
card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                      text=True).stdout.strip()

SURVEY = (0, False, False, False, False, True, False, False, False)
WIDE_MIS = (0, False, True, False, False, True, False, True, False)
TRANSPORT = (0, False, False, False, False, True, True, False, False)
SURVEY_MIS = (0, False, True, False, False, True, False, False, False)
BUILDS = {"survey": SURVEY, "transport": TRANSPORT, "mis": SURVEY_MIS}
# the dealt loop's pieces: (file, anchor, replacement) edits that take one
# out
PIECES = {
    "one_pass": (("walk_kernel.cu", "#define WALK_ONE_PASS\n", ""),
                 ("walk_kernel.cu", "#undef WALK_ONE_PASS\n", "")),
    "ball_once": (("walk_kernel.cu", "#define WALK_BALL_ONCE\n", ""),
                  ("walk_kernel.cu", "#undef WALK_BALL_ONCE\n", "")),
    "sincos": (("walk_kernel.cu", "    sincosf(ang, &s_ang, &c_ang);\n",
                "    c_ang = cosf(ang);\n    s_ang = sinf(ang);\n"),),
    "min_blocks_1": (("walk_kernel.cu",
                      "constexpr int DEALT_MIN_BLOCKS = 8;\n",
                      "constexpr int DEALT_MIN_BLOCKS = 1;\n"),),
}
# SASS opcode classes, by the mnemonic's first part
CLASSES = (("fp32", r"F(ADD|MUL|FMA|MNMX|SETP|SEL|CHK|SET|RND)\b"),
           ("sfu", r"MUFU\b"),
           ("int", r"(IADD3|IMAD|LOP3|SHF|ISETP|IMNMX|LEA|IABS|SEL|POPC|FLO|"
                   r"BREV|PRMT|BMSK|SGXT|VIADD|VIMNMX|ISCADD)\b"),
           ("convert", r"(I2F|F2I|F2F|I2I|FRND)\b"),
           ("load_store", r"(LDG|STG|LDS|STS|LDC|ULDC|LDL|STL|LD|ST|ATOMG|"
                          r"ATOM|ATOMS|RED|CCTL)\b"),
           ("move", r"(MOV|UMOV|S2R|S2UR|CS2R|R2UR|SHFL|VOTE|PLOP3|P2R|"
                    r"R2P)\b"),
           ("control", r"(BRA|BSSY|BSYNC|EXIT|CALL|RET|WARPSYNC|BAR|NOP|"
                       r"YIELD|BREAK|JMP|BPT)\b"))


def short_name(fn):
    """A kernel's mangled name without its anonymous namespace and
    parameter list: ``walk_dealtILi0ELb0...E``."""
    fn = re.sub(r"^_ZN\d+_GLOBAL__N__.*?_cu_[0-9a-f]{8}\d+", "", fn)
    return re.sub(r"EEv.*$", "E", fn)


def sass_mix(lib):
    """``({function: {class: count}}, {function: {MUFU opcode: count}})`` of
    a library's SASS (the MUFU opcodes: the special-function unit's exp2,
    log2, sin, cos, rsqrt, rcp)."""
    cuobjdump = os.path.join(os.path.dirname(wk._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out, mufu, fn = {}, {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = short_name(m.group(1))
            out[fn], mufu[fn] = {}, {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if fn and m:
            op = m.group(1)
            cls = next((c for c, rx in CLASSES if re.match(rx, op)), "other")
            out[fn][cls] = out[fn].get(cls, 0) + 1
            if op.startswith("MUFU."):
                mufu[fn][op] = mufu[fn].get(op, 0) + 1
    return out, mufu


def res_usage(lib):
    """``{function: registers}`` and ``{function: (stack, local) bytes}``
    (``cuobjdump -res-usage``; local memory holds the spills)."""
    cuobjdump = os.path.join(os.path.dirname(wk._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", str(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    regs, mem = {}, {}
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+)([^\n]*)", text):
        fn = short_name(m.group(1))
        regs[fn] = int(m.group(2))
        mem[fn] = tuple(int(x.group(1)) if x else None for x in (
            re.search(r"STACK:(\d+)", m.group(3)),
            re.search(r"LOCAL:(\d+)", m.group(3))))
    return regs, mem


def build(variants):
    """The libraries of ``variants`` by code: the checkout's, or with
    ``--ablate`` this checkout's source less the named pieces."""
    pieces = [p for p in args.ablate.split(",") if p]
    if not pieces:
        paths, _, _ = wk.build_library(variants)
        return paths
    src = HERE / "dcrmontecarlo_tpu_torch" / "csrc"
    work = HERE / "_archive" / "survey_ab" / args.tag
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, work / "csrc")
    for p in pieces:
        for name, old, new in PIECES[p]:
            text = (work / "csrc" / name).read_text()
            assert text.count(old) == 1, (p, old)
            (work / "csrc" / name).write_text(text.replace(old, new))

    def one(v):
        out = work / f"walk-{wk.variant_code(v)}.so"
        proc = subprocess.run(
            [wk._nvcc(), *wk.NVCC_FLAGS, *wk.variant_macros(v), "-o",
             str(out), str(work / "csrc" / "walk_kernel.cu")],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return wk.variant_code(v), out

    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        paths = dict(pool.map(one, variants))
    wk._library.cache_clear()
    wk._library_path = lambda v: paths[wk.variant_code(v)]
    return paths


def clone(s):
    return {k: v.clone() for k, v in s.items()}


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def plane_hash(state, params):
    from dcrmontecarlo_tpu_torch.solver.state import state_planes
    return digest(*[state[k].cpu().numpy()
                    for k in state_planes(params.n_src)])


def timed(state, params, budget, reps=3):
    """Best of ``reps`` ms (CUDA events) of one launch of ``budget`` steps
    from a copy of ``state``, and the last copy's end state."""
    best, out = None, None
    for _ in range(reps):
        out = clone(state)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wk.run_walk(out, params, budget)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        best = ms if best is None else min(best, ms)
    return best, out


def loops():
    return dict(getattr(wk.run_walk, "loop_launches", {}))


def launches(state, params, step_bound):
    """The solve's single launch from ``state`` and 256 steps there."""
    wk.run_walk(clone(state), params, step_bound)  # the library's load
    if hasattr(wk.run_walk, "loop_launches"):
        wk.run_walk.loop_launches.clear()
    ms, end = timed(state, params, step_bound)
    lp = loops()
    ms256, _ = timed(state, params, 256)
    life = end["life"]
    steps, longest = int(life.sum(dtype=torch.int64)), int(life.max())
    return dict(whole_ms=ms, whole_loops=lp, ms256=ms256, steps=steps,
                lanes=life.numel(), longest_lane=longest,
                occupancy=steps / (life.numel() * longest),
                truncated=float(end["tn"].sum()),
                planes=plane_hash(end, params))


def raw_hash(res):
    return digest(res.mean, res.stderr, res.walk_sum, res.walk_sumsq,
                  [res.total_steps, res.iterations, res.truncated_walks,
                   res.truncated_weight, res.max_weight, res.max_banked])


def survey_group():
    survey, electrodes, options = cs.survey_config(args.build)
    solver = WoStSolver(survey.build_problem(), options, device=dev)
    pts = cs.survey_points(electrodes, -0.5)
    state, params, _, bound = solver._setup(pts, *cs.SURVEY_RUN, 5)
    out = launches(state, params, bound)
    solver.solve(pts, *cs.SURVEY_RUN[:2], eps=cs.SURVEY_RUN[2], seed=0)
    times, shares, hashes, steps = [], [], [], 0.0
    for seed in (1, 2, 3):
        events = []

        def walk(st, pr, n, thr=None):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(st, pr, n, thr)
            b.record()
            events.append((a, b))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver._solve_raw(pts, *cs.SURVEY_RUN, seed, walk=walk)
        times.append(time.perf_counter() - t0)
        shares.append(sum(a.elapsed_time(b) for a, b in events) / 1e3
                      / times[-1])
        hashes.append(raw_hash(res))
        steps += res.total_steps
    out.update(s_per_solve=times, rate=steps / sum(times),
               kernel_share=shares, solve_hashes=hashes,
               kernel=params.kernel_name)
    return out


def jacobian_group():
    prob, stencil = cs.born_stencil()
    solver = WoStSolver(prob, SolverOptions(
        target_slots=1 << 16, common_random_numbers=True), device=dev)
    state, params, _, bound = solver._setup(stencil, *cs.JACOBIAN_RUN, 5)
    out = launches(state, params, bound)
    survey, elec, _, grid = cs.born_line()
    kw = dict(num_rx_per_src=4, h=1.5, n_walks=6000, max_steps=500,
              eps=0.3, options=SolverOptions(target_slots=1 << 16),
              n_batches=4, device=dev)
    survey_jacobian(survey, elec, grid, seed=5, **kw)
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jac = survey_jacobian(survey, elec, grid, seed=6, **kw)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    out.update(call_s=calls, call_hash=digest(jac.rows, jac.stderr),
               kernel=params.kernel_name)
    return out


def budgeted_group():
    """The budgeted launches of the survey's step that the dealt loop
    leaves alone: 256 steps (best of 3) of phase 6's fresh state cut into
    four shards of 36,864 lanes (the shards kernel, as phase 38 launches
    it) and of phase 40's survey with the split (the freeze build at 4),
    with their end planes' hashes."""
    import dataclasses

    survey, electrodes, options = cs.survey_config()
    pts = cs.survey_points(electrodes, -0.5)
    solver = WoStSolver(survey.build_problem(), options, device=dev)
    state, params, _, _ = solver._setup(pts, *cs.SURVEY_RUN, 5)
    lanes = state["px"].numel() // 4
    shards = dataclasses.replace(params, shard_seeds=tuple(
        params.seed + 7919 * k for k in range(4)), shard_lanes=lanes)
    out = {}
    for name, st, pr, thr in (
            ("shards", state, shards, None),
            ("split", *WoStSolver(survey.build_problem(),
                                  cs.survey_split_options(), device=dev)
             ._setup(pts, *cs.SURVEY_RUN, 5)[:2], cs.P1_SPLIT)):
        wk.run_walk(clone(st), pr, 16, thr)  # the library's load
        best, end = None, None
        for _ in range(3):
            end = clone(st)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            wk.run_walk(end, pr, 256, thr)
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
            best = ms if best is None else min(best, ms)
        out[name] = dict(ms256=best, planes=plane_hash(end, pr),
                         kernel=pr.kernel_name)
    return out


def main():
    groups = ((BUILDS[args.build], args.build, survey_group),)
    if args.build == "survey":
        groups += ((WIDE_MIS, "jacobian", jacobian_group),)
    variants = [v for v, _, _ in groups]
    t0 = time.time()
    paths = build(variants)
    record = dict(tag=args.tag, tree=tree, card=card,
                  device=torch.cuda.get_device_name(0), ablate=args.ablate,
                  build=args.build, build_s=time.time() - t0, groups={})
    for v, name, fn in groups:
        lib = paths[wk.variant_code(v)]
        rec = fn()
        assert rec["kernel"] == wk.kernel_name(v), rec["kernel"]
        regs, mem = res_usage(lib)
        mix, mufu = sass_mix(lib)
        rec.update(registers=regs, stack_local=mem, sass=mix, mufu=mufu)
        record["groups"][name] = rec
        print(args.tag, name, json.dumps({k: rec[k] for k in rec
                                          if k not in ("sass", "mufu")}),
              flush=True)
        for f, mix in rec["sass"].items():
            print(args.tag, name, "sass", f, sum(mix.values()),
                  sorted(mix.items()), sorted(rec["mufu"][f].items()),
                  flush=True)
    if args.build == "survey":
        record["groups"]["budgeted"] = rec = budgeted_group()
        print(args.tag, "budgeted", json.dumps(rec), flush=True)
    os.makedirs(HERE / "chiprun_out", exist_ok=True)
    with open(HERE / "chiprun_out" / f"survey_ab_{args.tag}.json", "w") as f:
        json.dump(record, f)
    print(args.tag, f"done ({card})", flush=True)


if __name__ == "__main__":
    main()
