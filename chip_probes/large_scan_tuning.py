#!/usr/bin/env python3
"""The large-table build's scans taken apart and retuned, on one card.

Each case copies this checkout under ``_archive/tune_NAME`` with one edit
of ``csrc/walk_kernel.cu`` (and of ``ops/walk_kernel.py`` where a record
layout changes), runs ``large_table_ab.py`` on the copy (phase 45's
solves, 256 steps, the sharded check, phases 20 and 16) and prints its
times, registers and spills beside the checkout's own, with whether every
hash equals the checkout's:

- ``no_hit_groups``: the first hit without its group records;
- ``no_sil_groups``: the silhouette without its group records;
- ``no_far``: ``group_skips`` without its distance test;
- ``rows16``, ``rows32``: silhouette chunks of 16 and 32 vertex rows;
- ``rows16_group4``: chunks of 16 rows in groups of 4 (64 rows, as now);
- ``group4``, ``group16``: groups of 4 and 16 chunks;
- ``bounds7``: launch bounds of 7 blocks a SM (at most 72 registers).

    python3 chip_probes/large_scan_tuning.py [NAME ...]

writes ``chiprun_out/large_table_ab_t_NAME.json`` for each case and
``chiprun_out/large_table_ab_t_shipped.json`` for the checkout.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
CU = "dcrmontecarlo_tpu_torch/csrc/walk_kernel.cu"
PY = "dcrmontecarlo_tpu_torch/ops/walk_kernel.py"

def _layout(rows=None, group=None):
    """Edits of the record layout: vertex rows a silhouette chunk, chunks
    a group (in the kernel and in ``ops/walk_kernel.py`` alike)."""
    out = []
    if rows:
        out += [(CU, "constexpr int SIL_ROWS = 8,",
                 f"constexpr int SIL_ROWS = {rows},"),
                (PY, "SIL_ROWS = 8 ", f"SIL_ROWS = {rows} ")]
    if group:
        out += [(CU, "GROUP_CHUNKS = 8;", f"GROUP_CHUNKS = {group};"),
                (PY, "GROUP_CHUNKS = 8 ", f"GROUP_CHUNKS = {group} ")]
    return out


CASES = {
    "no_hit_groups": [(CU, (
        "      if (chunk_skips(group_skips(__ldg(gr), __ldg(gr + 1), px, py,"
        " dx, dy,\n                                  tmw, lim)))"),
        "      if (false)")],
    "no_sil_groups": [(CU, (
        "    if (chunk_skips(sil_skips(__ldg(gr), __ldg(gr + 1), "
        "__ldg(gr + 2), px, py,\n                              best)))"),
        "    if (false)")],
    "no_far": [(CU, "  if (hit_skips(b, c, px, py, dx, dy, tmw, lim)) "
                    "return true;\n",
                "  return hit_skips(b, c, px, py, dx, dy, tmw, lim);\n")],
    "rows16": _layout(rows=16),
    "rows32": _layout(rows=32),
    "rows16_group4": _layout(rows=16, group=4),
    "group4": _layout(group=4),
    "group16": _layout(group=16),
    "bounds7": [(CU, "                                      : THREADS)\n"
                     "walk_kernel(",
                 "                                      : THREADS, 7)\n"
                 "walk_kernel(")],
}


def copy(name, edits):
    tree = os.path.join(ROOT, "_archive", f"tune_{name}")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
        ".git", "_archive", "chiprun_out", "_build", "__pycache__"))
    for rel, old, new in edits:
        path = os.path.join(tree, rel)
        text = open(path).read()
        assert text.count(old) == 1, (name, rel, old)
        open(path, "w").write(text.replace(old, new))
    return tree


def main(names):
    runs = {"shipped": ROOT}
    for name in names or CASES:
        runs[name] = copy(name, CASES[name])
    for name, tree in runs.items():
        subprocess.run([sys.executable, os.path.join(ROOT, "chip_probes",
                                                     "large_table_ab.py"),
                        tree, f"t_{name}"], check=True, cwd=ROOT)
    res = {n: json.load(open(os.path.join(OUT, f"large_table_ab_t_{n}.json")))
           for n in runs}
    ref = res["shipped"]["items"]
    for name, r in res.items():
        it = r["items"]
        same = all(json.dumps(it[k].get("hash")) == json.dumps(
            ref[k].get("hash")) for k in ref)
        regs = r["ptxas"].get("large", {})
        print(f"{name:14s} p45 s {[round(v, 4) for v in it['p45']['s']]} "
              f"kernel ms {[round(v, 1) for v in it['p45']['kernel_ms']]} "
              f"256 steps {it['p45_256']['ms']} ms; p20 "
              f"{it['p20_256']['ms']} ms; large build {regs}; every hash "
              f"{'equal' if same else 'DIFFERS'} ({r['card']})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
