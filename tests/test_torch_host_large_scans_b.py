"""The large-table build's records, rule and folds, on the CPU.

The culled table variant's large-table build (``walk_kernel.large_scans``,
``csrc/walk_variant.h::large_scans``) reads the silhouette's chunk and
group records (``walk_kernel.silhouette_records``: the box of a chunk's
a, b and c points, the box of its b points, the oriented cone of its
edges) and the first hit's group records (``walk_kernel.chunk_records``
over a group's rows). Here: every vertex of a record lies in its boxes
and every edge's direction in its cone, on the 5 cm DEM, the comb and a
terrain that folds back over itself (overhangs, whose chunks' edges turn
past the cone's bound: their cone skips nothing); whole launches on the
folded terrain are equal in the large-table build as shipped, with full
scans and in the culled build, on every lane and plane, and the probe of
``test_torch_host_large_scans.py`` holds the shipped scans to the full
ones there. The rule that picks the build is the same in the header and
in Python on every kernel variant at table sizes either side of
``LARGE_TABLE_ROWS``; the host asks for the build by the table's size
only, builds it only for the culled variant, and a unit of another
variant with ``WALK_LARGE`` does not compile.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.geometry import Polyline
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from host_cuda.host_walk import load, start_build
from test_torch_host_culled_scans import SURVEY
from test_torch_host_large_scans import PROBE, _probe, adversarial, hold
from test_torch_host_large_table import _comb

torch.set_num_threads(1)


def _folded():
    """Rolling hills at 1/16 m over [-64, 64] with a Z-shaped overhang
    every 3 m (the wall runs 0.3 m on, 0.4 m back and on again, each leg
    above the last): 2,558 Neumann segments."""
    pts = []
    for k, x in enumerate(np.arange(-64.0, 64.0 + 1e-9, 1.0 / 16)):
        y = 2.0 * np.sin(2 * np.pi * x / 40.0)
        pts.append([x, y])
        if k % 48 == 24:
            pts += [[x + 0.3, y + 0.05], [x - 0.1, y + 0.1],
                    [x + 0.5, y + 0.15]]
    pts = np.asarray(pts, np.float32)
    box = [[-64.0, float(pts[0, 1])], [-64.0, -40.0], [64.0, -40.0],
           [64.0, float(pts[-1, 1])]]
    return Problem(
        dirichlet=Polyline.from_points(box), neumann=Polyline.from_points(pts),
        bc_dirichlet=fields.constant(0.0),
        source=fields.gaussian_dipole((-20.0, -3.0), (20.0, -3.0), 1.0, 0.5),
        alpha=fields.constant(1e2))


def _params(prob, pts, lanes=256):
    solver = WoStSolver(prob, SolverOptions(target_slots=lanes,
                                            pallas_block_rows=2),
                        device="cpu")
    state, params, _, _ = solver._setup(pts, lanes, 600, 0.5, 3)
    return state, params


def _dem():
    prob, h = topographic_survey_problem(resolution=0.05)
    return _params(prob, drape_electrodes(h, np.arange(-40.0, 41.0, 10.0),
                                          nudge=0.5))[1]


def _hold_records(params, rows):
    """Every vertex row's points lie in its record's box, its b point in
    the b box, and each nonzero float32 edge's unit direction within g of
    m, for records of ``rows`` rows; returns the records."""
    vt = params.vert_table
    rec = wk.silhouette_records(vt, rows)
    assert rec.dtype == np.float32 and rec.shape == (-(-len(vt) // rows), 12)
    for c, r in enumerate(rec):
        chunk = vt[c * rows:(c + 1) * rows]
        pts = chunk.reshape(-1, 2)
        assert (pts[:, 0] >= r[0]).all() and (pts[:, 0] <= r[2]).all()
        assert (pts[:, 1] >= r[1]).all() and (pts[:, 1] <= r[3]).all()
        b = chunk[:, 2:4]
        assert (b[:, 0] >= r[4]).all() and (b[:, 0] <= r[6]).all()
        assert (b[:, 1] >= r[5]).all() and (b[:, 1] <= r[7]).all()
        assert r[11] == 0.0
        if r[10] >= 2.0:  # no bound: the cone skips nothing
            continue
        e = np.concatenate([chunk[:, 2:4] - chunk[:, 0:2],
                            chunk[:, 4:6] - chunk[:, 2:4]]).astype(np.float64)
        n = np.hypot(e[:, 0], e[:, 1])
        u = e[n > 0] / n[n > 0, None]
        assert (np.hypot(*(u - r[8:10].astype(np.float64)).T)
                <= float(r[10])).all(), c
    return rec


def test_records_hold_their_rows():
    folded = _params(_folded(), np.array([[0.0, -5.0]], np.float32))[1]
    comb = _params(_comb(), np.array([[0.0, -5.0]], np.float32))[1]
    dem = _dem()
    group = wk.SIL_ROWS * wk.GROUP_CHUNKS
    for params in (folded, comb, dem):
        for rows in (wk.SIL_ROWS, group):
            _hold_records(params, rows)
        # the first hit's group records are its chunk records over a
        # group's rows, after its chunk records in one buffer
        n_ch = -(-len(params.neu_table) // wk.CHUNK_ROWS)
        n_sc = -(-len(params.vert_table) // wk.SIL_ROWS)
        recs = wk.large_records(params.neu_table, params.vert_table)
        assert len(recs) == (8 * (n_ch + -(-n_ch // wk.GROUP_CHUNKS))
                             + 12 * (n_sc + -(-n_sc // wk.GROUP_CHUNKS)))
        np.testing.assert_array_equal(
            recs[8 * n_ch:8 * (n_ch + -(-n_ch // wk.GROUP_CHUNKS))],
            wk.chunk_records(params.neu_table,
                             wk.CHUNK_ROWS * wk.GROUP_CHUNKS).reshape(-1))
    # the smooth DEM's chunks have tight cones, the comb's right angles
    # and the overhangs none
    g_dem = wk.silhouette_records(dem.vert_table)[:, 10]
    assert (g_dem < 0.05).all()
    assert (wk.silhouette_records(comb.vert_table)[:, 10] == 4.0).all()
    g_fold = wk.silhouette_records(folded.vert_table)[:, 10]
    assert (g_fold == 4.0).sum() >= 40 and (g_fold < 0.1).mean() > 0.5


@pytest.fixture(scope="module")
def folded_builds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("large_scans_b")
    started = dict(
        large=start_build(tmp, SURVEY, False, False, PROBE, large=True),
        full=start_build(tmp, SURVEY, False, True, PROBE, large=True),
        culled=start_build(tmp, SURVEY, False))
    return {k: load(b, SURVEY) for k, b in started.items()}


def test_folded_terrain_launch_and_probe(folded_builds):
    xs = np.arange(-40.0, 41.0, 10.0)
    pts = np.stack([xs, 2.0 * np.sin(2 * np.pi * xs / 40.0) - 0.7], 1)
    state, params = _params(_folded(), pts.astype(np.float32))
    assert params.variant == SURVEY and params.large
    wk.walk_plain(state, params, 24)
    out = {k: cs.clone_state(state) for k in folded_builds}
    for k, walk in folded_builds.items():
        walk(out[k], params, 48, float("inf"))
    for k in state_planes(params.n_src):
        assert torch.equal(out["large"][k], out["full"][k]), k
        assert torch.equal(out["large"][k], out["culled"][k]), k
    assert int((out["large"]["life"] - state["life"]).sum()) > 0
    lanes = adversarial(params, np.random.default_rng(23))
    ref = _probe(folded_builds["full"], params, state, lanes)
    hold(_probe(folded_builds["large"], params, state, lanes), ref,
         lanes[:, 5], "folded")


_RULE_MAIN = r"""
#include <cstdio>
#include "walk_variant.h"
int main() {
  int v[12];
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d %d %d", v, v + 1, v + 2,
                    v + 3, v + 4, v + 5, v + 6, v + 7, v + 8, v + 9, v + 10,
                    v + 11) == 12)
    std::printf("%d\n", (int)walk_rules::large_scans(
        v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10],
        v[11]));
}
"""


def test_large_rule_of_header_and_python_agree(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "rule.cpp").write_text(_RULE_MAIN)
    exe = tmp_path / "rule"
    subprocess.run([cxx, "-std=c++17", "-I", str(wk._SRC.parent), "-o",
                    str(exe), str(tmp_path / "rule.cpp")], check=True,
                   timeout=120)
    t = wk.LARGE_TABLE_ROWS
    sizes = [(0, 0), (t - 1, t - 2), (t, t - 1), (t - 1, t), (200, 199),
             (8000, 7999), (t, 0)]
    cases = [(v, n, m) for v in sorted(wk._switches(u)
                                       for u in wk.KERNEL_VARIANTS)
             for n, m in sizes]
    out = subprocess.run([str(exe)], input="".join(
        " ".join(str(int(x)) for x in v[:10]) + f" {n} {m}\n"
        for v, n, m in cases), check=True, capture_output=True, text=True,
        timeout=60).stdout
    got = [bool(int(x)) for x in out.split()]
    assert got == [wk.large_scans(v, n, m) for v, n, m in cases]
    assert {(v, n, m) for (v, n, m), g in zip(cases, got) if g} == {
        (SURVEY + (False, False), n, m) for n, m in sizes
        if max(n, m) >= t}


def test_host_asks_for_the_build_by_size_and_builds_it_for_the_culled_only(
        tmp_path, monkeypatch):
    prob, h = topographic_survey_problem()            # phases 16 and 20
    pts = drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), nudge=0.5)
    small = _params(prob, pts)[1]
    assert small.variant == SURVEY and not small.large
    assert small.build_name == small.kernel_name
    np.testing.assert_array_equal(small.chunk_table("cpu").numpy(),
                                  wk.chunk_records(small.neu_table))
    big = _dem()
    assert big.large and big.kernel_name == small.kernel_name
    assert big.build_name == small.kernel_name + " (large)"
    # its own library, named by its own code; the macro only where set
    assert wk.build_code(SURVEY, True) == wk.variant_code(SURVEY) + 4096
    assert wk._library_path(SURVEY, True) != wk._library_path(SURVEY)
    assert "-DWALK_LARGE=1" in wk.nvcc_command(SURVEY, "/tmp/o.so", True)
    assert not any("LARGE" in c for c in wk.nvcc_command(SURVEY, "/tmp/o"))
    chain = (wk.ROBIN_CHAIN,) + SURVEY[1:]
    with pytest.raises(ValueError, match="large-table build is the culled"):
        wk.build_library([], large=[chain])
    # no fallback: a failed build of it raises with the compiler's log
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card toolchain here'\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(wk, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(wk, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"(?s)\(large\).*no card"):
        wk.build_library([], large=[SURVEY])


def test_a_large_build_of_another_variant_does_not_compile(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    here = wk._SRC.parents[2] / "tests" / "host_cuda"
    chain = (wk.ROBIN_CHAIN,) + SURVEY[1:]
    proc = subprocess.run(
        [cxx, "-std=c++17", "-fsyntax-only", "-x", "c++", "-I", str(here),
         "-I", str(wk._SRC.parent), *wk.variant_macros(chain, True),
         str(wk._SRC)], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "the large-table scans are the culled table build's" in \
        proc.stderr
