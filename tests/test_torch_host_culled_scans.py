"""The table form's culled first hit, run on the CPU, bit for bit.

``csrc/walk_kernel.cu``'s ``culled_scans`` build (the survey's table form,
``<0,false,false,false,true,true,false>``) cuts the Neumann rows into
chunks with a box each and skips a chunk that cannot change the first
hit within the star radius (``chunk_skips``). Here the host compiler
builds it twice (``tests/host_cuda/host_walk.py``): as shipped, and with
the skip test replaced by ``false`` (``FULL_SCANS``: every chunk in row
order, the full scan). Whole launches of the two are equal on every lane
and plane on the terrain's 402 rows, the terrain with rows of zero length,
a staircase terrain of 100 rows and ``chip_smoke.py`` phase 16's 100-row
square (no Neumann row, so no chunk); the staircase and the square,
whose walls the CPU's math libraries cross alike, also follow
``walk_plain`` by
``compare_planes`` (on the sloped terrain the two libraries'
transcendentals desynchronize walks within a few wall visits,
``test_torch_silhouette.py``; ``chip_smoke.py`` holds it on the card,
where the kernel and the plain walk share one). A probe of the scans on
chosen lanes holds the shipped first hit to the full one: points on the
chunk boxes' edges and corners and on the rows' endpoints, rays along rows
and boxes' edges, and limits equal to a row's distance and one float
either side. The rule that picks the build is the same in the header and
in Python on all 1,152 kernel variants.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dcrmontecarlo_tpu_torch.geometry import Polyline, circle_loop
from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    topographic_survey_problem
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk
from dcrmontecarlo_tpu_torch.problems import Problem, fields
from dcrmontecarlo_tpu_torch.solver import SolverOptions, WoStSolver
from dcrmontecarlo_tpu_torch.solver.state import state_planes
from dcrmontecarlo_tpu_torch.survey import survey_default_options
from host_cuda.host_walk import load, start_build

torch.set_num_threads(1)

_F, _T = False, True
SURVEY = (0, _F, _F, _F, _T, _T, _F, _F, _F)

# the scans on chosen lanes: in[n x 6] (px, py, dx, dy, tmw, lim); out[n
# x 9]: dD, cx, cy, min(dD, silhouette), the first hit's t within lim,
# its normal and hit point
PROBE = r"""
extern "C" int walk_scan_probe(int n, const float* in, float* out) {
  for (int lane = 0; lane < n; ++lane) {
    const float* q = in + 6 * lane;
    float* o = out + 9 * lane;
    float cx, cy;
    const float dD = closest_point<true>(q[0], q[1], cx, cy);
    o[0] = dD, o[1] = cx, o[2] = cy;
    o[3] = C.n_vert > 0 ? fminf(dD, silhouette<true>(q[0], q[1])) : dD;
    float fnx = 0.0f, fny = 0.0f, hxs = 0.0f, hys = 0.0f, t = 3e38f;
    if (C.n_neu > 0)
      t = first_hit<true>(q[0], q[1], q[2], q[3], q[4], q[5], fnx, fny, hxs,
                          hys);
    o[4] = t, o[5] = fnx, o[6] = fny, o[7] = hxs, o[8] = hys;
  }
  return 0;
}
"""


def _terrain():
    prob, h = topographic_survey_problem()
    return prob, drape_electrodes(h, np.arange(-40.0, 41.0, 10.0), nudge=0.5)


def _staircase():
    """A terrain of 4 m steps every 8 m (axis-aligned walls, integer
    corners: hit points lie exactly on their walls), 100 rows."""
    pts = [[-100.0, 0.0]]
    x = -100.0
    while x < 100.0:
        x = min(x + 8.0, 100.0)
        pts.append([x, pts[-1][1]])
        if x < 100.0:
            pts.append([x, 4.0 - pts[-1][1]])
    pts = np.array(pts, np.float32)
    box = [[-100.0, float(pts[0, 1])], [-100.0, -150.0], [100.0, -150.0],
           [100.0, float(pts[-1, 1])]]
    return Problem(
        dirichlet=Polyline.from_points(box), neumann=Polyline.from_points(pts),
        bc_dirichlet=fields.constant(0.0),
        source=fields.gaussian_dipole((-20.0, -1.5), (20.0, -1.5), 1.0, 0.5),
        alpha=fields.constant(1e2))


def _square():
    """``chip_smoke.py`` phase 16's square: its right edge the table's last
    three rows, Dirichlet rows only."""
    sq = []
    for (a, b, n, first) in (((1, 1), (-1, 1), 32, True),
                             ((-1, 1), (-1, -1), 32, False),
                             ((-1, -1), (1, -1), 33, False),
                             ((1, -1), (1, 1), 3, False)):
        for k in range(0 if first else 1, n + 1):
            sq.append([a[0] + k / n * (b[0] - a[0]),
                       a[1] + k / n * (b[1] - a[1])])
    return Problem(dirichlet=Polyline.from_points(sq),
                   bc_dirichlet=fields.constant(1.0),
                   alpha=fields.constant(1.0))


def _zero_rows(params):
    """The terrain's Neumann rows with a row of zero length after every
    fifth (the vertices as they were)."""
    neu = params.neu_table
    rows = []
    for i, r in enumerate(neu):
        rows.append(r)
        if i % 5 == 2:
            rows.append(np.array([r[2], r[3], r[2], r[3]], np.float32))
    return dataclasses.replace(params, neu_table=np.asarray(rows, np.float32))


def _case(name):
    """``(variant, state, params)``: 1,024 lanes of a geometry, 24 plain
    steps into their walks."""
    if name in ("terrain", "zero_rows"):
        prob, pts = _terrain()
        args = (pts, 1024, 600, 0.5, 3)
    elif name == "square":
        prob = _square()
        args = (np.array([[0.0, 0.0], [0.9, -0.95]], np.float32), 1024, 60,
                1e-3, 0)
    else:
        prob = _staircase()
        args = (np.stack([np.arange(-40.0, 41.0, 10.0), np.full(9, -0.7)],
                         1).astype(np.float32), 1024, 600, 0.5, 3)
    solver = WoStSolver(prob, SolverOptions(target_slots=1024), device="cpu")
    state, params, _, _ = solver._setup(*args)
    if name == "zero_rows":
        params = _zero_rows(params)
    state = {k: v[:8].clone() for k, v in state.items()}  # 1,024 lanes
    wk.walk_plain(state, params, 24)
    return params.variant, state, params


CASES = ("terrain", "zero_rows", "staircase")
LAUNCHES = CASES + ("square",)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """``{full: walk}``: the shipped and the full-scan host builds of the
    culled variant, compiled at once."""
    tmp = tmp_path_factory.mktemp("culled")
    started = {full: start_build(tmp, SURVEY, False, full, PROBE)
               for full in (False, True)}
    return {k: load(b, SURVEY) for k, b in started.items()}


@pytest.mark.parametrize("name", LAUNCHES)
def test_culled_launch_equals_full_scans_and_follows_plain(builds, name):
    variant, state, params = _case(name)
    assert variant == SURVEY and params.table and wk.culled_scans(variant)
    culled, full, plain = (cs.clone_state(state) for _ in range(3))
    builds[False](culled, params, 48, float("inf"))
    builds[True](full, params, 48, float("inf"))
    for k in state_planes(params.n_src):
        assert torch.equal(culled[k], full[k]), k
    assert int((culled["life"] - state["life"]).sum()) > 0
    if name in ("staircase", "square"):
        wk.walk_plain(plain, params, 48)
        frac, _, finite = wk.compare_planes(culled, plain,
                                            state_planes(params.n_src))
        assert finite and min(frac.values()) >= wk.PLANE_MIN_FRAC, frac


def _probe(walk, params, state, lanes):
    """The probe on ``lanes`` (n x 6 float32) after a zero-step launch on
    ``state`` has written ``params`` to the library's constant block."""
    walk(cs.clone_state(state), params, 0, float("inf"))
    lanes = np.ascontiguousarray(lanes, np.float32)
    out = np.zeros((len(lanes), 9), np.float32)
    walk.lib.walk_scan_probe.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]
    assert walk.lib.walk_scan_probe(len(lanes), lanes.ctypes.data,
                                    out.ctypes.data) == 0
    return out


def _adversarial(params, rng):
    """Lanes (px, py, dx, dy, tmw, lim) on the chunk boxes' corners and
    edges and the rows' endpoints, with rays along rows, along boxes'
    edges and at random, and random lanes near the terrain."""
    rec = wk.chunk_records(params.neu_table)
    pts = [rec[:, [0, 1]], rec[:, [2, 3]], rec[:, [0, 3]], rec[:, [2, 1]],
           0.5 * (rec[:, [0, 1]] + rec[:, [2, 1]]),
           params.neu_table[::3, :2], params.neu_table[1::3, 2:4]]
    pts = np.concatenate(pts).astype(np.float32)
    lanes = []
    u = params.neu_table[:, 2:4] - params.neu_table[:, :2]
    ul = np.maximum(np.hypot(u[:, 0], u[:, 1]), 1e-30)[:, None]
    along = (u / ul).astype(np.float32)
    for k, p in enumerate(pts):
        ang = rng.uniform(0, 2 * np.pi)
        ds = [(np.cos(ang), np.sin(ang)), tuple(along[k % len(along)]),
              tuple(-along[(3 * k) % len(along)])]
        for d in ds:
            lanes.append((p[0], p[1], d[0], d[1],
                          params.t_min if k % 3 == 0 else 0.0, 3e38))
    # rays from just off a row, along it (grazing, nearly parallel)
    for k in range(0, len(along), 2):
        a = params.neu_table[k, :2]
        for off in (1e-3, 1e-6, 0.0):
            lanes.append((a[0] - 3 * along[k, 0], a[1] - 3 * along[k, 1]
                          + off, along[k, 0], along[k, 1], 0.0, 3e38))
    x = rng.uniform(-60, 60, 400)
    y = rng.uniform(-30, 5, 400)
    ang = rng.uniform(0, 2 * np.pi, 400)
    for i in range(400):
        lanes.append((x[i], y[i], np.cos(ang[i]), np.sin(ang[i]), 0.0,
                      rng.uniform(0.5, 80)))
    return np.asarray(lanes, np.float32)


def _hold(got, ref, lims, what):
    """The shipped scans' results on lanes against the full scans':
    closest point and star radius equal; the first hit equal where the
    full one lies within the limit, past it otherwise."""
    for k in range(4):
        assert np.array_equal(got[:, k], ref[:, k]), (what, k)
    hit = ref[:, 4] <= lims
    assert np.array_equal(got[hit, 4:], ref[hit, 4:]), what
    assert (got[~hit, 4] > lims[~hit]).all(), what


@pytest.mark.parametrize("name", CASES)
def test_scans_on_adversarial_lanes(builds, name):
    _, state, params = _case(name)
    shipped, full = builds[False], builds[True]
    rng = np.random.default_rng(5)
    lanes = _adversarial(params, rng)
    ref = _probe(full, params, state, lanes)
    _hold(_probe(shipped, params, state, lanes), ref, lanes[:, 5], name)
    # limits at a row's distance, and one float either side
    t = ref[:, 4]
    hits = t < 1e30
    assert hits.sum() > 100
    for lim in (t, np.nextafter(t, np.float32(0)),
                np.nextafter(t, np.float32(np.inf))):
        sub = lanes[hits].copy()
        sub[:, 5] = lim[hits]
        _hold(_probe(shipped, params, state, sub),
              _probe(full, params, state, sub), sub[:, 5],
              f"{name}: limit at t")


_RULE_MAIN = r"""
#include <cstdio>
#include "walk_variant.h"
int main() {
  int v[10];
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d", v, v + 1, v + 2, v + 3,
                    v + 4, v + 5, v + 6, v + 7, v + 8, v + 9) == 10)
    std::printf("%d\n", (int)walk_rules::culled_scans(
        v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9]));
}
"""


def test_culled_rule_of_header_and_python_agree(tmp_path):
    # the one culled variant is the same in walk_variant.h (compiled by
    # the host compiler) and in ops/walk_kernel.py on every kernel variant
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "rule.cpp").write_text(_RULE_MAIN)
    exe = tmp_path / "rule"
    subprocess.run([cxx, "-std=c++17", "-I", str(wk._SRC.parent), "-o",
                    str(exe), str(tmp_path / "rule.cpp")], check=True,
                   timeout=120)
    variants = sorted(wk._switches(v) for v in wk.KERNEL_VARIANTS)
    # (the general rows switch, last, takes no part in the rule)
    out = subprocess.run([str(exe)], input="".join(
        " ".join(str(int(x)) for x in v[:10]) + "\n" for v in variants),
        check=True, capture_output=True, text=True, timeout=60).stdout
    got = [bool(int(x)) for x in out.split()]
    assert got == [wk.culled_scans(v) for v in variants]
    assert [v for v, c in zip(variants, got) if c] == [
        SURVEY + (False, False)]
