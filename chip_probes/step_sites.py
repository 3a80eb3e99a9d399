#!/usr/bin/env python3
"""Where a walk step's warp-cycles go, site by site, on one card.

The one-thread-per-lane loop of ``csrc/walk_kernel.cu`` runs several
sites of ``csrc/walk_step.inc`` on some lanes only: the Robin chain's
chord mass on lanes standing on the wall, the wall-arrival weight on
lanes that hit it, the chord branch; the bank of a finished walk; MIS
next-event estimation (its star test and its mixture pdf apart), the
sources at its sample (with MIS or without), the first hit, the screened
radius and its rejection sampler's redraw rounds. This probe
copies a checkout's ``csrc/`` (``TREE``, default this one) under
``_archive/step_sites/`` and brackets each site with ``clock64()``: the
group of a warp's lanes that enters a site is timed by its slowest lane
(``__reduce_max_sync``), and its leader adds the cycles and the number of
lanes to per-site sums in device memory (one slot per warp, modulo 512).
The whole loop of each warp is timed the same way (its lifetime from the
loop's start to its reconvergence after the last lane leaves), and every
iteration adds its lanes. A site's share of warp-cycles is its cycles
over the loops'; its share of lanes is its lane entries over the
lane-iterations. The shipped source is never touched.

In a tree whose build rule sends a variant to another loop, the copy is
switched back to the one-thread loop first (``ONE_THREAD``), so a later
tree measures the same code as its parent. The builds at their full-size
states (seed 5, fresh walks):

- ``line``: ``chip_smoke.py`` phase 30's notebook pseudosection, the wide
  chain + MIS ``<1,false,true,false,false,true,false,true>``, 688,128
  lanes, 18 sources, 19 components;
- ``flagship_shard``: phase 38's sharded flagship, shard 0 of 4,
  ``<1,true,true,false,false,true,false>``, 172,032 lanes;
- ``accuracy``: phase 11's accuracy path, the chain + majorant
  ``<1,true,false,false,false,true,false>``, 688,128 lanes, 2 rejection
  rounds;
- ``varcoeff``: phase 26's variable coefficients, the chain on a
  ``TERMS`` alpha ``<1,false,false,false,false,true,false>``, 667,648
  working lanes, 64 rejection rounds;
- ``terrain``: phase 20's topographic survey, the table form
  ``<0,false,false,false,true,true,false>``, 294,912 lanes, 402 rows;
- ``terrain_flagship``: phase 41's terrain with the flagship's estimator
  ``<0,true,true,true,true,true,false>``, 294,912 lanes (its 256 steps
  without the freeze threshold: no lane freezes, and the clocked copy
  runs the one-thread loop);
- ``survey``: phase 6's main path, the survey build
  ``<0,false,false,false,false,true,false>``, 147,456 lanes;
- ``jacobian``: phase 31's Jacobian, the wide survey with MIS
  ``<0,false,true,false,false,true,false,true>``, 65,536 lanes, 8 sources,
  9 components;
- ``transport``: phase 6's state with the transport sampler
  ``<0,false,false,false,false,true,true>`` (phase 43's first solve),
  147,456 lanes;
- ``survey_mis``: phase 6's state with the survey's MIS mixture
  ``<0,false,true,false,false,true,false>`` (phase 43's second solve),
  147,456 lanes, 2 components.

The sites of the survey builds' step: HASH (the counter hash and the
step's first uniforms), CLOSEST, FIRST_HIT, RADIUS (the rejection
sampler's first round), ALPHA_S (alpha at the sample), NEE (the sources at
the sample, with screened_norm), INTERIOR (interior_prob), SIGMA (sigma'
at a colliding sample), ALPHA_H (alpha at the hit of a lane that does not
collide), BANK, and with MIS the MIS site (its PDF and STAR within) and
ADD (the sources at the MIS sample). The transport build's TRANSPORT
(the map's whole draw) holds CHEB (the 29 x 13 Chebyshev tensor and the
warp), FREE (the free density's draw) and TWEIGHT (the exact weight's
Bessel terms); its counters ZWARPS, ZFREE and ZMIXED count the warps that
draw (and their lanes), those with a lane past ``Z_SW`` (and those
lanes) and those with lanes on both sides. The survey MIS build's MIS
holds BOXMULLER (the four uniforms, the component and the Box-Muller
sample), STAR, GREENS (``screened_greens`` and ``screened_norm``) and PDF;
ALPHA_Y is alpha at the MIS sample.

Where a step's scans read the table form's rows, the sites CLOSEST (the
Dirichlet scan), SILHOUETTE, FIRST_HIT (the step's first hit) and STAR
(MIS's star test, a second first-hit scan) are those scans.

For each: 256 steps of the tree's own build (best of 3), of the
instrumented copy (best of 3; its counters from one more run), the site
table, and whether the instrumented end planes equal the tree's own.
Writes ``chiprun_out/step_sites.json``. Names after ``TREE`` pick
some of the builds.

    python3 chip_probes/step_sites.py [TREE [NAME ...]]
"""

import ctypes
import hashlib
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

from dcrmontecarlo_tpu_torch.models import drape_electrodes, \
    notebook_survey, topographic_survey_problem, varcoeff_solve_points, \
    variable_coefficient_problem  # noqa: E402
from dcrmontecarlo_tpu_torch.ops import walk_kernel as wk  # noqa: E402
from dcrmontecarlo_tpu_torch.parallel import ShardedWoStSolver, \
    make_mesh  # noqa: E402
from dcrmontecarlo_tpu_torch.solver import SolverOptions, \
    WoStSolver  # noqa: E402
from dcrmontecarlo_tpu_torch.solver.state import state_planes  # noqa
from dcrmontecarlo_tpu_torch.survey import dcr as sdcr  # noqa: E402
from dcrmontecarlo_tpu_torch.survey import survey_default_options  # noqa
import chip_smoke as cs  # noqa: E402

WORK = ROOT / "_archive" / "step_sites"
# the sites, in the order of their counters; LOOP is each warp's loop,
# ITER counts iterations (warps in the cycle sum, lanes in the lane sum)
SITES = ("LOOP", "ITER", "BANK", "CLOSEST", "CHORD_MASS", "FIRST_HIT",
         "RADIUS", "REDRAW", "MIS", "STAR", "PDF", "ADD", "NEE", "ARRIVAL",
         "BRANCH", "SILHOUETTE", "HASH", "ALPHA_S", "INTERIOR", "SIGMA",
         "ALPHA_H", "TRANSPORT", "CHEB", "FREE", "TWEIGHT", "BOXMULLER",
         "GREENS", "ALPHA_Y", "ZWARPS", "ZFREE", "ZMIXED")
# the disjoint sites of a step (REDRAW lies inside RADIUS; STAR, PDF,
# BOXMULLER and GREENS inside MIS; CHEB, FREE and TWEIGHT inside
# TRANSPORT)
TOP = ("BANK", "CLOSEST", "CHORD_MASS", "FIRST_HIT", "RADIUS", "MIS", "ADD",
       "NEE", "ARRIVAL", "BRANCH", "SILHOUETTE", "HASH", "ALPHA_S",
       "INTERIOR", "SIGMA", "ALPHA_H", "TRANSPORT", "ALPHA_Y")
# counters, not clocks: warps (in the cycle sums) and lanes
COUNTS = ("ZWARPS", "ZFREE", "ZMIXED")
SLOTS = 512

PRELUDE = r"""
// ---- site clocks (chip_probes/step_sites.py) ----
constexpr int N_SITES = %(n)d, SITE_SLOTS = %(slots)d;
%(enum)s
__device__ unsigned long long g_site_cyc[N_SITES][SITE_SLOTS];
__device__ unsigned long long g_site_lanes[N_SITES][SITE_SLOTS];
__device__ __forceinline__ unsigned site_slot() {
  return ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) & (SITE_SLOTS - 1);
}
// the group that entered with mask m took dt cycles (its slowest lane)
__device__ __forceinline__ void site_add(int s, unsigned m, long long dt) {
  const unsigned d = __reduce_max_sync(m, (unsigned)dt);
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    atomicAdd(&g_site_cyc[s][site_slot()], (unsigned long long)d);
    atomicAdd(&g_site_lanes[s][site_slot()], (unsigned long long)__popc(m));
  }
}
__device__ __forceinline__ void site_iter() {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    atomicAdd(&g_site_cyc[S_ITER][site_slot()], 1ull);
    atomicAdd(&g_site_lanes[S_ITER][site_slot()], (unsigned long long)__popc(m));
  }
}
#define SITE_BEGIN(s) const unsigned site_m_##s = __activemask(); \
  const long long site_t_##s = clock64();
#define SITE_END(s) site_add(S_##s, site_m_##s, clock64() - site_t_##s);
// the transport map's regime: warps that draw, those with a lane past Z_SW,
// those with lanes on both sides (a warp each in the cycle sums)
__device__ __forceinline__ void site_count(int s, unsigned m) {
  atomicAdd(&g_site_cyc[s][site_slot()], 1ull);
  atomicAdd(&g_site_lanes[s][site_slot()], (unsigned long long)__popc(m));
}
#define SITE_REGIME(pred) {                                        \
  const unsigned rg_a = __activemask();                           \
  const unsigned rg_b = __ballot_sync(rg_a, pred);                \
  if ((int)(threadIdx.x & 31) == __ffs(rg_a) - 1) {               \
    site_count(S_ZWARPS, rg_a);                                   \
    if (rg_b) site_count(S_ZFREE, rg_b);                          \
    if (rg_b && rg_b != rg_a) site_count(S_ZMIXED, rg_b);         \
  } }
"""

EXPORT = r"""
// the site sums: N_SITES x SITE_SLOTS cycles, then as many lane counts
extern "C" int site_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_site_cyc, sizeof g_site_cyc);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + N_SITES * SITE_SLOTS, g_site_lanes,
                                   sizeof g_site_lanes);
}
extern "C" int site_reset() {
  static unsigned long long zero[N_SITES][SITE_SLOTS];
  cudaError_t e = cudaMemcpyToSymbol(g_site_cyc, zero, sizeof zero);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_site_lanes, zero, sizeof zero);
}
"""

# (file, anchor, replacement): each anchor occurs exactly once
STEP_EDITS = (
    ("    const uint32_t ctr =\n",
     "    site_iter();\n    SITE_BEGIN(HASH)\n    const uint32_t ctr =\n"),
    ("    const float u4 = DELTA ? uni(base, sid, 4) : F(0.0);\n",
     "    const float u4 = DELTA ? uni(base, sid, 4) : F(0.0);\n"
     "    SITE_END(HASH)\n"),
    ("      const float a_s = alpha_c<TERMS>(sx, sy);\n",
     "      SITE_BEGIN(ALPHA_S)\n"
     "      const float a_s = alpha_c<TERMS>(sx, sy);\n"
     "      SITE_END(ALPHA_S)\n"),
    ("      const bool interior = u4 < interior_prob(r, sbar);\n",
     "      SITE_BEGIN(INTERIOR)\n"
     "      const bool interior = u4 < interior_prob(r, sbar);\n"
     "      SITE_END(INTERIOR)\n"),
    ("        const float scale_int =\n"
     "            sqrtf(a_s / a_p) * (F(1.0) - sigma_prime<TERMS>(sx, sy) / "
     "sbar);\n",
     "        SITE_BEGIN(SIGMA)\n        const float scale_int =\n"
     "            sqrtf(a_s / a_p) * (F(1.0) - sigma_prime<TERMS>(sx, sy) / "
     "sbar);\n        SITE_END(SIGMA)\n"),
    ("        const float a_h = alpha_c<TERMS>(hx, hy);\n",
     "        SITE_BEGIN(ALPHA_H)\n"
     "        const float a_h = alpha_c<TERMS>(hx, hy);\n"
     "        SITE_END(ALPHA_H)\n"),
    ("    const float dD = closest_point<TABLE>(px, py, cx, cy);\n",
     "    SITE_BEGIN(CLOSEST)\n"
     "    const float dD = closest_point<TABLE>(px, py, cx, cy);\n"
     "    SITE_END(CLOSEST)\n"),
    ("    if (done_eps || steps >= max_steps) {\n",
     "    if (done_eps || steps >= max_steps) {\n      SITE_BEGIN(BANK)\n"),
    ("      a_cur = a_p0;\n      WALK_NEXT;\n",
     "      a_cur = a_p0;\n      SITE_END(BANK)\n      WALK_NEXT;\n"),
    ("      if (ob) {\n        float glx0, gly0;\n",
     "      if (ob) {\n        SITE_BEGIN(CHORD_MASS)\n"
     "        float glx0, gly0;\n"),
    ("          atten = atten / (F(1.0) - c_ch);\n        }\n      }\n",
     "          atten = atten / (F(1.0) - c_ch);\n        }\n"
     "        SITE_END(CHORD_MASS)\n      }\n"),
    ("      const float t_best =\n"
     "          first_hit<TABLE>(px, py, dx, dy, tmw, %(lim)sfnx, fny, hxs, "
     "hys);\n",
     "      SITE_BEGIN(FIRST_HIT)\n      const float t_best =\n"
     "          first_hit<TABLE>(px, py, dx, dy, tmw, %(lim)sfnx, fny, hxs, "
     "hys);\n      SITE_END(FIRST_HIT)\n"),
    ("    float r = fmaxf(rmin, C.n_vert > 0\n"
     "                              ? fminf(dD, silhouette<TABLE>(px, py))\n"
     "                              : dD);\n",
     "    SITE_BEGIN(SILHOUETTE)\n"
     "    float r = fmaxf(rmin, C.n_vert > 0\n"
     "                              ? fminf(dD, silhouette<TABLE>(px, py))\n"
     "                              : dD);\n    SITE_END(SILHOUETTE)\n"),
    ("        r_s = screened_radius(r, sbar, seed, ctr, sid, C.rounds, "
     "w_rej);\n",
     "      {\n        SITE_BEGIN(RADIUS)\n"
     "        r_s = screened_radius(r, sbar, seed, ctr, sid, C.rounds, "
     "w_rej);\n        SITE_END(RADIUS)\n      }\n"),
    ("        float w_mis = mis_nee<true, TABLE, WIDE>(\n"
     "            base, sid, px, py, px + r_s * dx, py + r_s * dy, r, sbar, "
     "ob,\n            t_min, yx, yy);\n",
     "        SITE_BEGIN(MIS)\n        float w_mis = mis_nee<true, TABLE, "
     "WIDE>(\n            base, sid, px, py, px + r_s * dx, py + r_s * dy, "
     "r, sbar, ob,\n            t_min, yx, yy);\n        SITE_END(MIS)\n"),
    ("        add_sources<TERMS, WIDE>(acc, lane, n_src, yx, yy, w_mis);\n"
     "      }\n",
     "        SITE_BEGIN(ADD)\n"
     "        add_sources<TERMS, WIDE>(acc, lane, n_src, yx, yy, w_mis);\n"
     "        SITE_END(ADD)\n      }\n"),
    ("          const float w_src =\n"
     "              screened_norm(r, sbar) / sqrtf(a_s * a_p) * atten;\n"
     "          add_sources<TERMS, WIDE>(acc, lane, n_src, sx, sy, w_src);\n",
     "          SITE_BEGIN(NEE)\n          const float w_src =\n"
     "              screened_norm(r, sbar) / sqrtf(a_s * a_p) * atten;\n"
     "          add_sources<TERMS, WIDE>(acc, lane, n_src, sx, sy, w_src);\n"
     "          SITE_END(NEE)\n"),
    ("      if constexpr (TRANSPORT)\n"
     "        r_s = transport_radius(r, sbar, seed, ctr, sid, w_rej);\n",
     "      if constexpr (TRANSPORT) {\n        SITE_BEGIN(TRANSPORT)\n"
     "        r_s = transport_radius(r, sbar, seed, ctr, sid, w_rej);\n"
     "        SITE_END(TRANSPORT)\n      }\n"),
    ("        const float a_y = alpha_c<TERMS>(yx, yy);\n",
     "        SITE_BEGIN(ALPHA_Y)\n"
     "        const float a_y = alpha_c<TERMS>(yx, yy);\n"
     "        SITE_END(ALPHA_Y)\n"),
    ("          if (hit) {\n            // Robin wall-arrival weight",
     "          if (hit) {\n            SITE_BEGIN(ARRIVAL)\n"
     "            // Robin wall-arrival weight"),
    ("            scale_edge = scale_edge * (F(1.0) + gamma * rho / cosphi);"
     "\n",
     "            scale_edge = scale_edge * (F(1.0) + gamma * rho / cosphi);"
     "\n            SITE_END(ARRIVAL)\n"),
    ("          if (branch) {\n",
     "          if (branch) {\n            SITE_BEGIN(BRANCH)\n"),
    ("            new_ob = true;\n          } else if (q_c > F(1e-6)) {\n",
     "            new_ob = true;\n            SITE_END(BRANCH)\n"
     "          } else if (q_c > F(1e-6)) {\n"),
)
KERNEL_EDITS = (
    ("// ---- screened-radius rejection",
     "%PRELUDE%\n// ---- screened-radius rejection"),
    ("  for (int i = 1; i < rounds && !acc; ++i) {\n"
     "    candidate(q, seed, ctr, sid, (uint32_t)(i + 1), x, s, ua);\n"
     "    A = accept_prob(q, x, s);\n"
     "    bool is_final = i >= rounds - 1;\n"
     "    if (ua < A || is_final) {\n"
     "      s_cur = s;\n"
     "      w_r = is_final ? A / a_rate : F(1.0);\n"
     "      acc = true;\n"
     "    }\n"
     "  }\n",
     "  if (rounds > 1 && !acc) {  // the lanes that rejected round 0\n"
     "  SITE_BEGIN(REDRAW)\n"
     "  for (int i = 1; i < rounds && !acc; ++i) {\n"
     "    candidate(q, seed, ctr, sid, (uint32_t)(i + 1), x, s, ua);\n"
     "    A = accept_prob(q, x, s);\n"
     "    bool is_final = i >= rounds - 1;\n"
     "    if (ua < A || is_final) {\n"
     "      s_cur = s;\n"
     "      w_r = is_final ? A / a_rate : F(1.0);\n"
     "      acc = true;\n"
     "    }\n"
     "  }\n"
     "  SITE_END(REDRAW)\n  }\n"),
    ("  if (C.n_neu > 0)  // a wall between x and y blocks the sample\n"
     "    in_star = in_ball &&\n"
     "              !(first_hit_t<TABLE>(px, py, ex / d_safe, ey / d_safe,\n"
     "                                   ob ? t_min : F(0.0)) < d_y);\n",
     "  if (C.n_neu > 0) {  // a wall between x and y blocks the sample\n"
     "    SITE_BEGIN(STAR)\n"
     "    in_star = in_ball &&\n"
     "              !(first_hit_t<TABLE>(px, py, ex / d_safe, ey / d_safe,\n"
     "                                   ob ? t_min : F(0.0)) < d_y);\n"
     "    SITE_END(STAR)\n  }\n"),
    ("  const float u5 = uni(base, sid, 5), u6 = uni(base, sid, 6);\n",
     "  SITE_BEGIN(BOXMULLER)\n"
     "  const float u5 = uni(base, sid, 5), u6 = uni(base, sid, 6);\n"),
    ("  my = my + mw * rad * sinf(ang);\n",
     "  my = my + mw * rad * sinf(ang);\n  SITE_END(BOXMULLER)\n"),
    (("    g_val = fmaxf(screened_greens(d_safe, r, sbar), F(0.0));\n"
      "    norm = screened_norm(r, sbar);\n",
      "    g_val = fmaxf(screened_greens(d_safe, r, sbar), F(0.0));\n"
      "    norm = DEALT ? norm_in : screened_norm(r, sbar);\n"),
     ("    SITE_BEGIN(GREENS)\n"
      "    g_val = fmaxf(screened_greens(d_safe, r, sbar), F(0.0));\n"
      "    norm = screened_norm(r, sbar);\n    SITE_END(GREENS)\n",
      "    SITE_BEGIN(GREENS)\n"
      "    g_val = fmaxf(screened_greens(d_safe, r, sbar), F(0.0));\n"
      "    norm = DEALT ? norm_in : screened_norm(r, sbar);\n"
      "    SITE_END(GREENS)\n")),
    ("  // the map at z_eff = clip(z, Z_LO, Z_SW)\n",
     "  SITE_BEGIN(CHEB)\n  // the map at z_eff = clip(z, Z_LO, Z_SW)\n"),
    ("  const float mp = F(2.0) * v * (F(1.0) - v) / (w1 * w1);\n",
     "  const float mp = F(2.0) * v * (F(1.0) - v) / (w1 * w1);\n"
     "  SITE_END(CHEB)\n"),
    ("  // the free density's exact draw (z > Z_SW)\n",
     "  SITE_BEGIN(FREE)\n  // the free density's exact draw (z > Z_SW)\n"),
    ("  const bool use_f = z > F(Z_SW);\n",
     "  const bool use_f = z > F(Z_SW);\n  SITE_END(FREE)\n"
     "  SITE_REGIME(use_f)\n"),
    ("  // the exact importance weight\n",
     "  SITE_BEGIN(TWEIGHT)\n  // the exact importance weight\n"),
    ("  w = invalid ? F(0.0) : (use_f ? w_f : w_t);\n",
     "  w = invalid ? F(0.0) : (use_f ? w_f : w_t);\n  SITE_END(TWEIGHT)\n"),
    ("  float q = F(0.0);  // the mixture pdf, one expf per component\n",
     "  SITE_BEGIN(PDF)\n"
     "  float q = F(0.0);  // the mixture pdf, one expf per component\n"),
    ("  // an on-boundary walker samples a hemisphere: double its density\n",
     "  SITE_END(PDF)\n"
     "  // an on-boundary walker samples a hemisphere: double its density\n"),
    ("    for (int it = 0; it < budget && quota > 0; ++it) {\n",
     "    SITE_BEGIN(LOOP)\n"
     "    for (int it = 0; it < budget && quota > 0; ++it) {\n"),
    ("#undef WALK_FROZEN\n    }\n\n    P.px[lane] = px;\n",
     "#undef WALK_FROZEN\n    }\n    __syncwarp(site_m_LOOP);\n"
     "    SITE_END(LOOP)\n\n    P.px[lane] = px;\n"),
)
# the clocked copy runs every build in the one-thread loop, the freeze
# builds too (the anchors that exist are replaced, each once; a frozen
# lane leaves the loop as it leaves the repack loop's)
ONE_THREAD = (
    ("__launch_bounds__(repacked(ROBIN, MIS, FREEZE)\n"
     "                                      ? REPACK_THREADS\n"
     "                                      : THREADS)",
     "__launch_bounds__(FREEZE ? REPACK_THREADS : THREADS)"),
    ("  if constexpr (repacked(ROBIN, MIS, FREEZE)) {",
     "  if constexpr (false) {"),
    ("constexpr bool REPACKED = repacked(WALK_ROBIN, WALK_MIS != 0, "
     "WALK_FREEZE != 0);", "constexpr bool REPACKED = false;"),
    ("__launch_bounds__(repacked(ROBIN, MIS, FREEZE, TABLE,\n"
     "                                           TERMS_FORM)\n"
     "                                      ? REPACK_THREADS\n"
     "                                      : THREADS)",
     "__launch_bounds__(FREEZE ? REPACK_THREADS : THREADS)"),
    ("  if constexpr (repacked(ROBIN, MIS, FREEZE, TABLE, TERMS_FORM)) {",
     "  if constexpr (false) {"),
    ("constexpr bool REPACKED = repacked(WALK_ROBIN, WALK_MIS != 0,\n"
     "                                   WALK_FREEZE != 0, WALK_TABLE != 0,\n"
     "                                   WALK_TERMS != 0);",
     "constexpr bool REPACKED = false;"),
)
# the step's first-hit call, before and after it took its limit (the
# culled scan's): a tree has one of the two spellings
SPELLINGS = (dict(lim=""), dict(lim="r, "))
# old fork text (the freeze builds kept the repack loop) in trees that
# already wrote FREEZE there
_FREEZE_FORK = (("  if constexpr (FREEZE) {\n    walk_repacked",
                 "  if constexpr (false) {\n    walk_repacked"),
                ("constexpr bool REPACKED = WALK_FREEZE != 0;",
                 "constexpr bool REPACKED = false;"))


def _edit(text, edits, what):
    for old, new in edits:
        if isinstance(old, tuple):  # the spelling this tree has
            found = [(o, n) for o, n in zip(old, new) if text.count(o) == 1]
            assert len(found) == 1, (what, old)
            old, new = found[0]
        if "%(" in old:  # the spelling this tree has
            found = [(old % sp, new % sp) for sp in SPELLINGS
                     if text.count(old % sp) == 1]
            assert len(found) == 1, (what, old)
            old, new = found[0]
        n = text.count(old)
        assert n == 1, (what, n, old)
        text = text.replace(old, new)
    return text


def instrumented_source(csrc, dst):
    """A copy of ``csrc`` under ``dst`` with the site clocks in the
    one-thread loop; returns ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    step = _edit((dst / "walk_step.inc").read_text(), STEP_EDITS,
                 "walk_step.inc")
    (dst / "walk_step.inc").write_text(step)
    src = (dst / "walk_kernel.cu").read_text()
    for old, new in ONE_THREAD + _FREEZE_FORK:
        if old in src:
            src = _edit(src, ((old, new),), "one-thread fork")
    src = _edit(src, KERNEL_EDITS, "walk_kernel.cu")
    enum = "enum {" + ", ".join(f"S_{s}" for s in SITES) + "};"
    src = src.replace("%PRELUDE%", PRELUDE % dict(
        n=len(SITES), slots=SLOTS, enum=enum)) + EXPORT
    (dst / "walk_kernel.cu").write_text(src)
    return dst


def build(tag, csrc, variant):
    """``(library path, ptxas report)`` of ``variant`` from ``csrc``."""
    out = WORK / f"{tag}-{wk.variant_code(variant)}.so"
    cmd = [wk._nvcc(), *wk.NVCC_FLAGS, *wk.variant_macros(variant), "-o",
           str(out), str(csrc / "walk_kernel.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{proc.stdout}{proc.stderr}")
    report = " | ".join(line.strip() for line in
                        (proc.stdout + proc.stderr).splitlines()
                        if "registers" in line or "spill" in line)
    return out, report


def use(paths):
    """Make ``wk.run_walk`` launch the libraries ``paths`` (by code)."""
    wk._library.cache_clear()
    wk._library_path = lambda v: paths[wk.variant_code(v)]


def survey_state(dev, build="survey"):
    """Phase 6's full-size state of the main path (the survey build,
    147,456 lanes, seed 5), or with ``build`` (``chip_smoke.py::
    survey_config``) the transport sampler's or the MIS mixture's."""
    survey, electrodes, options = cs.survey_config(build)
    solver = WoStSolver(survey.build_problem(), options, device=dev)
    return solver._setup(cs.survey_points(electrodes, -0.5), *cs.SURVEY_RUN,
                         5)[:2]


def jacobian_state(dev):
    """Phase 31's state of the Jacobian's wide survey with MIS (the
    stencil of the Born demo's grid, 1,500 walks a batch, 65,536 lanes,
    seed 5)."""
    prob, stencil = cs.born_stencil()
    solver = WoStSolver(prob, SolverOptions(
        target_slots=1 << 16, common_random_numbers=True), device=dev)
    return solver._setup(stencil, *cs.JACOBIAN_RUN, 5)[:2]


def groups(dev, names=()):
    """``name: (state, params)``: the builds' full-size states (those of
    ``names``, or all)."""
    out = {}
    if not names or "survey" in names:
        out["survey"] = survey_state(dev)
    if not names or "jacobian" in names:
        out["jacobian"] = jacobian_state(dev)
    for name, build in (("transport", "transport"), ("survey_mis", "mis")):
        if not names or name in names:
            out[name] = survey_state(dev, build)
    if names and not set(names) - {"survey", "jacobian", "transport",
                                   "survey_mis"}:
        return out
    line_survey, line_elec = notebook_survey()
    line_survey.source_mis = True
    line_prob, line_pts, _, _ = sdcr._line_problem(line_survey, line_elec, 8)
    line = WoStSolver(line_prob, SolverOptions(
        target_slots=1 << 21, min_quota=32, common_random_numbers=True),
        device=dev)
    state, params, _, _ = line._setup(line_pts, 1 << 20, 6000, 1.0, 5)
    out["line"] = (state, params)
    flag_survey, nb_elec = notebook_survey()
    flag_survey.local_majorant = "auto"
    flag_survey.source_mis = True
    sharded = ShardedWoStSolver(
        flag_survey.build_problem(), make_mesh(4, device=dev),
        survey_default_options(target_slots=1 << 21, min_quota=32,
                               split_threshold=4.0))
    nb_pts = np.asarray(nb_elec, np.float32)
    shard = sharded._shard(sharded._plan(nb_pts, 1 << 20, 6000, 1.0, 5), 0)
    out["flagship_shard"] = (shard.state, shard.params)
    acc_survey, _ = notebook_survey()
    acc_survey.local_majorant = "auto"
    accuracy = acc_survey.make_solver(survey_default_options(
        target_slots=1 << 21, min_quota=32), device=dev)
    out["accuracy"] = accuracy._setup(nb_pts, 1 << 20, 6000, 1.0, 5)[:2]
    varcoeff = WoStSolver(variable_coefficient_problem(), SolverOptions(
        target_slots=1 << 21, max_attenuation=50.0), device=dev)
    out["varcoeff"] = varcoeff._setup(varcoeff_solve_points(), 4096, 500,
                                      1e-3, 5)[:2]
    topo, height = topographic_survey_problem()
    topo_pts = drape_electrodes(height, cs.TOPO_XS, nudge=0.5)
    out["terrain"] = WoStSolver(topo, SolverOptions(
        target_slots=1 << 21), device=dev)._setup(
        topo_pts, cs.P2_WALKS, cs.P2_MAX_STEPS, cs.P2_EPS, 5)[:2]
    flagship, _ = cs.terrain_flagship_problem()
    out["terrain_flagship"] = WoStSolver(flagship, survey_default_options(
        target_slots=1 << 21, split_threshold=cs.P2_SPLIT), device=dev
    )._setup(topo_pts, cs.P2_WALKS, cs.P2_MAX_STEPS, cs.P2_EPS, 5)[:2]
    return out


def run256(state, params, reps=3):
    """``(best ms of reps, end planes' hash, end state)`` of 256 steps."""
    def once():
        s = {k: v.clone() for k, v in state.items()}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        wk.run_walk(s, params, 256)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), s
    once()
    ms, end = min((once() for _ in range(reps)), key=lambda r: r[0])
    return ms, hashlib.sha256(b"".join(
        end[k].cpu().numpy().tobytes()
        for k in state_planes(params.n_src))).hexdigest()[:16], end


def site_table(lib, state, params):
    """One 256-step run of an instrumented library: per site its cycles,
    lane entries, share of the loops' warp-cycles and of lane-iterations."""
    lib.site_read.argtypes = [ctypes.c_void_p]
    torch.cuda.synchronize()
    assert lib.site_reset() == 0
    s = {k: v.clone() for k, v in state.items()}
    wk.run_walk(s, params, 256)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * len(SITES) * SLOTS))()
    assert lib.site_read(buf) == 0
    a = np.frombuffer(buf, np.uint64).astype(np.float64).reshape(
        2, len(SITES), SLOTS).sum(2)
    cyc, lanes = dict(zip(SITES, a[0])), dict(zip(SITES, a[1]))
    loop, iters = cyc["LOOP"], lanes["ITER"]
    table = {k: dict(cycles=cyc[k], lanes=lanes[k],
                     cycle_share=cyc[k] / loop, lane_share=lanes[k] / iters)
             for k in SITES if k not in ("LOOP", "ITER") + COUNTS}
    table["other"] = dict(cycles=loop - sum(cyc[k] for k in TOP),
                          cycle_share=1.0 - sum(cyc[k] for k in TOP) / loop)
    out = dict(loop_cycles=loop, warp_iterations=cyc["ITER"],
               lane_iterations=iters, sites=table)
    if cyc["ZWARPS"]:  # the transport map's regime, by warp and by lane
        out["regime"] = dict(
            warps=cyc["ZWARPS"], lanes=lanes["ZWARPS"],
            free_warp_share=cyc["ZFREE"] / cyc["ZWARPS"],
            mixed_warp_share=cyc["ZMIXED"] / cyc["ZWARPS"],
            free_lane_share=lanes["ZFREE"] / lanes["ZWARPS"],
            free_lanes_in_mixed_warps=lanes["ZMIXED"])
    return out


def site_shares(path, state, params):
    """``site_table`` of the instrumented library at ``path`` (built for
    ``params``' variant), launched through ``wk.run_walk``; the libraries
    ``wk`` has loaded stay loaded, and launch again afterwards."""
    saved_path, saved_library = wk._library_path, wk._library
    wk._library_path = lambda v: path
    try:
        lib = saved_library.__wrapped__(wk._canonical(params.variant))
        wk._library = lambda v: lib
        return site_table(lib, state, params)
    finally:
        wk._library_path, wk._library = saved_path, saved_library


def main():
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    names = sys.argv[2:]
    dev = torch.device("cuda", 0)
    card = subprocess.run(cs.NVSMI_QUERY, capture_output=True,
                          text=True).stdout.strip()
    WORK.mkdir(parents=True, exist_ok=True)
    csrc = tree / "dcrmontecarlo_tpu_torch" / "csrc"
    sources = {"own": csrc,
               "sites": instrumented_source(csrc, WORK / "csrc_sites")}
    made = {k: v for k, v in groups(dev, names).items()
            if k in names or not names}
    variants = {p.variant for _, p in made.values()}
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = {(tag, v): pool.submit(build, tag, src, v)
                for tag, src in sources.items() for v in variants}
        built = {k: f.result() for k, f in jobs.items()}
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s "
          f"({card})", flush=True)
    for (tag, v), (_, report) in sorted(built.items(), key=str):
        print(tag, wk.kernel_name(v), report, flush=True)

    record = dict(card=card, device=torch.cuda.get_device_name(0),
                  tree=str(tree), groups={})
    for name, (state, params) in made.items():
        runs = {}
        for tag in ("own", "sites", "sites", "own"):
            use({wk.variant_code(v): built[(tag, v)][0] for v in variants})
            ms, h, _ = run256(state, params)
            runs.setdefault(tag, []).append((ms, h))
        use({wk.variant_code(v): built[("sites", v)][0] for v in variants})
        table = site_table(wk._library(wk._canonical(params.variant)),
                           state, params)
        equal = len({h for r in runs.values() for _, h in r}) == 1
        rec = dict(kernel=params.kernel_name, lanes=state["px"].numel(),
                   ms={k: [m for m, _ in v] for k, v in runs.items()},
                   equal=equal, **table)
        record["groups"][name] = rec
        print(f"{name} ({params.kernel_name}, {rec['lanes']} lanes): 256 "
              f"steps ms own {rec['ms']['own']}, instrumented "
              f"{rec['ms']['sites']}; end planes "
              f"{'equal' if equal else 'DIFFER'}; {table['lane_iterations']:.0f} "
              f"lane-iterations in {table['warp_iterations']:.0f} "
              f"warp-iterations ({card})", flush=True)
        for k, v in table["sites"].items():
            print(f"  {k:10s} warp-cycles {v['cycle_share']:.4f}"
                  + (f", lanes {v['lane_share']:.4f}" if "lanes" in v
                     else ""), flush=True)
        if "regime" in table:
            print(f"  regime {json.dumps(table['regime'])}", flush=True)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "step_sites.json", "w") as f:
        json.dump(record, f)


if __name__ == "__main__":
    main()
