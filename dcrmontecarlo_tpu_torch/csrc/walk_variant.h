// The walk kernel's switch rules (csrc/walk_kernel.cu), apart from CUDA so
// that a host compiler can hold them against ops/walk_kernel.py.
//
// A variant is walk_kernel<ROBIN, MAJ, MIS, FREEZE, TABLE, DELTA,
// TRANSPORT, WIDE, GRID, TERMS_FORM>. The TPU kernel
// (dcrmontecarlo_tpu/ops/pallas_walk.py::make_pallas_walk) traces any
// combination of its switches, with one rule: the Robin correction, the
// local majorant, the freeze and the transport sampler act only with delta
// tracking (pallas_walk.py:611, :1100, :1120; solver/wost.py:1780 builds
// the freeze only then). Every other combination is a valid variant: 400
// of the 3 x 2^8 switch tuples.
//
// TERMS fields (problems/fields.py::Terms) are compiled into the variants
// whose paths evaluate them (terms_fields: those of the analytic-check
// problems); a variant outside that set evaluates them only in its TERMS
// form (TERMS_FORM), a library of its own, so that the kind's call sites
// (27% per step on the accuracy path) never reach a variant that launches
// no TERMS field.

#ifndef WALK_VARIANT_H
#define WALK_VARIANT_H

#ifdef __CUDACC__
#define WALK_HD __host__ __device__
#else
#define WALK_HD
#endif

namespace walk_rules {

constexpr int ROBIN_OFF = 0, ROBIN_CHAIN = 1, ROBIN_REFLECT = 2;

// the variants that evaluate TERMS fields without their TERMS form: no
// majorant, freeze or reflectance, MIS and the table form only without
// delta tracking (ops/walk_kernel.py::terms_fields holds the same rule)
WALK_HD constexpr bool terms_fields(int robin, bool maj, bool mis,
                                    bool freeze, bool table, bool delta) {
  return !maj && !(mis && delta) && !freeze && !(table && delta) &&
         robin != ROBIN_REFLECT;
}

// the reference's rule, and a TERMS form only where the variant lacks the
// kind; MIS, the table form, the wide form and the grid combine freely
// (ops/walk_kernel.py::valid_variant holds the same rule)
WALK_HD constexpr bool valid_variant(int robin, bool maj, bool mis,
                                     bool freeze, bool table, bool delta,
                                     bool transport, bool terms_form) {
  return robin >= ROBIN_OFF && robin <= ROBIN_REFLECT &&
         (delta || (robin == ROBIN_OFF && !maj && !freeze && !transport)) &&
         !(terms_form && terms_fields(robin, maj, mis, freeze, table, delta));
}

// the variants whose Robin chain runs its wall work in full warps: the
// chain without the freeze (the chain implies delta tracking), with MIS in
// every form (the sharded flagship, the notebook line, their table, TERMS,
// grid and transport forms), without MIS except in the table form and the
// TERMS forms (the accuracy path, the variable coefficients, their
// transport, grid and wide forms; the table form and the TERMS form
// without MIS ran slower in the repack loop at the 8,192 lanes their
// paths launch: PERF.md, section 6). They step in the repack loop, and their
// chord mass, wall-arrival weight and chord branch go through a queue in
// the block's shared memory (csrc/walk_kernel.cu, walk_step_chain;
// ops/walk_kernel.py::chain_phases holds the same rule)
WALK_HD constexpr bool chain_phases(int robin, bool mis, bool freeze,
                                    bool table, bool terms_form) {
  return robin == ROBIN_CHAIN && !freeze && (mis || !(table || terms_form));
}

// the variants that run the repack loop (walk_repacked): the freeze
// builds and chain_phases'; the others run one thread a lane
WALK_HD constexpr bool repacked(int robin, bool mis, bool freeze,
                                bool table, bool terms_form) {
  return freeze || chain_phases(robin, mis, freeze, table, terms_form);
}

// the table-form variant whose first-hit scan skips the chunks of rows
// that cannot change its result (csrc/walk_kernel.cu, chunk_skips;
// ops/walk_kernel.py::culled_scans holds the same rule): the survey's on
// the terrain (phase 20), the one such build that ran faster on the card
// at its path's size; the terrain flagship, the table without delta
// tracking and the sweep's table builds ran slower and keep the full
// scans, and so does the table chain: its culled first hit lost at 8,192
// lanes on 102 rows (6.21-6.33 -> 6.71 ms) and, at phase 48's
// 294,912 lanes on 402 rows, gained 3.8% alone but lost 2-3% beside its
// culled chord frame (culled_chord; PERF.md, section 6). The table form
// without delta tracking culls its closest point instead (culled_closest:
// phase 47's single launch 24.8-25.2 -> 11.6-11.7 ms on the card)
WALK_HD constexpr bool culled_scans(int robin, bool maj, bool mis,
                                    bool freeze, bool table, bool delta,
                                    bool transport, bool wide, bool grid,
                                    bool terms_form) {
  return robin == ROBIN_OFF && !maj && !mis && !freeze && table && delta &&
         !transport && !wide && !grid && !terms_form;
}

// the table-form variant without delta tracking (phase 47's Poisson
// bubble: a walk whose every step is a closest point over the Dirichlet
// rows and a jump to the ball's edge), whose closest point runs the
// Dirichlet rows by chunks of CHUNK_ROWS from the chunk of the least box
// distance outward and skips a chunk whose box proves no row of it can win
// (csrc/walk_kernel.cu, closest_point_culled; ops/walk_kernel.py::
// culled_closest holds the same rule); its first hit keeps the full scan,
// and every other build its closest point. The walk's start taken from a
// closest point found once a launch bought nothing at phase 47's size
// (PERF.md, section 6)
WALK_HD constexpr bool culled_closest(int robin, bool maj, bool mis,
                                      bool freeze, bool table, bool delta,
                                      bool transport, bool wide, bool grid,
                                      bool terms_form) {
  return robin == ROBIN_OFF && !maj && !mis && !freeze && table && !delta &&
         !transport && !wide && !grid && !terms_form;
}

// the table chain (phase 48's terrain over shallow bodies: the Robin
// chain on the table form, one thread a lane), whose chord frame runs the
// Neumann rows by chunks of CHUNK_ROWS from the chunk of the least box
// distance outward and skips a chunk whose box proves no row of it can win
// (csrc/walk_kernel.cu, chord_frame_culled, WALK_CHORD;
// ops/walk_kernel.py::culled_chord holds the same rule): phase 48's single
// launch 1023 -> 854-860 ms on the card. Its first hit keeps the full scan
// (culled_scans), and every other build its chord frame
WALK_HD constexpr bool culled_chord(int robin, bool maj, bool mis,
                                    bool freeze, bool table, bool delta,
                                    bool transport, bool wide, bool grid,
                                    bool terms_form) {
  return robin == ROBIN_CHAIN && !maj && !mis && !freeze && table && delta &&
         !transport && !wide && !grid && !terms_form;
}

// the twelfth switch, a build of the culled_scans variant (WALK_LARGE, not
// a template switch, so that the variant's name and the other builds stay
// as they were): its silhouette scan culls chunks and groups of vertex
// rows by box distance and oriented cone, and its first hit skips groups
// of chunks, so that a step reads a few of the rows and records of a large
// boundary; below LARGE_TABLE_ROWS Neumann and vertex rows the culled
// build's own scans ran faster (PERF.md, section 6), so the host asks for
// this build only from there on (csrc/walk_kernel.cu, silhouette_large,
// group_skips; ops/walk_kernel.py::large_scans holds the same rule)
constexpr int LARGE_TABLE_ROWS = 1000;

WALK_HD constexpr bool large_scans(int robin, bool maj, bool mis, bool freeze,
                                   bool table, bool delta, bool transport,
                                   bool wide, bool grid, bool terms_form,
                                   int n_neu, int n_vert) {
  return culled_scans(robin, maj, mis, freeze, table, delta, transport, wide,
                      grid, terms_form) &&
         (n_neu >= LARGE_TABLE_ROWS || n_vert >= LARGE_TABLE_ROWS);
}

// the variants that deal walks, not lanes, to their threads in a launch
// that drains every quota from fresh walks (csrc/walk_kernel.cu,
// walk_dealt; ops/walk_kernel.py::dealt holds the same rule): the survey's
// build (phase 6, the main path), the wide survey with MIS (phase 31's
// Jacobian) and without (phase 44's scenario pseudosection), and the
// survey's build with the transport sampler or with MIS (phase 43). Their
// other launches run one thread a lane; the wide transport builds and
// transport with MIS stay on their own loops (ROADMAP.md, Queue 2), and so
// do the builds without delta tracking: the short walk's static form ran
// slower dealt at phase 25's size (PERF.md, section 6), and so did its
// one-thread loop with a lane that drains its quota banking and stepping
// in one iteration (one_sincos)
WALK_HD constexpr bool dealt(int robin, bool maj, bool mis, bool freeze,
                             bool table, bool delta, bool transport,
                             bool wide, bool grid, bool terms_form) {
  return robin == ROBIN_OFF && !maj && !freeze && !table && delta &&
         !grid && !terms_form && !(transport && (mis || wide));
}

// the static form without delta tracking (phase 25's short walk, ~10
// steps a walk; with MIS phase 49's narrow source), whose one-thread loop
// takes the step's direction, and with MIS its Box-Muller pair, from one
// sincosf each, the bits of cosf and sinf on [0, 2 pi] (chip_probes/
// sincos_bits.py; csrc/walk_kernel.cu, WALK_SINCOS; ops/walk_kernel.py::
// one_sincos holds the same rule). It keeps one thread a lane: dealt walks
// (PR 16), a bank and the next walk's first step in one iteration of a lane
// whose budget covers its quota (+13%, at 70 registers) and 12 blocks a SM
// (40 registers, 160 B spilled) each ran its single launch slower on the
// card (PERF.md, section 6); every other build keeps cosf and sinf
WALK_HD constexpr bool one_sincos(int robin, bool maj, bool mis, bool freeze,
                                  bool table, bool delta, bool transport,
                                  bool wide, bool grid, bool terms_form) {
  return robin == ROBIN_OFF && !maj && !freeze && !table && !delta &&
         !transport && !wide && !grid && !terms_form;
}

}  // namespace walk_rules

#endif  // WALK_VARIANT_H
