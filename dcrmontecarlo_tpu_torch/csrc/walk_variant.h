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
// at its path's size; the terrain flagship, the table chain, the table
// without delta tracking and the sweep's table builds ran slower and
// keep the full scans (PERF.md, section 6)
WALK_HD constexpr bool culled_scans(int robin, bool maj, bool mis,
                                    bool freeze, bool table, bool delta,
                                    bool transport, bool wide, bool grid,
                                    bool terms_form) {
  return robin == ROBIN_OFF && !maj && !mis && !freeze && table && delta &&
         !transport && !wide && !grid && !terms_form;
}

// the variants that deal walks, not lanes, to their threads in a launch
// that drains every quota from fresh walks (csrc/walk_kernel.cu,
// walk_dealt; ops/walk_kernel.py::dealt holds the same rule): the survey's
// build (phase 6, the main path), the wide survey with MIS (phase 31's
// Jacobian), and the survey's build with the transport sampler or with MIS
// (phase 43). Their other launches run one thread a lane; the wide survey
// without MIS, the wide transport builds and transport with MIS stay on
// their own loops (ROADMAP.md, Queue 2)
WALK_HD constexpr bool dealt(int robin, bool maj, bool mis, bool freeze,
                             bool table, bool delta, bool transport,
                             bool wide, bool grid, bool terms_form) {
  return robin == ROBIN_OFF && !maj && !freeze && !table && delta &&
         !grid && !terms_form && (mis || !wide) &&
         !(transport && (mis || wide));
}

}  // namespace walk_rules

#endif  // WALK_VARIANT_H
