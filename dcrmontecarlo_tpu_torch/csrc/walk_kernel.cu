// Fused Walk-on-Stars walk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel dcrmontecarlo_tpu/ops/pallas_walk.py ::
// make_pallas_walk (its `kernel` step body and the `pl.pallas_call` in
// `launch`), in the variants the DCR surveys run: delta tracking, a
// Neumann wall without silhouette vertices, source next-event estimation
// (NEE), the exact screened-radius rejection with its importance-weighted
// final round, low-weight roulette, common random numbers and
// boundary-snap starts; the notebook survey's accuracy path on top: the
// Robin correction (the chord chain, pallas_walk.py:820-850, 1016-1099,
// with the chord frame _chord_frame_unrolled, or the reflectance fold) and
// the two-level local majorant (:807-818); and the flagship notebook
// gate's path: MIS next-event estimation (:564-576, :932-997), the
// in-launch freeze for the high-weight split (freeze_split, :502-516,
// :793-799, :1183-1203, :1285-1291) and the max_attenuation clip
// (:1100-1103).
//
// The topographic survey adds silhouette vertices (the star radius stops
// at the nearest one, _silhouette_unrolled / _silhouette_smem) and the
// large-geometry table form (_closest_point_smem, _first_hit_smem,
// _silhouette_smem, _chord_frame_smem, pallas_walk.py:271-421).
//
// The analytic-check problems (the Laplace, Poisson and manufactured
// models) add walks without delta tracking (no alpha, no sigma: the walker
// jumps to the ball's edge or its Neumann hit, and a source is sampled at
// the Green's radius R sqrt(u2 u3) with the weight R^2 / 4;
// pallas_walk.py:626-629, :906-909, :920-931, :1104-1106, :1146-1163),
// the transport sampler of the screened radius (screened_sampler=
// "transport", :898-900 -> sampling/radial.py:64-177: a Chebyshev map
// from the table in __constant__ memory, which every thread reads at the
// same entry, so the loads broadcast) and the TERMS field kind of their
// coefficients (polynomial x exponential x sin/cos terms, in __noinline__
// functions, compiled only into the instantiations that run those
// problems, terms_fields: the kind's mere call sites made the accuracy
// path's instantiation measurably slower per step on the card).
//
// The survey products (the dipole-dipole pseudosection, the E-field, the
// sensitivity maps and the survey Jacobian) add MIS next-event estimation
// without delta tracking (the ball's Green's function ln(R/r) / (2 pi) and
// its norm R^2 / 4 in the balance heuristic, no alpha factor;
// pallas_walk.py:956-961) and the wide form (WIDE): the TPU kernel unrolls
// its planes, NEE and banking over any number of sources (:663-677, :929,
// :995) and its mixture pick and pdf over any number of components
// (:941-945, :974-977). Here the wide form holds up to MAX_WIDE_SRC
// sources and up to MAX_WIDE_MIX mixture components, all after the older
// WalkConst fields. Its sources from MAX_SRC on are 6-float dipole rows
// (the only kind the products make), or in the general rows build
// (WALK_ROWS, a library of its own that a launch asks for when one of
// those sources is not a dipole) WideRow records of any kind the header's
// fields take but the grid: a constant, a bump sum, a dipole or a TERMS
// field, evaluated by field_value's own text (row_value), so that the
// dipole-only builds keep their code and their constant copy; there a
// source, header or row, that the host marks as one Gaussian pole
// (K_POLE) is evaluated from a compact record (pole_value), bit for bit
// the TERMS text's value (the pole-pole line's nine poles spent ~40% of
// the step in that text, chip_probes/step_sites.py). It
// loops over its sources at run time, so a row's kind is the same in
// every thread of a warp (a uniform branch over the constant bank), and
// adds every NEE term and every finished walk to the source's planes in
// global memory, in place (a read and a write per source and step, a few
// percent of the card's memory rate at these step rates), which keeps its
// registers near the narrow form's. A narrow instantiation (up to MAX_SRC
// sources and MAX_MIX components) is compiled as before.
//
// The validation path (the cylinder-series oracle's Monte Carlo tier) adds
// a gridded Dirichlet field (GRID): the bilinear interpolant of a float32
// node table, diagnostics/martingale.py::grid_continuation, which the TPU
// kernel would trace as a jnp closure (a 257 x 257 table is too large for
// __constant__ memory). The table lives in global memory and is read
// through the read-only path (__ldg) only when a lane banks a walk on the
// Dirichlet wall: four loads per finished walk, not per step. Only the
// instantiation that runs it reads the kind (the flagship's switches); its
// pointer follows every older WalkConst field, and a narrow launch copies
// it apart from the narrow block.
//
// Variants are compile-time: walk_kernel<ROBIN, MAJ, MIS, FREEZE, TABLE,
// DELTA, TRANSPORT, WIDE, GRID, TERMS_FORM>. Every combination the TPU
// kernel traces is one (walk_variant.h: Robin, the majorant, the freeze
// and the transport sampler need delta tracking; 400 variants, and the
// TERMS forms of the 368 that lack the kind), and each of the 384 wide
// ones has its general rows build (WALK_ROWS, not a template switch: the
// row code is compiled only there). A library holds exactly one of them:
// its switches come as -D macros (WALK_ROBIN, WALK_MAJORANT, WALK_MIS,
// WALK_FREEZE, WALK_TABLE, WALK_DELTA, WALK_TRANSPORT, WALK_WIDE,
// WALK_GRID, WALK_TERMS, WALK_ROWS; ops/walk_kernel.py::nvcc_command), and
// the host builds the library of a variant the first time a launch needs
// it.
// walk_kernel<ROBIN_OFF, false, false, false, false, true, false> carries
// none of the other variants' code or registers. max_attenuation is a
// run-time switch (three selects per step) in every instantiation with
// delta tracking.
//
// Geometry forms (TABLE), chosen on the host by the TPU kernel's rule
// (boundary segments plus interior vertices <= 96: static). The static
// form reads __constant__ tables whose edge vectors, normals and
// silhouette edges were formed on the host in float64 and rounded once,
// and its first hit multiplies by 1/den, as the TPU kernel's register
// unroll does. The table form reads float32 endpoint rows (any count
// its int fields hold; the JAX package's Pallas kernel stops at the 8,192
// its SMEM holds) from global memory and forms edges, normals and chord
// tangents per step in float32, dividing in the first hit, as the TPU
// kernel's SMEM loops do; the two arithmetics differ by an ulp, which
// desynchronizes walks, so each form copies its reference. A row's normal
// or chord tangent (a sqrt and two divides) is formed only when the row
// wins. The table loops dominated the step on the topographic survey
// (~200 first-hit and ~199 silhouette rows a step: FP32 and divide
// throughput, not bytes), so the culled_scans build (the survey's table
// form) runs its first hit over chunks of CHUNK_ROWS rows with a box per
// chunk and skips the chunks that cannot change its result (chunk_skips,
// below): the rows it visits run the full scan's arithmetic in row order,
// so the result is the full scan's bit for bit. The lanes of a warp visit
// the union of their chunks; the row loads are read-only L1 broadcasts
// where the lanes visit the same chunk. A boundary without vertices never
// enters the silhouette loop.
//
// Design: one iteration of a lane's loop (bank and recycle a finished
// walk, or take one step) is walk_step.inc, included by both loops below.
// A lane's planes move once per launch, so the ~23 planes x 4 B are read
// and written once; the work is bound by FP32 and SFU throughput per step
// (Bessel polynomials, sqrt/log/exp/sin/cos, the segment scans), not by
// memory.
//
// Which loop a build runs is a build-time rule (walk_variant.h::repacked,
// ops/walk_kernel.py::repacked): the freeze builds and the chain builds
// without the freeze (chain_phases) run the repack loop, every other
// build one thread per lane.
//
// - One thread per lane for the whole launch,
//   `for (i < budget && quota > 0)`. A lane whose quota drains exits on
//   its own; that is exact, because a step of a lane without quota
//   changes nothing (the TPU kernel's per-block exit relies on the same
//   fact). Threads of a warp whose quota drained idle while the rest of
//   the warp walks on. On the accuracy path the chord mass (a
//   Bessel-integral series per shrink round) runs only on lanes standing
//   on the wall, and the chord branch's extra work (frame scan, three
//   field evaluations, a screened Green's function) only on lanes that
//   take the branch, a few percent of wall visits.
// - With the freeze (the host loop's split): walk_repacked. The freeze
//   stops most lanes within a few steps of a launch while a few walk on,
//   so with one thread per lane ~70% of the thread-slots a warp issued
//   went to idle threads (chip_probes/flagship_launch_anatomy.py). Here a
//   lane's state is a Lane struct, and blocks of REPACK_THREADS threads
//   take lanes from a launch-wide pool (one atomic per block and refill)
//   in lane order. A lane is live until the one-thread loop would have
//   left it: its quota drains, it has taken `budget` iterations (counted
//   per lane), or its |atten| passes the launch's threshold, tested after
//   that step's bank/recycle (a heavy lane whose walk is due banks
//   first). Live lanes take rounds of REPACK_STEPS iterations; a lane
//   that stops writes its planes back at once; after a round, while the
//   pool lasts, a block whose free threads reach REPACK_REFILL refills
//   them; once it is empty, a block whose live lanes would fit in fewer
//   warps moves them through shared memory (LANE_FLOATS + LANE_INTS words
//   a lane) into its lowest threads, and threads without a lane wait at
//   the block's barriers, issuing nothing. That is exact: a lane's draws
//   depend on (seed, its counter, its stream) and never on the thread
//   that runs it, nothing is summed across lanes, and a frozen lane draws
//   nothing, advances no counter and does not move, so it stays frozen
//   for the rest of the launch. The threshold is a launch argument (no
//   rebuild per launch). The TPU kernel steps a block in lock-step while
//   any of its lanes is steppable (:1183-1203); on Hopper the scarce
//   resource is warp issue slots. Packing alone does not pay: a block
//   whose lanes froze holds its SM's registers while one warp walks on,
//   latency-bound; refilling keeps the SM's warps full until the pool is
//   empty. A launch still lasts at least its longest lane's iterations at
//   one lane's latency.
// - The chain builds without the freeze (walk_variant.h::chain_phases):
//   with MIS the sharded flagship, the notebook line and their table,
//   TERMS, grid and transport forms; without MIS the accuracy path, the
//   variable coefficients and their grid and transport forms (the table
//   form and the TERMS forms without MIS ran slower so and keep one
//   thread a lane): the repack loop at thr = +inf, and the step in
//   phases that the whole block runs (walk_step_chain). The chain's wall
//   work (the chord mass of a lane on the wall, the wall-arrival factor
//   of a lane that reaches it, the chord branch) ran on 5-7% of the lanes
//   but held nearly every warp, 19-32% of the loop's warp-cycles
//   (chip_probes/step_sites.py). A lane that needs it writes its inputs
//   to a queue in the block's shared memory (the repack stash, free
//   within a step; the slot from a shared atomic); after a barrier the
//   block's threads run the entries one a thread, and after a second
//   each lane reads its results back. Every entry runs walk_step.inc's
//   arithmetic on the lane's own values, so the result is the one-thread
//   loop's bit for bit. The builds with MIS sum the mixture pdf over the
//   components near the sample only (mis_nee's NEAR: a far component's
//   term is exactly +0); those without run the one-thread loop's NEE at
//   the sample on the lane, and queue the rejection sampler's redraw
//   rounds where they loop (redraw_queued).
// - The one-thread loop stays for the rest: the short walk lost 10% on
//   the repack loop (chip_probes/repack_on_plain_builds.py), and builds
//   without the chain have no wall work to queue.
// - The survey builds (walk_variant.h::dealt: the main path's survey, its
//   transport and MIS builds, and the wide survey with MIS and without)
//   hold a third loop beside the one-thread loop, walk_dealt (below),
//   which a launch of one shard runs when its budget drains every quota
//   from fresh walks: walks, not lanes, go to the threads, so no thread
//   idles until the walks run out (the one-thread loop left 32% of the
//   survey's lane-slots idle, 41% of the wide survey's). The launch's
//   shape picks the loop (ops/walk_kernel.py::launch_loop). The short
//   walk's build keeps one thread a lane: dealt, it ran slower on the
//   card (PERF.md, section 6).
// - The builds without delta tracking keep the one-thread loop with a
//   hook each in walk_step.inc: the static form's (the short walk,
//   walk_variant.h::one_sincos) takes the step's direction from one
//   sincosf (WALK_SINCOS; with MIS, phase 49's narrow source, its
//   Box-Muller pair too), the table form's (the Poisson bubble,
//   walk_variant.h::culled_closest) culls its closest point by chunks of
//   the Dirichlet rows (closest_point_culled, WALK_CLOSEST).
// - The table chain (phase 48's terrain over shallow bodies) keeps the
//   one-thread loop (its repack loop ran slower) and culls its chain's
//   chord frame by chunks of the Neumann rows (chord_frame_culled,
//   WALK_CHORD; walk_variant.h::culled_chord); its first hit keeps the
//   full scan (culled beside it, it ran slower: PERF.md, section 6).
//
// MIS adds per step, on every stepping lane (not only those whose radius
// stays inside the star, so it adds work but no divergence): four more
// hash draws, a component pick, a Box-Muller offset (one logf, one sqrtf,
// cosf and sinf), the screened Green's function at the sample (two K0 and
// two I0: a logf and up to three expf) and its norm, a first-hit scan
// along the sample direction (the star test), one expf per mixture
// component, a third alpha_c, and the sources at the sample. That is FP32
// and SFU work again, not bytes.
//
// Arithmetic follows the plain version (ops/walk_kernel.py::walk_plain)
// op for op and is built with -fmad=false and without fast math, so the
// two track each other: the divide in the closest-point projection, the
// reciprocal-multiply in the first hit, selects instead of masks, the
// u32 counter ndone*(max_steps+2)+steps, the round and roulette stream
// seeds, the MIS mixture constants as the TPU kernel forms them at trace
// time (a float32 cumsum; 2 w^2 and 2 pi w^2 rounded once from double).
// Constants are written as double literals cast to float, which rounds
// them the way the Python side does.
//
// Build: one library per variant, its switches as -D macros; a unit
// without them does not compile. walk_launch refuses a header whose
// switches are not the library's.
//
// Interface: plain C (walk_launch), loaded with ctypes. Parameters and
// plane pointers go to __constant__ memory with an async copy on the
// launch stream, so launches on one stream are ordered; two streams must
// not launch concurrently.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "walk_variant.h"

#if !(defined(WALK_ROBIN) && defined(WALK_MAJORANT) && defined(WALK_MIS) && \
      defined(WALK_FREEZE) && defined(WALK_TABLE) && defined(WALK_DELTA) &&  \
      defined(WALK_TRANSPORT) && defined(WALK_WIDE) && defined(WALK_GRID) && \
      defined(WALK_TERMS) && defined(WALK_ROWS))
#error "one library per variant: its switches as -D macros WALK_ROBIN, \
WALK_MAJORANT, WALK_MIS, WALK_FREEZE, WALK_TABLE, WALK_DELTA, \
WALK_TRANSPORT, WALK_WIDE, WALK_GRID, WALK_TERMS, WALK_ROWS (nvcc_command)"
#endif
#if WALK_ROWS && !WALK_WIDE
#error "the general rows (WALK_ROWS) are the wide form's sources"
#endif
// the culled variant's large-table build (walk_variant.h::large_scans), a
// build switch that ops/walk_kernel.py::variant_macros names only where it
// is set
#if !defined(WALK_LARGE)
#define WALK_LARGE 0
#endif

#define F(x) ((float)(x))

// the library's variant runs the table form's culled first hit
// (chunk_skips)
constexpr bool CULLED = walk_rules::culled_scans(
    WALK_ROBIN, WALK_MAJORANT != 0, WALK_MIS != 0, WALK_FREEZE != 0,
    WALK_TABLE != 0, WALK_DELTA != 0, WALK_TRANSPORT != 0, WALK_WIDE != 0,
    WALK_GRID != 0, WALK_TERMS != 0);
// a culled scan skips the chunks that chunk_skips rules out (false: it
// visits every chunk, which is the full scan in row order)
constexpr bool CHUNK_SKIP = true;
static_assert(!WALK_LARGE || (CULLED && !WALK_ROWS),
              "the large-table scans are the culled table build's");
// the library's variant runs the culled closest point
// (walk_variant.h::culled_closest), takes its direction (and with MIS its
// Box-Muller pair) from one sincosf (walk_variant.h::one_sincos) or runs
// the culled chord frame (walk_variant.h::culled_chord); the
// preprocessor's copies of the three rules pick walk_step.inc's hooks in
// the one-thread loop, so that the other builds compile the text they
// compiled before
#define WALK_CULLED_CLOSEST                                               \
  (WALK_ROBIN == 0 && !WALK_MAJORANT && !WALK_MIS && !WALK_FREEZE &&      \
   WALK_TABLE && !WALK_DELTA && !WALK_TRANSPORT && !WALK_WIDE &&          \
   !WALK_GRID && !WALK_TERMS)
#define WALK_ONE_SINCOS                                                   \
  (WALK_ROBIN == 0 && !WALK_MAJORANT && !WALK_FREEZE && !WALK_TABLE &&    \
   !WALK_DELTA && !WALK_TRANSPORT && !WALK_WIDE && !WALK_GRID &&          \
   !WALK_TERMS)
#define WALK_CULLED_CHORD                                                 \
  (WALK_ROBIN == 1 && !WALK_MAJORANT && !WALK_MIS && !WALK_FREEZE &&      \
   WALK_TABLE && WALK_DELTA && !WALK_TRANSPORT && !WALK_WIDE &&           \
   !WALK_GRID && !WALK_TERMS)
constexpr bool CULLED_CLOSEST = walk_rules::culled_closest(
    WALK_ROBIN, WALK_MAJORANT != 0, WALK_MIS != 0, WALK_FREEZE != 0,
    WALK_TABLE != 0, WALK_DELTA != 0, WALK_TRANSPORT != 0, WALK_WIDE != 0,
    WALK_GRID != 0, WALK_TERMS != 0);
static_assert(CULLED_CLOSEST == (WALK_CULLED_CLOSEST != 0),
              "walk_variant.h::culled_closest");
static_assert(walk_rules::one_sincos(WALK_ROBIN, WALK_MAJORANT != 0,
                                     WALK_MIS != 0, WALK_FREEZE != 0,
                                     WALK_TABLE != 0, WALK_DELTA != 0,
                                     WALK_TRANSPORT != 0, WALK_WIDE != 0,
                                     WALK_GRID != 0, WALK_TERMS != 0) ==
                  (WALK_ONE_SINCOS != 0),
              "walk_variant.h::one_sincos");
constexpr bool CULLED_CHORD = walk_rules::culled_chord(
    WALK_ROBIN, WALK_MAJORANT != 0, WALK_MIS != 0, WALK_FREEZE != 0,
    WALK_TABLE != 0, WALK_DELTA != 0, WALK_TRANSPORT != 0, WALK_WIDE != 0,
    WALK_GRID != 0, WALK_TERMS != 0);
static_assert(CULLED_CHORD == (WALK_CULLED_CHORD != 0),
              "walk_variant.h::culled_chord");

namespace {

constexpr int MAX_SEG = 96;    // static form, per boundary
constexpr int MAX_VERT = 96;   // static form, silhouette vertices
constexpr int MAX_SRC = 4;
constexpr int MAX_BUMPS = 8;
constexpr int MAX_FP = 1 + 6 * MAX_BUMPS;
constexpr int F_BC = 0, F_ALPHA = 1, F_SIGMA = 2, F_SRC0 = 3;
constexpr int N_FIELDS = 3 + MAX_SRC;
constexpr int K_CONST = 0, K_BUMPS = 1, K_DIPOLE = 2, K_TERMS = 3;
constexpr int K_GRID = 4;      // the Dirichlet field only (GRID_COLS params)
// a source's kind word in the general rows build for a TERMS field that is
// one Gaussian pole (pole_record): evaluated from its record (pole_value)
constexpr int K_POLE = 5;
constexpr int GRID_COLS = 8;   // x0, dx, y0, dy, hi_x, hi_y, nx, ny
constexpr int MAX_TERMS = 4;   // TERMS field terms (problems/fields.py)
constexpr int TERM_COLS = 27;  // poly[4][4], ax, ay, g, cx, cy, S1, S2
constexpr int S_NONE = 0, S_SIN = 1, S_COS = 2;  // S = (kind, k, phase)
constexpr int N_PLANES = 6 + 5 + 3 * MAX_SRC + 9;
constexpr int THREADS = 128;
// the FREEZE builds' repack loop (walk_repacked): threads per block,
// iterations per round, and the free threads at which a block refills
// from the launch's pool (chip_probes/repack_tuning.py); the stash is
// LANE_FLOATS + LANE_INTS words a lane
constexpr int REPACK_THREADS = 256;
constexpr int REPACK_STEPS = 1;
constexpr int REPACK_REFILL = 32;
constexpr int MAX_BOXES = 8, MAX_BANDS = 8;  // problems/majorant.py
constexpr int ROBIN_OFF = 0, ROBIN_CHAIN = 1, ROBIN_REFLECT = 2;
constexpr int MAX_MIX = 8;   // MIS mixture components
constexpr int MIX_COLS = 7;  // cx, cy, w, a, cum, 2 w^2, 2 pi w^2
constexpr int N_IP = 21, N_FP = 11;  // header lengths of ip and fp
constexpr int N_GEOM = 4;  // table form: dir, neu, vert row pointers;
                           // the grid's node table
constexpr int MAX_WIDE_SRC = 32;  // the wide form: sources,
constexpr int MAX_WIDE_MIX = 64;  // MIS mixture components
constexpr int DIPOLE_COLS = 6;    // px, py, nx, ny, norm, 2 w^2
constexpr int N_WIDE_PLANES = 3 * (MAX_WIDE_SRC - MAX_SRC);
constexpr int LANE_FLOATS = 15 + 3 * MAX_SRC, LANE_INTS = 9;
// the sharded launch: shards a launch holds (one seed each)
constexpr int MAX_SHARDS = 64;
// the table form's culled scans: rows per chunk, and a chunk record's
// float4s (its box, the Neumann rows' direction cone)
constexpr int CHUNK_ROWS = 8, CHUNK_F4 = 2;
// the large-table build's (WALK_LARGE): vertex rows per silhouette chunk,
// a silhouette record's float4s (the box of its a, b and c points, the box
// of its b points, its oriented cone) and the chunks a group record
// covers, in both scans
constexpr int SIL_ROWS = 8, SIL_F4 = 3, GROUP_CHUNKS = 8;

struct Field {
  int kind;
  int n;
  float p[MAX_FP];
};

#if WALK_ROWS
// a wide source of the general rows build: its field as the header holds
// one (a TERMS row's background in f.p[0], its terms apart)
struct WideRow {
  Field f;
  int n_terms;
  float terms[MAX_TERMS][TERM_COLS];
};
#endif

struct Planes {
  const float *p0x, *p0y;
  const int *sid, *ob0;
  const float *n0x, *n0y;
  float *px, *py, *nx, *ny, *atten;
  float *acc[MAX_SRC], *asum[MAX_SRC], *asq[MAX_SRC];
  int *quota, *steps, *ndone, *ob, *life;
  float *tn, *tw, *wmax, *bmax;
};

struct WalkConst {
  uint32_t seed;  // ip[0]: a launch of one shard draws from it, one of
                  // several shards from shard_seed
  int max_steps, rounds, roulette, project, snap, n_src, has_source;
  int n_dir, n_neu;
  float eps, rmin, t_min, sigma_bar, roulette_thr;
  float dir[MAX_SEG][5];    // ax, ay, ux, uy, uu
  float neu[MAX_SEG][6];    // ax, ay, ux, uy, nx, ny
  Field field[N_FIELDS];    // bc, alpha, sigma, sources
  Planes pl;
  // the accuracy path (after the survey path's fields, whose offsets and
  // so whose compiled code stay as they were)
  int robin, majorant, n_box, n_band;
  float gamma_floor, arrival_clamp, sb_bg, mfp_bg, mfp_gl;
  float chord[MAX_SEG][8];  // ax, ay, ux, uy, uu, ul, tx, ty (f32-formed)
  float box[MAX_BOXES][4];  // x0, x1, y0, y1
  float band[MAX_BANDS][2]; // y_lo, y_hi
  // the flagship path (after the accuracy path's fields, for the same
  // reason): max_attenuation and the MIS mixture
  int clip, n_mix;
  float max_att;
  float mix[MAX_MIX][MIX_COLS];
  // the topographic path (after the flagship path's fields): silhouette
  // vertices, and the table form's rows in global memory
  int n_vert;
  float vert[MAX_VERT][8];   // static: ax, ay, bx, by, abx, aby, bcx, bcy
  const float4* tab_dir;     // table: (ax, ay, bx, by) per segment
  const float4* tab_neu;
  const float4* tab_vert;    // table: (ax, ay, bx, by), (cx, cy, 0, 0)
  // the analytic-check problems (after the topographic path's fields):
  // the TERMS fields' term rows, by field (Field::p[0] holds the
  // background)
  int n_terms[N_FIELDS];
  float terms[N_FIELDS][MAX_TERMS][TERM_COLS];
  // the survey products' wide form (after the analytic-check fields):
  // sources MAX_SRC.. as dipole rows, every source's moment planes and a
  // mixture of up to MAX_WIDE_MIX components
  float wsrc[MAX_WIDE_SRC - MAX_SRC][DIPOLE_COLS];
  float *wacc[MAX_WIDE_SRC], *wasum[MAX_WIDE_SRC], *wasq[MAX_WIDE_SRC];
  float wmix[MAX_WIDE_MIX][MIX_COLS];
  // the validation path (after the wide form's fields): the gridded
  // Dirichlet field's nodes, (nx, ny) row-major; its parameters are
  // field[F_BC].p
  const float* grid;
  // the table form's chunk records (after the validation path's fields):
  // CHUNK_F4 float4 per chunk of CHUNK_ROWS Neumann rows (chunk_skips), in
  // the culled_closest build of Dirichlet rows (closest_point_culled)
  const float4* chunk;
#if WALK_LARGE
  // the large-table build's records, in the chunks' buffer after them
  // (ops/walk_kernel.py::large_records): the first hit's groups, the
  // silhouette's chunks and groups
  const float4* hit_group;
  const float4* sil_chunk;
  const float4* sil_group;
#endif
#if WALK_ROWS
  // the general rows build's Gaussian pole sources (K_POLE): bit i of
  // pole_mask marks source i, header or row, and pole[i] is its record
  // (cx, cy, amp, g)
  float4 pole[MAX_WIDE_SRC];
  uint32_t pole_mask;
  // the general rows build's sources MAX_SRC.. (in that build only, so
  // that the other builds' block stays as it was; before the shard table,
  // so that a launch copies the rows of its own sources and its seeds)
  WideRow wrow[MAX_WIDE_SRC - MAX_SRC];
#endif
  // the shard table (last, so that a launch copies only the seeds it
  // uses): a launch over the lanes of n_shards shards, shard_lanes each,
  // shard after shard; a lane draws from its shard's seed (a launch of one
  // solve's lanes is a table of one shard)
  int n_shards, shard_lanes;
  uint32_t shard_seed[MAX_SHARDS];
};

// the block and the module's other constant tables share the 64 KB
// constant bank (the general rows take 18.4 KB of it)
static_assert(sizeof(WalkConst) <= 56 * 1024, "WalkConst outgrows the "
              "constant bank");

__constant__ WalkConst C;

// ---- counter-hash RNG (sampling/rng.py) --------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_base(uint32_t seed, uint32_t ctr) {
  return mix32(seed ^ (0x85EBCA6Bu * ctr));
}

__device__ __forceinline__ float uni(uint32_t base, uint32_t sid, uint32_t k) {
  uint32_t h = mix32(sid ^ (0x9E3779B9u * k) ^ base);
  return (float)(h >> 8) * F(5.9604644775390625e-08);  // 2^-24
}

// the stream seed of plane index `lane` in a launch of several shards
// (the SHARDS kernel): its shard's (a shard's lanes are whole warps of the
// one-thread loop, so a warp reads one entry). A launch of one shard runs
// the other kernel, which reads the launch's seed (ip[0], its table's one
// entry) as a constant operand that holds no register: a per-lane seed,
// and even an operand from the far end of the block, moved the table
// builds' registers, spills and occupancy (PERF.md, section 6)
__device__ __forceinline__ uint32_t lane_seed(int lane) {
  return C.shard_seed[lane / C.shard_lanes];
}

// ---- Bessel functions (ops/bessel.py) ----------------------------------

__constant__ float I0_SMALL[7] = {F(1.0), F(3.5156229), F(3.0899424),
                                  F(1.2067492), F(0.2659732), F(0.0360768),
                                  F(0.0045813)};
__constant__ float I0_LARGE[9] = {F(0.39894228), F(0.01328592),
                                  F(0.00225319), F(-0.00157565),
                                  F(0.00916281), F(-0.02057706),
                                  F(0.02635537), F(-0.01647633),
                                  F(0.00392377)};
__constant__ float K0_SMALL[7] = {F(-0.57721566), F(0.42278420),
                                  F(0.23069756), F(0.03488590),
                                  F(0.00262698), F(0.00010750),
                                  F(0.00000740)};
__constant__ float K0_LARGE[7] = {F(1.25331414), F(-0.07832358),
                                  F(0.02189568), F(-0.01062446),
                                  F(0.00587872), F(-0.00251540),
                                  F(0.00053208)};

template <int N>
__device__ __forceinline__ float polyval(const float (&c)[N], float t) {
  float a = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) a = a * t + c[i];
  return a;
}

__device__ __forceinline__ float i0_small(float x) {
  float t = x / F(3.75);
  return polyval(I0_SMALL, t * t);
}

__device__ __forceinline__ float i0e_large(float x) {
  return polyval(I0_LARGE, F(3.75) / x) / sqrtf(x);
}

__device__ float i0e(float x) {
  x = fabsf(x);
  if (x < F(3.75)) return i0_small(x) * expf(-x);
  return i0e_large(x);
}

__device__ float k0_small(float x) {
  float t = x / F(2.0);
  return -logf(x / F(2.0)) * i0_small(x) + polyval(K0_SMALL, t * t);
}

__device__ float k0e(float x) {
  float xc = fmaxf(x, F(1e-30));
  if (xc <= F(2.0)) return k0_small(xc) * expf(xc);
  return polyval(K0_LARGE, F(2.0) / xc) / sqrtf(xc);
}

// 1 - 1/I0(z) from i0e(z), cancellation-safe (ops/greens.py)
__device__ float one_minus_inv_i0_scaled(float z, float i0e_z) {
  float t = z * z * F(0.25);
  float s = t * (F(1.0) + t * (F(0.25) + t / F(36.0)));
  if (z < F(0.25)) return s / (F(1.0) + s);
  return F(1.0) - expf(-z) / fmaxf(i0e_z, F(1e-30));
}

__device__ float interior_prob(float R, float sb) {
  float z = R * sqrtf(sb);
  return one_minus_inv_i0_scaled(z, i0e(z));
}

__device__ float screened_norm(float R, float sb) {
  return interior_prob(R, sb) / sb;
}

// ---- the Robin correction's Bessel functions and Green's kernels ------
// (ops/bessel.py, ops/greens.py: A&S 9.8.3-9.8.8 for order 1; the series
// and fits of int_0^z I0 and int_0^z K0)

__constant__ float I1_SMALL[7] = {F(0.5), F(0.87890594), F(0.51498869),
                                  F(0.15084934), F(0.02658733),
                                  F(0.00301532), F(0.00032411)};
__constant__ float I1_LARGE[9] = {F(0.39894228), F(-0.03988024),
                                  F(-0.00362018), F(0.00163801),
                                  F(-0.01031555), F(0.02282967),
                                  F(-0.02895312), F(0.01787654),
                                  F(-0.00420059)};
__constant__ float K1_SMALL[7] = {F(1.0), F(0.15443144), F(-0.67278579),
                                  F(-0.18156897), F(-0.01919402),
                                  F(-0.00110404), F(-4.686e-05)};
__constant__ float K1_LARGE[7] = {F(1.25331414), F(0.23498619),
                                  F(-0.0365562), F(0.01504268),
                                  F(-0.00780353), F(0.00325614),
                                  F(-0.00068245)};
// (int_0^z I0) / z, the K0 integral's regular sum over z, and T / z^2 with
// K0 = -(ln(z/2) + gamma_E) I0 + T: series in z^2 (bessel.py
// _int_series_coeffs, 11 terms)
__constant__ float II0_SER[11] = {
    F(1.0), F(0.08333333333333333), F(0.003125), F(6.200396825396825e-05),
    F(7.535204475308642e-07), F(6.165167297979798e-09),
    F(3.622694459283001e-11), F(1.6018716996829596e-13),
    F(5.521157053135201e-16), F(1.5246859958300589e-18),
    F(3.4486945143775135e-21)};
__constant__ float IK0_SER[11] = {
    F(1.0), F(0.1111111111111111), F(0.0053124999999999995),
    F(0.0001225316515495087), F(1.6535587598593962e-06),
    F(1.463760175141567e-08), F(9.154270229803582e-11),
    F(4.2602159251092045e-13), F(1.533049007800167e-15),
    F(4.3935349108326865e-18), F(1.0265340298549894e-20)};
__constant__ float K0REG_SER[10] = {
    F(0.25), F(0.0234375), F(0.0007957175925925925), F(1.41285083912037e-05),
    F(1.5484845196759258e-07), F(1.1538281852816358e-09),
    F(6.23013671769551e-12), F(2.5509717427289318e-14),
    F(8.195247730999098e-17), F(2.1212345175517024e-19)};
__constant__ float II0E_LARGE[10] = {
    F(0.39892117833666013), F(0.0683659380497933), F(-0.019199593449555692),
    F(0.5493053727171856), F(-2.987467946770637), F(9.326451372102712),
    F(-15.800573705385947), F(14.685752682422835), F(-7.138285073342126),
    F(1.4282994561660782)};
__constant__ float IK0_TAIL[8] = {
    F(1.2532603568891372), F(-0.39012360170047267), F(0.29878153845917976),
    F(-0.30142804207123175), F(0.2850220058180192), F(-0.2003588389084528),
    F(0.08645137263695717), F(-0.0167236317256414)};

constexpr double TWO_PI = 6.283185307179586;

__device__ float i0(float x) {
  x = fabsf(x);
  if (x < F(3.75)) return i0_small(x);
  return i0e_large(x) * expf(x);
}

__device__ float k0(float x) {
  float xc = fmaxf(x, F(1e-30));
  if (xc <= F(2.0)) return k0_small(xc);
  return polyval(K0_LARGE, F(2.0) / xc) / sqrtf(xc) * expf(-xc);
}

__device__ __forceinline__ float i1_small(float x) {
  float t = x / F(3.75);
  return x * polyval(I1_SMALL, t * t);
}

__device__ float i1e(float x) {
  x = fabsf(x);
  if (x < F(3.75)) return i1_small(x) * expf(-x);
  return polyval(I1_LARGE, F(3.75) / x) / sqrtf(x);
}

__device__ float k1e(float x) {
  float xc = fmaxf(x, F(1e-30));
  if (xc <= F(2.0)) {
    float t = xc / F(2.0);
    float k1 = logf(xc / F(2.0)) * i1_small(xc) +
               polyval(K1_SMALL, t * t) / xc;
    return k1 * expf(xc);
  }
  return polyval(K1_LARGE, F(2.0) / xc) / sqrtf(xc);
}

// e^{-z} int_0^z I0
__device__ float ii0e(float z) {
  z = fabsf(z);
  if (z < F(3.75)) return z * polyval(II0_SER, z * z) * expf(-z);
  return polyval(II0E_LARGE, F(3.75) / z) / sqrtf(z);
}

// int_0^z K0
__device__ float ik0(float z) {
  float zc = fmaxf(z, F(1e-30));
  if (zc <= F(2.0)) {
    float z2 = zc * zc;
    float L = logf(F(0.5) * zc) + F(0.5772156649015329);
    return zc * (polyval(IK0_SER, z2) - L * polyval(II0_SER, z2));
  }
  return F(1.5707963267948966) -
         expf(-zc) / sqrtf(zc) * polyval(IK0_TAIL, F(2.0) / zc);
}

// the screened ball Green's function G_s(r) in a ball of radius R
__device__ float screened_greens(float r, float R, float sb) {
  float s = sqrtf(sb);
  float z = R * s;
  float rz = fmaxf(r, F(1e-12)) * s;
  return (k0(rz) - (k0(z) / i0(z)) * i0(rz)) / F(TWO_PI);
}

// G_s(d) / |dG_s/dd (d)|: the Robin wall-arrival kernel ratio
__device__ float wall_ratio(float d, float R, float sb) {
  float q = sqrtf(sb);
  float zd = fmaxf(d, F(1e-12)) * q;
  float zr = R * q;
  float ratio_c = (k0e(zr) / i0e(zr)) * expf(F(2.0) * fminf(zd - zr, F(0.0)));
  float num = k0e(zd) - ratio_c * i0e(zd);
  float den = q * (k1e(zd) + ratio_c * i1e(zd));
  return fmaxf(num, F(0.0)) / fmaxf(den, F(1e-30));
}

// J(r) = int_0^r G_s(t) dt, both branches of the reference's z <= 2 select
// (the series keeps the limit J -> r / 2 pi as sigma_bar -> 0)
__device__ float chord_integral(float r, float sb) {
  float q = sqrtf(fmaxf(sb, F(0.0)));
  float z = r * q;
  if (z <= F(2.0)) {
    float zs = fminf(z, F(2.0));
    float z2 = zs * zs;
    return (polyval(IK0_SER, z2) -
            z2 * polyval(K0REG_SER, z2) * polyval(II0_SER, z2) / i0(zs)) *
           (r / F(TWO_PI));
  }
  float zl = fmaxf(z, F(2.0));
  float cross = k0e(zl) * ii0e(zl) * expf(-zl) / i0e(zl);
  return (ik0(zl) - cross) / (F(TWO_PI) * fmaxf(q, F(1e-30)));
}

// ---- fields (problems/fields.py) ---------------------------------------

__device__ __forceinline__ float sigmoid(float v) {
  return F(1.0) / (F(1.0) + expf(-v));
}

// ---- TERMS fields (problems/fields.py::Terms) ---------------------------
// background + sum_t P_t(x, y) exp(E_t) S1_t(x) S2_t(y), E = (ax x + ay y)
// - g |p - c|^2: P by Horner's rule in y for each power of x, then in x;
// the derivatives by the product rule, in Terms.value_grad_lap's order.
// __noinline__ keeps the term loops out of the callers' registers; which
// instantiations evaluate the kind at all is terms_fields (below).

__device__ __forceinline__ float horner4(float c0, float c1, float c2,
                                         float c3, float t) {
  return ((c3 * t + c2) * t + c1) * t + c0;
}

__device__ __forceinline__ bool term_has_exp(const float* q) {
  return q[16] != F(0.0) || q[17] != F(0.0) || q[18] != F(0.0);
}

__device__ __forceinline__ float term_exp(const float* q, float x, float y) {
  const float dx = x - q[19], dy = y - q[20];
  return expf((q[16] * x + q[17] * y) - q[18] * (dx * dx + dy * dy));
}

// S(t) = sin(k t + phase) or cos(k t + phase), with S' and S''
__device__ __forceinline__ void term_factor(const float* s, float t, float& v,
                                            float& dv, float& d2v) {
  const float k = s[1];
  const float arg = k * t + s[2];
  const float kk = k * k;
  if (s[0] == F(S_SIN)) {
    v = sinf(arg);
    dv = k * cosf(arg);
  } else {
    v = cosf(arg);
    dv = -k * sinf(arg);
  }
  d2v = -kk * v;
}

// terms_value's body over a field's term table: BG its background, N its
// term count, ROWS its term rows (the header's field here, a general row
// in row_terms_value: one text, so that the two evaluate op for op alike
// and the header's fields compile as they did)
#define TERMS_VALUE_BODY(BG, N, ROWS)                                   \
  float total = BG + F(0.0) * x;                                        \
  for (int t = 0; t < N; ++t) {                                         \
    const float* q = ROWS[t];                                           \
    float val = horner4(horner4(q[0], q[1], q[2], q[3], y),             \
                        horner4(q[4], q[5], q[6], q[7], y),             \
                        horner4(q[8], q[9], q[10], q[11], y),           \
                        horner4(q[12], q[13], q[14], q[15], y), x);     \
    if (term_has_exp(q)) val = val * term_exp(q, x, y);                 \
    if (q[21] != F(S_NONE)) val = val * (q[21] == F(S_SIN)              \
                                             ? sinf(q[22] * x + q[23])  \
                                             : cosf(q[22] * x + q[23])); \
    if (q[24] != F(S_NONE)) val = val * (q[24] == F(S_SIN)              \
                                             ? sinf(q[25] * y + q[26])  \
                                             : cosf(q[25] * y + q[26])); \
    total = total + val;                                                \
  }                                                                     \
  return total;

__device__ __noinline__ float terms_value(int f, float x, float y) {
  TERMS_VALUE_BODY(C.field[f].p[0], C.n_terms[f], C.terms[f])
}

// adds each term's value, gradient and Laplacian to acc = (v, gx, gy, lap);
// by value in and out, so the callers' sums stay in registers
__device__ __noinline__ float4 terms_parts(int f, float x, float y,
                                           float4 acc) {
  for (int t = 0; t < C.n_terms[f]; ++t) {
    const float* q = C.terms[f][t];
    float py[4], qy[4], ry[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* a = q + 4 * i;
      py[i] = horner4(a[0], a[1], a[2], a[3], y);
      qy[i] = (F(3.0) * a[3] * y + F(2.0) * a[2]) * y + a[1];
      ry[i] = F(6.0) * a[3] * y + F(2.0) * a[2];
    }
    const float P = horner4(py[0], py[1], py[2], py[3], x);
    const float Px = (F(3.0) * py[3] * x + F(2.0) * py[2]) * x + py[1];
    const float Pxx = F(6.0) * py[3] * x + F(2.0) * py[2];
    const float Py = horner4(qy[0], qy[1], qy[2], qy[3], x);
    float lapA = Pxx + horner4(ry[0], ry[1], ry[2], ry[3], x);
    float A = P, Ax = Px, Ay = Py;
    if (term_has_exp(q)) {
      const float G = term_exp(q, x, y);
      const float g2 = F(2.0) * q[18];
      const float Ex = q[16] - g2 * (x - q[19]);
      const float Ey = q[17] - g2 * (y - q[20]);
      const float Gx = G * Ex, Gy = G * Ey;
      const float lapG = G * ((Ex * Ex + Ey * Ey) - F(4.0) * q[18]);
      A = P * G;
      Ax = Px * G + P * Gx;
      Ay = Py * G + P * Gy;
      lapA = (lapA * G + F(2.0) * (Px * Gx + Py * Gy)) + P * lapG;
    }
    float val = A, tx = Ax, ty = Ay, tl = lapA, ay_b = Ay, a1 = A;
    if (q[21] != F(S_NONE)) {
      float b, db, d2b;
      term_factor(q + 21, x, b, db, d2b);
      val = val * b;
      tx = tx * b + A * db;
      ty = ty * b;
      tl = (tl * b + (F(2.0) * Ax) * db) + A * d2b;
      ay_b = Ay * b;
      a1 = A * b;
    }
    if (q[24] != F(S_NONE)) {
      float b, db, d2b;
      term_factor(q + 24, y, b, db, d2b);
      val = val * b;
      tx = tx * b;
      ty = ty * b + a1 * db;
      tl = tl * b + ((F(2.0) * ay_b) * db + a1 * d2b);
    }
    acc.x = acc.x + val;
    acc.y = acc.y + tx;
    acc.z = acc.z + ty;
    acc.w = acc.w + tl;
  }
  return acc;
}

using walk_rules::chain_phases;
using walk_rules::repacked;
using walk_rules::terms_fields;

// field_value's body over a field record FD whose TERMS kind TERMS_CALL
// evaluates (the header's field here, a general row in row_value: one
// text, as TERMS_VALUE_BODY)
#define FIELD_VALUE_BODY(FD, TERMS_CALL)                              \
  const Field& fd = FD;                                               \
  const float* p = fd.p;                                              \
  if (fd.kind == K_CONST) return p[0] + F(0.0) * x;                   \
  if constexpr (TERMS) {                                              \
    if (fd.kind == K_TERMS) return TERMS_CALL;                        \
  }                                                                   \
  if (fd.kind == K_DIPOLE) {                                          \
    float epx = x - p[0], epy = y - p[1], enx = x - p[2], eny = y - p[3]; \
    float dp = epx * epx + epy * epy;                                 \
    float dn = enx * enx + eny * eny;                                 \
    return p[4] * (expf(-dp / p[5]) - expf(-dn / p[5]));              \
  }                                                                   \
  float total = p[0] + F(0.0) * x;                                    \
  const int nb = (fd.n - 1) / 6;                                      \
  for (int b = 0; b < nb; ++b) {                                      \
    const float* q = p + 1 + 6 * b; /* amp, cx, cy, radius, k, w2 */  \
    float ex = x - q[1], ey = y - q[2];                               \
    float rho = sqrtf((ex * ex + ey * ey) + q[5]);                    \
    total = total + q[0] * sigmoid(-q[4] * (rho - q[3]));             \
  }                                                                   \
  return total;

template <bool TERMS>
__device__ float field_value(int f, float x, float y) {
  FIELD_VALUE_BODY(C.field[f], terms_value(f, x, y))
}

// the gridded Dirichlet field (problems/fields.py::Grid): the bilinear
// interpolant in grid_continuation's float32 order. The index coordinate
// (p - x0) / dx (a divide) is clipped to [0, hi], hi = n - 1.000001
// rounded to float32 (n - 1 itself for some n), and truncated; a corner
// past the last node reads the last node, with weight zero, as JAX's
// clamped gather does. Called once per finished walk.
__device__ __noinline__ float grid_value(float x, float y) {
  const float* p = C.field[F_BC].p;
  const int nx = (int)p[6], ny = (int)p[7];
  const float fx = fminf(fmaxf((x - p[0]) / p[1], F(0.0)), p[4]);
  const float fy = fminf(fmaxf((y - p[2]) / p[3], F(0.0)), p[5]);
  const int ix = (int)fx, iy = (int)fy;
  const float tx = fx - (float)ix, ty = fy - (float)iy;
  const int ix1 = min(ix + 1, nx - 1), iy1 = min(iy + 1, ny - 1);
  const float* u = C.grid;
  const float u00 = __ldg(u + ix * ny + iy), u10 = __ldg(u + ix1 * ny + iy);
  const float u01 = __ldg(u + ix * ny + iy1);
  const float u11 = __ldg(u + ix1 * ny + iy1);
  return ((((F(1.0) - tx) * (F(1.0) - ty)) * u00 +
           (tx * (F(1.0) - ty)) * u10) +
          ((F(1.0) - tx) * ty) * u01) +
         (tx * ty) * u11;
}

template <bool TERMS>
__device__ __forceinline__ float alpha_c(float x, float y) {
  return fmaxf(field_value<TERMS>(F_ALPHA, x, y), F(1e-8));
}

#if WALK_ROWS
// the general rows build's wide source r, by terms_value's and
// field_value's own text (TERMS_VALUE_BODY, FIELD_VALUE_BODY; the builds
// without rows compile as before); the row index is the same in every
// thread of a warp, so the kind's branch is uniform and the row's loads
// broadcast
__device__ __noinline__ float row_terms_value(int r, float x, float y) {
  TERMS_VALUE_BODY(C.wrow[r].f.p[0], C.wrow[r].n_terms, C.wrow[r].terms)
}

template <bool TERMS>
__device__ float row_value(int r, float x, float y) {
  FIELD_VALUE_BODY(C.wrow[r].f, row_terms_value(r, x, y))
}

// the Gaussian pole source i from its record (cx, cy, amp, g): terms_value
// on its field bit for bit (pole_record's term; x and y finite): the
// background 0 + 0 x is +0; each Horner step over the zero coefficients
// gives +-0, and +-0 + amp is amp; the exponent (0 x + 0 y) - g d^2 is
// -(g d^2) (+-0 - z is -z for z != 0, and for z = +-0 both are +-0, whose
// expf is 1); the sum's +0 + amp e stays. Nine operations and an expf in
// place of TERMS_VALUE_BODY's call, its 30 Horner operations (unfused
// under -fmad=false) and its selectors
__device__ __forceinline__ float pole_value(int i, float x, float y) {
  const float4 q = C.pole[i];
  const float dx = x - q.x, dy = y - q.y;
  return F(0.0) + q.z * expf(-(q.w * (dx * dx + dy * dy)));
}
#endif

// source i of the walk: a field of the header, or from MAX_SRC on in the
// wide form a dipole row (a row of any kind in the general rows build,
// and there a marked pole from its record); i is the same in every thread
// of a warp, so the branches are uniform
template <bool TERMS, bool WIDE>
__device__ __forceinline__ float source_value(int i, float x, float y) {
#if WALK_ROWS
  if ((C.pole_mask >> i) & 1u) return pole_value(i, x, y);
#endif
  if (!WIDE || i < MAX_SRC) return field_value<TERMS>(F_SRC0 + i, x, y);
#if WALK_ROWS
  return row_value<TERMS>(i - MAX_SRC, x, y);
#else
  const float* p = C.wsrc[i - MAX_SRC];
  float epx = x - p[0], epy = y - p[1], enx = x - p[2], eny = y - p[3];
  float dp = epx * epx + epy * epy;
  float dn = enx * enx + eny * eny;
  return p[4] * (expf(-dp / p[5]) - expf(-dn / p[5]));
#endif
}

// alpha_c = max(alpha, 1e-8) with its gradient (and, for LAP, Laplacian),
// zero where the clamp is active: hand-derived derivatives of the bump sum
// and the terms (fields.BumpSum/Terms.value_grad_lap, fields._alpha_parts)
template <bool LAP, bool TERMS>
__device__ __forceinline__ void alpha_parts(float x, float y, float& ac,
                                            float& gx, float& gy,
                                            float& lap) {
  const Field& fd = C.field[F_ALPHA];
  const float* p = fd.p;
  float z0 = F(0.0) * x;
  float a = p[0] + z0;
  gx = z0;
  gy = z0;
  lap = z0;
  if (fd.kind == K_BUMPS) {
    const int nb = (fd.n - 1) / 6;
    for (int b = 0; b < nb; ++b) {
      const float* q = p + 1 + 6 * b;
      float k = q[4];
      float ex = x - q[1], ey = y - q[2];
      float d2 = ex * ex + ey * ey;
      float rho = sqrtf(d2 + q[5]);
      float s = sigmoid(-k * (rho - q[3]));
      float ds = -k * (s * (F(1.0) - s));
      float d2s = F(0.0);
      if constexpr (LAP)
        d2s = k * (k * (s * (F(1.0) - s) * (F(1.0) - F(2.0) * s)));
      a = a + q[0] * s;
      gx = gx + q[0] * (ds * ex / rho);
      gy = gy + q[0] * (ds * ey / rho);
      if constexpr (LAP)
        lap = lap + q[0] * (d2s * (d2 / (rho * rho)) +
                            ds * ((d2 + F(2.0) * q[5]) / (rho * rho * rho)));
    }
  } else if constexpr (TERMS) {
    if (fd.kind == K_TERMS) {
      const float4 t =
          terms_parts(F_ALPHA, x, y, make_float4(a, gx, gy, lap));
      a = t.x;
      gx = t.y;
      gy = t.z;
      lap = t.w;
    }
  }
  bool live = a > F(1e-8);
  ac = fmaxf(a, F(1e-8));
  if (!live) { gx = F(0.0); gy = F(0.0); lap = F(0.0); }
}

// sigma' = sigma/a + (lap a / a - |grad ln a|^2 / 2) / 2
template <bool TERMS>
__device__ float sigma_prime(float x, float y) {
  float ac, gx, gy, lap;
  alpha_parts<true, TERMS>(x, y, ac, gx, gy, lap);
  float la = ac + F(1e-8);
  float glx = gx / la, gly = gy / la;
  float gn2 = glx * glx + gly * gly;
  return field_value<TERMS>(F_SIGMA, x, y) / ac +
         F(0.5) * (lap / ac - gn2 / F(2.0));
}

// the dealt loop's alpha at a sample (WALK_ONE_PASS): with a bump sum or a
// constant, alpha_parts' pass, whose clamped value is alpha_c's bit for bit
// (field_value's operations in the same order) and whose derivatives
// sigma_prime_at takes at a colliding sample; another kind, alpha_c
// (parts false)
template <bool TERMS>
__device__ __forceinline__ float alpha_sample(float x, float y, float& gx,
                                              float& gy, float& lap,
                                              bool& parts) {
  const int kind = C.field[F_ALPHA].kind;
  parts = kind == K_BUMPS || kind == K_CONST;
  if (parts) {
    float ac;
    alpha_parts<true, TERMS>(x, y, ac, gx, gy, lap);
    return ac;
  }
  gx = gy = lap = F(0.0);
  return alpha_c<TERMS>(x, y);
}

// sigma_prime at (x, y) from alpha_sample's pass there (ac its value)
template <bool TERMS>
__device__ __forceinline__ float sigma_prime_at(float x, float y, float ac,
                                                float gx, float gy,
                                                float lap, bool parts) {
  if (!parts) return sigma_prime<TERMS>(x, y);
  float la = ac + F(1e-8);
  float glx = gx / la, gly = gy / la;
  float gn2 = glx * glx + gly * gly;
  return field_value<TERMS>(F_SIGMA, x, y) / ac +
         F(0.5) * (lap / ac - gn2 / F(2.0));
}

// grad ln(alpha_c + 1e-8) (fields.grad_log_alpha_fn)
template <bool TERMS>
__device__ void grad_log_alpha(float x, float y, float& glx, float& gly) {
  float ac, gx, gy, lap;
  alpha_parts<false, TERMS>(x, y, ac, gx, gy, lap);
  float la = ac + F(1e-8);
  glx = gx / la;
  gly = gy / la;
}

// ---- geometry of the accuracy path --------------------------------------

// The table form's culled first hit (chunk_skips, the culled_scans
// builds). The host cuts the Neumann rows into chunks of CHUNK_ROWS
// consecutive rows and gives each a record of CHUNK_F4 float4s
// (ops/walk_kernel.py::chunk_records): the box (x0, y0, x1, y1) of its
// rows' float32 endpoints, widened by 2^-20 of its largest coordinate, and
// the cone (mx, my, g): every row of the chunk has a unit direction or its
// negative within angle asin(g / 2) of the unit m, and g holds 2 sin of
// the cone's half-angle plus slack (4 when the rows turn too much, or some
// row is shorter than 1e-20). A lane visits the chunks in row order and
// runs the rows of a visited chunk as the full scan does, so its winner
// (the first row on ties), that row's normal and hit point are the full
// scan's within the limit: a chunk is skipped only where a bound proves
// that none of its rows can give a t in [tmw, lim], with margins that
// cover the float32 rounding of the rows' arithmetic. A warp runs the
// union of its lanes' chunks: a warp's lanes shoot rays in all
// directions, so the union keeps 68-173 of 200 rows where a lane needs
// 6-29 (PERF.md, section 6, Step 0). The other scans stay full: a culled
// closest point and silhouette (their nearest row lies far down the table
// or far away) and a first hit run cooperatively over a warp (a warp's
// threads on (lane, chunk) pairs) ran slower on the card, and so did the
// culled first hit in the builds other than the survey's (culled_scans).

// whether no Neumann row of the chunk (box b, cone c) can give first_hit
// an accepted t in [tmw, lim], so that its rows cannot change whether and
// where the ray meets a wall within lim. A row the full scan accepts has
// its computed s in [0, 1]: its endpoints then lie on both sides of the
// ray's line, or within eps = 2^-24 (7 |w| + 8 |u|) of it (the roundings
// of its cross products, |w| + |u| <= 2 rb), so a box whose corners all
// lie farther than 2^-16 rb on one side holds no such row. Where every
// row crosses the ray at a sine of at least sig >= 2^-10, its computed t
// lies within 2^-14.8 rb / sig of the box's extent along the ray (the
// cross products' and the divide's roundings over |den| >= sig |u|, and
// |d|^2 = 1 to 2^-17), so a box behind tmw or past lim by 2^-11 rb / sig
// holds no row with t in [tmw, lim]. A nearly parallel row's t is
// rounding noise, so only the line test holds there.
__device__ __forceinline__ bool hit_skips(float4 b, float4 c, float px,
                                          float py, float dx, float dy,
                                          float tmw, float lim) {
  const float x0 = b.x - px, x1 = b.z - px, y0 = b.y - py, y1 = b.w - py;
  const float rb = fabsf(x0) + fabsf(x1) + fabsf(y0) + fabsf(y1);
  const float dy0 = dx * y0, dy1 = dx * y1, dx0 = dy * x0, dx1 = dy * x1;
  // cross(d, corner - p), over the corners
  const float f_lo = fminf(dy0, dy1) - fmaxf(dx0, dx1);
  const float f_hi = fmaxf(dy0, dy1) - fminf(dx0, dx1);
  const float tol = rb * F(1.52587890625e-05) + F(1e-30);  // 2^-16
  if (f_lo > tol || f_hi < -tol) return true;
  const float sig = fabsf(dx * c.y - dy * c.x) - c.z;
  if (!(sig > F(0.0009765625))) return false;  // 2^-10
  // dot(d, corner - p), over the corners
  const float t_lo = fminf(dx * x0, dx * x1) + fminf(dy * y0, dy * y1);
  const float t_hi = fmaxf(dx * x0, dx * x1) + fmaxf(dy * y0, dy * y1);
  const float m = rb * F(4.8828125e-04);  // 2^-11
  return (tmw - t_hi) * sig > m || (t_lo - lim) * sig > m;
}

// the culled first hit's skip test (CHUNK_SKIP false: every chunk, the
// full scan in row order)
#define chunk_skips(test) (CHUNK_SKIP && (test))

#if WALK_LARGE
// The large-table build's first hit (WALK_LARGE) runs the chunks above a
// level of group records (ops/walk_kernel.py::large_records: the records
// chunk_records forms, over GROUP_CHUNKS chunks' rows at once) and visits
// a group's chunks only where group_skips does not rule the group out; the
// chunks and rows of a visited group run as above, in row order.
//
// whether no Neumann row of a group (box b, cone c, as a chunk's) can give
// first_hit an accepted t in [tmw, lim]: hit_skips on the group, or a
// distance test where every row crosses the ray at a sine of at least sig
// > 2^-10. There a row's computed t lies within 2^-20 rb / sig of the t of
// a point h of the box on the ray (the roundings of hit_skips' argument:
// the cross products', the divide's and |den| >= sig |u|), and t |d| =
// |h - p| is at least the box's distance from p, which fmaxf(ex, ey)
// bounds from below to one rounding; with |d|^2 = 1 to 2^-17 a box with
// (fmaxf(ex, ey) (1 - 2^-16) - lim) sig > 2^-11 rb holds no row with t <=
// lim. A row nearly parallel to the ray has its t from rounding noise
// (from the noise of cross products near zero: a ray along the line of a
// far row can compute any t), so the distance test holds there only at a
// sine bound, as hit_skips' t test does.
__device__ __forceinline__ bool group_skips(float4 b, float4 c, float px,
                                            float py, float dx, float dy,
                                            float tmw, float lim) {
  if (hit_skips(b, c, px, py, dx, dy, tmw, lim)) return true;
  const float sig = fabsf(dx * c.y - dy * c.x) - c.z;
  if (!(sig > F(0.0009765625))) return false;  // 2^-10
  const float x0 = b.x - px, x1 = b.z - px, y0 = b.y - py, y1 = b.w - py;
  const float rb = fabsf(x0) + fabsf(x1) + fabsf(y0) + fabsf(y1);
  const float ex = fmaxf(fmaxf(x0, -x1), F(0.0));
  const float ey = fmaxf(fmaxf(y0, -y1), F(0.0));
  return (fmaxf(ex, ey) * F(0.9999847412109375) - lim) * sig >  // 1 - 2^-16
         rb * F(4.8828125e-04);                                 // 2^-11
}

// The large-table build's silhouette (silhouette_large). The host cuts the
// vertex rows [a, b, c] into chunks of SIL_ROWS rows and groups of
// GROUP_CHUNKS chunks, each with a record of SIL_F4 float4s
// (ops/walk_kernel.py::silhouette_records): the box of the float32 a, b
// and c points, widened by 2^-20 of its largest coordinate; the box of the
// b points, as they are; the oriented cone (mx, my, g): every ab = b - a
// and bc = c - b of the record (as float32 differences of its points, a
// zero one aside) has its unit direction u within |u - m| <= g (g rounded
// up, with slack; 4, which skips nothing, where the directions spread past
// |u - m| = 1, a segment is shorter than 1e-20 or none has a length). A
// lane keeps best, the least d2 so far of a vertex that passes the sign
// test, from min(3e38, dD^2 (1 + 2^-20)) (3e38 where the square root of
// that lies below dD), and skips a record where sil_skips holds: no vertex
// of it can lower best. Visited rows run silhouette's arithmetic, so
// fminf(dD, silhouette_large) equals fminf(dD, silhouette) on every input:
// a skipped vertex either fails the sign test or has d2 >= best, and fminf
// over a set of values does not depend on their order, so best ends at
// min(start, every passing d2); where that is the start dD^2 (1 + 2^-20)
// (past every passing d2), both results are dD.
//
// whether no vertex of a silhouette record (box b of its a, b, c points, box
// q of its b points, cone c) can lower best. The distance test: ex and ey
// round as a row's bpx and bpy do (its b lies in q, and rounding is
// monotone), so ex^2 + ey^2, rounded as the row's d2 is, bounds every d2 of
// the record from below, exactly. The cone test: a segment from a point a
// of the box along v = |v| u (the row's float32 edge) has cross(v, p - a) =
// |v| (cross(m, p - a) + cross(u - m, p - a)), the second term at most
// g |p - a| <= g rb (rb, the far corner's |dx| + |dy|, bounds |p - a| over
// the box), the first -f(a), f(a) = cross(m, a - p) linear over the box,
// so its corners bound it: f_lo > tol gives every segment a cross product
// below -|v| (f_lo - g rb). The row
// rounds its cross products to within 3 2^-24 |v| |p - a| + 2^-148 (each a
// difference of two rounded products of rounded differences), and the test
// its own f_lo to within 6 2^-24 rb: with tol = (g + 2^-16) rb + 1e-20 and
// |v| >= 1e-20 (a zero edge's cross product is 0), every rounded cross
// product of the record keeps that sign, so each vertex's product of its
// two is >= 0 and fails the sign test; f_hi < -tol the same on the other
// side.
__device__ __forceinline__ bool sil_skips(float4 b, float4 q, float4 c,
                                          float px, float py, float best) {
  const float ex = fmaxf(fmaxf(q.x - px, px - q.z), F(0.0));
  const float ey = fmaxf(fmaxf(q.y - py, py - q.w), F(0.0));
  if (ex * ex + ey * ey >= best) return true;
  const float x0 = b.x - px, x1 = b.z - px, y0 = b.y - py, y1 = b.w - py;
  const float rb = fmaxf(fabsf(x0), fabsf(x1)) + fmaxf(fabsf(y0), fabsf(y1));
  const float my0 = c.x * y0, my1 = c.x * y1, mx0 = c.y * x0, mx1 = c.y * x1;
  // cross(m, corner - p), over the corners
  const float f_lo = fminf(my0, my1) - fmaxf(mx0, mx1);
  const float f_hi = fmaxf(my0, my1) - fminf(mx0, mx1);
  const float tol = (c.z + F(1.52587890625e-05)) * rb + F(1e-20);  // 2^-16
  return f_lo > tol || f_hi < -tol;
}
#endif

// one Neumann row of the table form: the first-hit scan's step
__device__ __forceinline__ void hit_row(int sgi, float px, float py,
                                        float dx, float dy, float tmw,
                                        float& t_best, float& fnx,
                                        float& fny, float& hxs, float& hys) {
  const float4 g = __ldg(C.tab_neu + sgi);
  const float ax = g.x, ay = g.y;
  const float ux = g.z - ax, uy = g.w - ay;
  float wx = px - ax, wy = py - ay;
  float den = dx * uy - dy * ux;
  float den_safe = fabsf(den) < F(1e-30) ? F(1e-30) : den;
  float t = (ux * wy - uy * wx) / den_safe;
  float sp = (dx * wy - dy * wx) / den_safe;
  bool ok = sp >= F(0.0) && sp <= F(1.0) && t >= tmw && fabsf(den) > F(1e-30);
  if (ok && t < t_best) {
    t_best = t;
    const float ulen = sqrtf(fmaxf(ux * ux + uy * uy, F(1e-30)));
    fnx = -uy / ulen;
    fny = ux / ulen;
    hxs = ax + sp * ux;
    hys = ay + sp * uy;
  }
}

// closest point on the Dirichlet boundary (divide, not reciprocal):
// _closest_point_unrolled / _closest_point_smem
template <bool TABLE>
__device__ __forceinline__ float closest_point(float px, float py,
                                               float& cx, float& cy) {
  float best = F(3e38);
  cx = F(0.0);
  cy = F(0.0);
  for (int sgi = 0; sgi < C.n_dir; ++sgi) {
    float ax, ay, ux, uy, uu;
    if constexpr (TABLE) {
      const float4 g = __ldg(C.tab_dir + sgi);
      ax = g.x;
      ay = g.y;
      ux = g.z - ax;
      uy = g.w - ay;
      uu = fmaxf(ux * ux + uy * uy, F(1e-30));
    } else {
      const float* g = C.dir[sgi];
      ax = g[0];
      ay = g[1];
      ux = g[2];
      uy = g[3];
      uu = g[4];
    }
    float vx = px - ax, vy = py - ay;
    float t = fminf(fmaxf((vx * ux + vy * uy) / uu, F(0.0)), F(1.0));
    float qx = ax + t * ux, qy = ay + t * uy;
    float ex = qx - px, ey = qy - py;
    float d2 = ex * ex + ey * ey;
    if (d2 < best) { best = d2; cx = qx; cy = qy; }
  }
  return sqrtf(best);
}

// The culled closest point (the culled_closest build: the table form
// without delta tracking, phase 47's Poisson bubble, whose step is nearly
// all closest point: 93% of the one-thread loop's warp-cycles over 256
// rows a step, chip_probes/step_sites.py). The host cuts the Dirichlet rows
// into chunks of CHUNK_ROWS with a record each
// (ops/walk_kernel.py::chunk_records: the box of the rows' float32
// endpoints, widened by 2^-20 of its largest coordinate; the cone unread).
// A lane first finds the chunk of the least box_d2, then visits the chunks
// from it outward (k, k + 1, k - 1, k + 2, ...) and skips a chunk whose
// box_d2 exceeds the running minimum: its running minimum falls at the
// first chunk, and the lanes of a warp, each at its own nearest chunk,
// need their rows at the same few iterations (a warp reads ~35% of the
// rows; from each lane's last winner's chunk, which lies anywhere after a
// bank, ~71%: chip_probes/table_cull.py).
// A visited row runs closest_point's arithmetic (written out again, so
// that closest_point and the other builds keep their code), and the winner
// is the least (d2, row) pair, the full scan's first minimum in row order:
// its foot (cx, cy) and sqrtf(best) are closest_point's bit for bit.
//
// the least d2 that closest_point's rows of a chunk with box b can compute
// from p: a row's foot q = a + t u (t in [0, 1], u = b - a rounded) rounds
// to within 5 2^-24 of its largest coordinate of the segment, inside the
// widened box, so |q.x - p.x| >= ex for the box's ex, and as the row's
// differences, squares and sum round as these do (rounding is monotone),
// its d2 >= box_d2, exactly
__device__ __forceinline__ float box_d2(float4 b, float px, float py) {
  const float ex = fmaxf(fmaxf(b.x - px, px - b.z), F(0.0));
  const float ey = fmaxf(fmaxf(b.y - py, py - b.w), F(0.0));
  return ex * ex + ey * ey;
}

__device__ __forceinline__ float closest_point_culled(float px, float py,
                                                      float& cx, float& cy) {
  const int n_ch = (C.n_dir + CHUNK_ROWS - 1) / CHUNK_ROWS;
  int k0 = 0;  // the chunk of the least box_d2 (the first, on ties)
  float lb0 = F(3e38);
  for (int ch = 0; ch < n_ch; ++ch) {
    const float lb = box_d2(__ldg(C.chunk + CHUNK_F4 * ch), px, py);
    if (lb < lb0) {
      lb0 = lb;
      k0 = ch;
    }
  }
  float best = F(3e38);
  int win = -1;  // no row yet: a row must give d2 < 3e38, as in the scan
  cx = F(0.0);
  cy = F(0.0);
  for (int i = 0; i < n_ch; ++i) {
    const int o = (i + 1) >> 1;
    int ch = (i & 1) ? k0 + o : k0 - o;
    ch = ch < 0 ? ch + n_ch : (ch >= n_ch ? ch - n_ch : ch);
    if (chunk_skips(box_d2(__ldg(C.chunk + CHUNK_F4 * ch), px, py) > best))
      continue;
    const int end = min(C.n_dir, (ch + 1) * CHUNK_ROWS);
    for (int sgi = ch * CHUNK_ROWS; sgi < end; ++sgi) {
      const float4 g = __ldg(C.tab_dir + sgi);
      const float ax = g.x, ay = g.y;
      const float ux = g.z - ax, uy = g.w - ay;
      const float uu = fmaxf(ux * ux + uy * uy, F(1e-30));
      float vx = px - ax, vy = py - ay;
      float t = fminf(fmaxf((vx * ux + vy * uy) / uu, F(0.0)), F(1.0));
      float qx = ax + t * ux, qy = ay + t * uy;
      float ex = qx - px, ey = qy - py;
      float d2 = ex * ex + ey * ey;
      if (d2 < best || (d2 == best && sgi < win)) {
        best = d2;
        win = sgi;
        cx = qx;
        cy = qy;
      }
    }
  }
  return sqrtf(best);
}

// the first Neumann hit along (dx, dy) at t >= tmw: its distance (3e38 for
// none), the winning segment's CCW normal and the on-segment hit point;
// _first_hit_unrolled (reciprocal multiply, host normals) /
// _first_hit_smem (divides, normals formed in float32). The culled scan
// gives the full scan's result where the first hit lies within lim, and
// another distance past lim otherwise.
template <bool TABLE>
__device__ __forceinline__ float first_hit(float px, float py, float dx,
                                           float dy, float tmw, float lim,
                                           float& fnx, float& fny,
                                           float& hxs, float& hys) {
  float t_best = F(3e38);
  fnx = F(0.0);
  fny = F(0.0);
  hxs = F(0.0);
  hys = F(0.0);
  if constexpr (TABLE && CULLED) {
    const int n_ch = (C.n_neu + CHUNK_ROWS - 1) / CHUNK_ROWS;
#if WALK_LARGE
    const int n_grp = (n_ch + GROUP_CHUNKS - 1) / GROUP_CHUNKS;
    for (int grp = 0; grp < n_grp; ++grp) {
      const float4* gr = C.hit_group + CHUNK_F4 * grp;
      if (chunk_skips(group_skips(__ldg(gr), __ldg(gr + 1), px, py, dx, dy,
                                  tmw, lim)))
        continue;
      const int ch_end = min(n_ch, (grp + 1) * GROUP_CHUNKS);
      for (int ch = grp * GROUP_CHUNKS; ch < ch_end; ++ch) {
#else
    for (int ch = 0; ch < n_ch; ++ch) {
#endif
      const float4* rec = C.chunk + CHUNK_F4 * ch;
      if (chunk_skips(hit_skips(__ldg(rec), __ldg(rec + 1), px, py, dx, dy,
                                tmw, lim)))
        continue;
      const int end = min(C.n_neu, (ch + 1) * CHUNK_ROWS);
      for (int sgi = ch * CHUNK_ROWS; sgi < end; ++sgi)
        hit_row(sgi, px, py, dx, dy, tmw, t_best, fnx, fny, hxs, hys);
#if WALK_LARGE
      }
#endif
    }
    return t_best;
  }
  for (int sgi = 0; sgi < C.n_neu; ++sgi) {
    float ax, ay, ux, uy;
    if constexpr (TABLE) {
      const float4 g = __ldg(C.tab_neu + sgi);
      ax = g.x;
      ay = g.y;
      ux = g.z - ax;
      uy = g.w - ay;
    } else {
      const float* g = C.neu[sgi];
      ax = g[0];
      ay = g[1];
      ux = g[2];
      uy = g[3];
    }
    float wx = px - ax, wy = py - ay;
    float den = dx * uy - dy * ux;
    float den_safe = fabsf(den) < F(1e-30) ? F(1e-30) : den;
    float t, sp;
    if constexpr (TABLE) {
      t = (ux * wy - uy * wx) / den_safe;
      sp = (dx * wy - dy * wx) / den_safe;
    } else {
      float inv_den = F(1.0) / den_safe;
      t = (ux * wy - uy * wx) * inv_den;
      sp = (dx * wy - dy * wx) * inv_den;
    }
    bool ok = sp >= F(0.0) && sp <= F(1.0) && t >= tmw &&
              fabsf(den) > F(1e-30);
    if (ok && t < t_best) {
      t_best = t;
      if constexpr (TABLE) {
        const float ulen = sqrtf(fmaxf(ux * ux + uy * uy, F(1e-30)));
        fnx = -uy / ulen;
        fny = ux / ulen;
      } else {
        fnx = C.neu[sgi][4];
        fny = C.neu[sgi][5];
      }
      hxs = ax + sp * ux;
      hys = ay + sp * uy;
    }
  }
  return t_best;
}

// the nearest positive Neumann hit distance along (dx, dy), 3e38 for none:
// the step's first-hit scan reduced to its distance, for MIS's star test
template <bool TABLE>
__device__ float first_hit_t(float px, float py, float dx, float dy,
                             float tmw) {
  float fnx, fny, hxs, hys;
  return first_hit<TABLE>(px, py, dx, dy, tmw, F(3e38), fnx, fny, hxs,
                          hys);
}

// the nearest Neumann segment's unit tangent and the chord interval
// [s_lo, s_hi] keeping foot + s t_hat on it (_chord_frame_unrolled /
// _chord_frame_smem: one float32 arithmetic, formed on the host or here)
template <bool TABLE>
__device__ void chord_frame(float px, float py, float& tx, float& ty,
                            float& s_lo, float& s_hi) {
  float best = F(3e38);
  tx = F(0.0);
  ty = F(0.0);
  s_lo = F(0.0);
  s_hi = F(0.0);
  for (int sgi = 0; sgi < C.n_neu; ++sgi) {
    float ax, ay, ux, uy, uu;
    if constexpr (TABLE) {
      const float4 g = __ldg(C.tab_neu + sgi);
      ax = g.x;
      ay = g.y;
      ux = g.z - ax;
      uy = g.w - ay;
      uu = fmaxf(ux * ux + uy * uy, F(1e-30));
    } else {
      const float* g = C.chord[sgi];
      ax = g[0];
      ay = g[1];
      ux = g[2];
      uy = g[3];
      uu = g[4];
    }
    float vx = px - ax, vy = py - ay;
    float t = fminf(fmaxf((vx * ux + vy * uy) / uu, F(0.0)), F(1.0));
    float ex = (ax + t * ux) - px, ey = (ay + t * uy) - py;
    float d2 = ex * ex + ey * ey;
    if (d2 < best) {
      best = d2;
      if constexpr (TABLE) {
        const float ul = sqrtf(uu);
        tx = ux / ul;
        ty = uy / ul;
        s_lo = -t * ul;
        s_hi = (F(1.0) - t) * ul;
      } else {
        const float* g = C.chord[sgi];
        tx = g[6];
        ty = g[7];
        s_lo = -t * g[5];
        s_hi = (F(1.0) - t) * g[5];
      }
    }
  }
}

// The table chain's culled chord frame (the culled_chord build: phase
// 48's terrain over shallow bodies, where a lane that takes the chain's
// branch scans the terrain's 200 Neumann rows, and its warp with it). Its
// records are the culled_scans build's, the Neumann rows' chunks
// (ops/walk_kernel.py::chunk_records: the box of the rows' float32
// endpoints, widened by 2^-20 of its largest coordinate), its visit order
// and skip test closest_point_culled's: the chunk of the least box_d2
// first, then the chunks outward from it, a chunk skipped where its
// box_d2 exceeds the running minimum. chord_frame's row forms its foot a +
// t u and d2 as closest_point's row does, so box_d2 bounds every d2 of the
// chunk from below, exactly. The winner is the least (d2, row) pair, the
// full scan's first minimum in row order, and the frame (tangent and
// chord extents) is formed from the winning row and its t alone, by
// chord_frame's arithmetic: bit for bit chord_frame<true>.
__device__ __forceinline__ void chord_frame_culled(float px, float py,
                                                   float& tx, float& ty,
                                                   float& s_lo, float& s_hi) {
  const int n_ch = (C.n_neu + CHUNK_ROWS - 1) / CHUNK_ROWS;
  int k0 = 0;  // the chunk of the least box_d2 (the first, on ties)
  float lb0 = F(3e38);
  for (int ch = 0; ch < n_ch; ++ch) {
    const float lb = box_d2(__ldg(C.chunk + CHUNK_F4 * ch), px, py);
    if (lb < lb0) {
      lb0 = lb;
      k0 = ch;
    }
  }
  float best = F(3e38), t_win = F(0.0);
  int win = -1;  // no row yet: a row must give d2 < 3e38, as in the scan
  for (int i = 0; i < n_ch; ++i) {
    const int o = (i + 1) >> 1;
    int ch = (i & 1) ? k0 + o : k0 - o;
    ch = ch < 0 ? ch + n_ch : (ch >= n_ch ? ch - n_ch : ch);
    if (chunk_skips(box_d2(__ldg(C.chunk + CHUNK_F4 * ch), px, py) > best))
      continue;
    const int end = min(C.n_neu, (ch + 1) * CHUNK_ROWS);
    for (int sgi = ch * CHUNK_ROWS; sgi < end; ++sgi) {
      const float4 g = __ldg(C.tab_neu + sgi);
      const float ax = g.x, ay = g.y;
      const float ux = g.z - ax, uy = g.w - ay;
      const float uu = fmaxf(ux * ux + uy * uy, F(1e-30));
      float vx = px - ax, vy = py - ay;
      float t = fminf(fmaxf((vx * ux + vy * uy) / uu, F(0.0)), F(1.0));
      float ex = (ax + t * ux) - px, ey = (ay + t * uy) - py;
      float d2 = ex * ex + ey * ey;
      if (d2 < best || (d2 == best && sgi < win)) {
        best = d2;
        win = sgi;
        t_win = t;
      }
    }
  }
  tx = F(0.0);
  ty = F(0.0);
  s_lo = F(0.0);
  s_hi = F(0.0);
  if (win >= 0) {
    const float4 g = __ldg(C.tab_neu + win);
    const float ux = g.z - g.x, uy = g.w - g.y;
    const float ul = sqrtf(fmaxf(ux * ux + uy * uy, F(1e-30)));
    tx = ux / ul;
    ty = uy / ul;
    s_lo = -t_win * ul;
    s_hi = (F(1.0) - t_win) * ul;
  }
}

// distance to the nearest silhouette vertex (3e38 squared for none):
// vertex b is one seen from p when cross(ab, ap) * cross(bc, bp) < 0
// (_silhouette_unrolled with host edges / _silhouette_smem)
template <bool TABLE>
__device__ float silhouette(float px, float py) {
  float best = F(3e38);
  for (int v = 0; v < C.n_vert; ++v) {
    float axv, ayv, bxv, byv, abx, aby, bcx, bcy;
    if constexpr (TABLE) {
      const float4 g = __ldg(C.tab_vert + 2 * v);
      const float4 h = __ldg(C.tab_vert + 2 * v + 1);
      axv = g.x;
      ayv = g.y;
      bxv = g.z;
      byv = g.w;
      abx = bxv - axv;
      aby = byv - ayv;
      bcx = h.x - bxv;
      bcy = h.y - byv;
    } else {
      const float* g = C.vert[v];
      axv = g[0];
      ayv = g[1];
      bxv = g[2];
      byv = g[3];
      abx = g[4];
      aby = g[5];
      bcx = g[6];
      bcy = g[7];
    }
    const float apx = px - axv, apy = py - ayv;
    const float bpx = px - bxv, bpy = py - byv;
    const float sgn = (abx * apy - aby * apx) * (bcx * bpy - bcy * bpx);
    const float d2 = bpx * bpx + bpy * bpy;
    if (sgn < F(0.0)) best = fminf(best, d2);
  }
  return sqrtf(best);
}

#if WALK_LARGE
// the distance to the nearest silhouette vertex where it lies within dD,
// another distance >= dD otherwise (the large-table build; sil_skips):
// silhouette's table rows, by groups and chunks of rows in row order (the
// row written out again, so that silhouette and the other builds keep
// their code)
__device__ float silhouette_large(float px, float py, float dD) {
  float best = F(3e38);
  if (CHUNK_SKIP) {  // the full scan (CHUNK_SKIP false) starts at 3e38
    best = fminf(best, dD * dD * F(1.00000095367431640625));  // 1 + 2^-20
    if (!(sqrtf(best) >= dD)) best = F(3e38);
  }
  const int n_ch = (C.n_vert + SIL_ROWS - 1) / SIL_ROWS;
  const int n_grp = (n_ch + GROUP_CHUNKS - 1) / GROUP_CHUNKS;
  for (int grp = 0; grp < n_grp; ++grp) {
    const float4* gr = C.sil_group + SIL_F4 * grp;
    if (chunk_skips(sil_skips(__ldg(gr), __ldg(gr + 1), __ldg(gr + 2), px, py,
                              best)))
      continue;
    const int ch_end = min(n_ch, (grp + 1) * GROUP_CHUNKS);
    for (int ch = grp * GROUP_CHUNKS; ch < ch_end; ++ch) {
      const float4* rec = C.sil_chunk + SIL_F4 * ch;
      if (chunk_skips(sil_skips(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2),
                                px, py, best)))
        continue;
      const int end = min(C.n_vert, (ch + 1) * SIL_ROWS);
      for (int v = ch * SIL_ROWS; v < end; ++v) {
        const float4 g = __ldg(C.tab_vert + 2 * v);
        const float4 h = __ldg(C.tab_vert + 2 * v + 1);
        const float abx = g.z - g.x, aby = g.w - g.y;
        const float bcx = h.x - g.z, bcy = h.y - g.w;
        const float apx = px - g.x, apy = py - g.y;
        const float bpx = px - g.z, bpy = py - g.w;
        const float sgn = (abx * apy - aby * apx) * (bcx * bpy - bcy * bpx);
        const float d2 = bpx * bpx + bpy * bpy;
        if (sgn < F(0.0)) best = fminf(best, d2);
      }
    }
  }
  return sqrtf(best);
}
// the star radius's silhouette term in walk_step.inc
#define STAR_SILHOUETTE(px, py, dD) silhouette_large(px, py, dD)
#else
#define STAR_SILHOUETTE(px, py, dD) silhouette<TABLE>(px, py)
#endif

// distance to the nearest high-sigma' region of the local majorant, 0
// inside (majorant.py LocalMajorant.distance)
__device__ float majorant_distance(float x, float y) {
  float d = F(3e38);
  for (int b = 0; b < C.n_box; ++b) {
    const float* q = C.box[b];
    float dx = fmaxf(fmaxf(q[0] - x, x - q[1]), F(0.0));
    float dy = fmaxf(fmaxf(q[2] - y, y - q[3]), F(0.0));
    d = fminf(d, sqrtf(dx * dx + dy * dy));
  }
  for (int b = 0; b < C.n_band; ++b)
    d = fminf(d, fmaxf(C.band[b][0] - y, y - C.band[b][1]));
  return fmaxf(d, F(0.0));
}

// ---- screened-radius rejection (sampling/radial.py::_exact_rejection) --

struct Rej {
  float z, k0e_z, i0e_z;
  bool small;
};

__device__ float accept_prob(const Rej& q, float x, float s) {
  float ratio = (q.k0e_z * i0e(x)) / (q.i0e_z * k0e(x)) *
                expf(F(-2.0) * fmaxf(q.z - x, F(0.0)));
  if (q.small) {
    float k0x = k0e(x) * expf(-x);
    float num = k0x * (F(1.0) - ratio);
    float ln_s = -logf(fminf(fmaxf(s, F(1e-12)), F(1.0 - 1e-7)));
    return fminf(fmaxf(num / fmaxf(ln_s, F(1e-12)), F(0.0)), F(1.0));
  }
  return x <= q.z ? fminf(fmaxf(F(1.0) - ratio, F(0.0)), F(1.0)) : F(0.0);
}

__device__ __forceinline__ void candidate(const Rej& q, uint32_t seed,
                                          uint32_t ctr, uint32_t sid,
                                          uint32_t round, float& x, float& s,
                                          float& ua) {
  uint32_t sd = seed ^ 0xA5A5A5A5u ^ (round * 0x68E31DA4u);
  uint32_t base = hash_base(sd, ctr);
  float u0 = fmaxf(uni(base, sid, 1), F(1e-7));
  float u1 = fmaxf(uni(base, sid, 2), F(1e-7));
  float u2 = fmaxf(uni(base, sid, 3), F(1e-7));
  ua = uni(base, sid, 4);
  if (q.small) {
    s = sqrtf(u0 * u1);
    x = q.z * s;
  } else {
    x = -logf(u1 * u2) * sqrtf(fmaxf(F(1.0) - u0 * u0, F(1e-12)));
    s = x / q.z;
  }
}

// returns the radius; multiplies the importance weight into w
__device__ float screened_radius(float R, float sb, uint32_t seed,
                                 uint32_t ctr, uint32_t sid, int rounds,
                                 float& w) {
  Rej q;
  q.z = fmaxf(R * sqrtf(sb), F(1e-12));
  q.small = q.z < F(2.0);
  q.k0e_z = k0e(q.z);
  q.i0e_z = i0e(q.z);
  float p_ii = one_minus_inv_i0_scaled(q.z, q.i0e_z);
  float a_rate = fmaxf(q.small ? F(4.0) * p_ii / (q.z * q.z) : p_ii,
                       F(1e-12));
  float x, s, ua;
  candidate(q, seed, ctr, sid, 0u, x, s, ua);
  float s_round0 = s;
  float A = accept_prob(q, x, s);
  bool acc;
  float w_r;
  if (rounds == 1) {
    acc = true;  // pure importance sampling
    w_r = A / a_rate;
  } else {
    acc = ua < A;
    w_r = F(1.0);
  }
  float s_cur = s;
  // redraw round i draws stream round i + 1, as the reference loop does
  for (int i = 1; i < rounds && !acc; ++i) {
    candidate(q, seed, ctr, sid, (uint32_t)(i + 1), x, s, ua);
    A = accept_prob(q, x, s);
    bool is_final = i >= rounds - 1;
    if (ua < A || is_final) {
      s_cur = s;
      w_r = is_final ? A / a_rate : F(1.0);
      acc = true;
    }
  }
  if (q.z < F(1e-3)) {  // below any screening: round 0's unscreened draw
    s_cur = s_round0;
    w_r = F(1.0);
  }
  w = w_r;
  return fminf(fmaxf(s_cur, F(0.0)), F(1.0)) * R;
}

// screened_radius in three parts, its arithmetic in its order, for the
// chain_phases builds that queue the redraw rounds (walk_step_chain):
// round 0 on the lane (whether it accepted, the weight so far), the
// redraw rounds of a lane that rejected it on any thread (a round's draws
// depend only on seed, ctr, sid and the round), and the radius. Apart
// from screened_radius, so that the builds that call it keep their code.
__device__ __forceinline__ bool radius_round0(float R, float sb,
                                              uint32_t seed, uint32_t ctr,
                                              uint32_t sid, int rounds,
                                              Rej& q, float& a_rate,
                                              float& s_round0, float& w_r) {
  q.z = fmaxf(R * sqrtf(sb), F(1e-12));
  q.small = q.z < F(2.0);
  q.k0e_z = k0e(q.z);
  q.i0e_z = i0e(q.z);
  float p_ii = one_minus_inv_i0_scaled(q.z, q.i0e_z);
  a_rate = fmaxf(q.small ? F(4.0) * p_ii / (q.z * q.z) : p_ii, F(1e-12));
  float x, s, ua;
  candidate(q, seed, ctr, sid, 0u, x, s, ua);
  s_round0 = s;
  float A = accept_prob(q, x, s);
  if (rounds == 1) {
    w_r = A / a_rate;  // pure importance sampling
    return true;
  }
  w_r = F(1.0);
  return ua < A;
}

// the redraw rounds of a lane that rejected round 0: s and w_r of the
// first accepted (the last round always is)
__device__ __forceinline__ void radius_redraws(const Rej& q, float a_rate,
                                               uint32_t seed, uint32_t ctr,
                                               uint32_t sid, int rounds,
                                               float& s_cur, float& w_r) {
  bool acc = false;
  for (int i = 1; i < rounds && !acc; ++i) {
    float x, s, ua;
    candidate(q, seed, ctr, sid, (uint32_t)(i + 1), x, s, ua);
    float A = accept_prob(q, x, s);
    bool is_final = i >= rounds - 1;
    if (ua < A || is_final) {
      s_cur = s;
      w_r = is_final ? A / a_rate : F(1.0);
      acc = true;
    }
  }
}

__device__ __forceinline__ float radius_finish(float R, float z,
                                               float s_round0, float s_cur,
                                               float& w_r) {
  if (z < F(1e-3)) {  // below any screening: round 0's unscreened draw
    s_cur = s_round0;
    w_r = F(1.0);
  }
  return fminf(fmaxf(s_cur, F(0.0)), F(1.0)) * R;
}

// ---- the screened radius by the transport map ---------------------------
// (sampling/radial.py::sample_screened_radius_transport): one 4-uniform
// draw (the rejection's round-0 streams), loop-free. For z = R sqrt(sb) <=
// Z_SW the uniform is warped by v = sqrt(u) / (sqrt(u) + sqrt(1 - u)) and
// mapped by the Chebyshev tensor s = sum_i c_i(om) T_i(2v - 1) with
// c_i(om) = sum_j TRANSPORT_COEFFS[i][j] T_j(om), om the rational map of
// clip(z, Z_LO, Z_SW); above Z_SW the free density x K0(x) is drawn in
// closed form. The weight p(s; z) / q makes the draw exact; zero past the
// ball. The table is _transport_coeffs.py's, rounded to float32; none of
// its entries is zero, so no term is skipped (the reference skips zeros).

constexpr int T_ROWS = 29, T_COLS = 13;
constexpr double Z_LO = 0.125, Z_SW = 11.5, A_RAT = 2.0;
constexpr double OMEGA_R0 = -0.8823529411764706;
constexpr double OMEGA_R1 = 0.7037037037037037;

__constant__ float TRANSPORT_COEFFS[T_ROWS][T_COLS] = {
    {F(0.4122955638321402), F(-0.0913127502297563), F(-0.048921640016376076),
     F(-0.019124002792370358), F(-0.005885189689898357),
     F(-0.0013604293800299084), F(-0.00014394531463477863),
     F(7.897159659209051e-05), F(7.271508786789982e-05),
     F(3.9150355542520355e-05), F(1.6869724918893445e-05),
     F(5.987240182027418e-06), F(1.6779591616389803e-06)},
    {F(0.5057548884291811), F(-0.057078007215393925), F(-0.041654039137601566),
     F(-0.024543995347933518), F(-0.011671179563414479),
     F(-0.00441011154914981), F(-0.0012112324627865198),
     F(-0.00012693936199909225), F(0.00011365440360075856),
     F(0.00010411937699669413), F(5.705084874227318e-05),
     F(2.3764015177274617e-05), F(7.655302020547964e-06)},
    {F(0.08162660645782664), F(0.07224516050710338), F(0.0281097222855609),
     F(0.001168382454666556), F(-0.006223712004993117),
     F(-0.00518454049240984), F(-0.002663453606816329),
     F(-0.0009531929198168022), F(-0.00017658023621229936),
     F(5.9971146508597326e-05), F(8.374224463377842e-05),
     F(5.161078568366696e-05), F(2.3079901413162744e-05)},
    {F(-0.013839511845410022), F(0.04797848759320765), F(0.0315687339923302),
     F(0.014308163583110605), F(0.0028861974590853328),
     F(-0.0018280071768091801), F(-0.002425304244245031),
     F(-0.0015779386610221397), F(-0.0006963061806231599),
     F(-0.0001880249540515673), F(1.5599151604429667e-05),
     F(5.4145628469233405e-05), F(4.006275745006581e-05)},
    {F(0.00196914509231458), F(0.012558100282862243), F(0.014831615503245516),
     F(0.012192909533870422), F(0.0066673740094005405),
     F(0.0019324201495177391), F(-0.00054499645588974),
     F(-0.001178152193227937), F(-0.0009153812436833937),
     F(-0.0004795122364855092), F(-0.00016271288719647823),
     F(-1.5212117847224261e-05), F(2.8545061363255225e-05)},
    {F(0.006605933657157238), F(0.004880526533258869), F(0.006240704717554571),
     F(0.00671110485679959), F(0.00548449353344198), F(0.0032180670845165958),
     F(0.001107298724584406), F(-0.00016300309094347774),
     F(-0.0005935403941263842), F(-0.0005320791064506267),
     F(-0.0003140357969767726), F(-0.0001280852030640131),
     F(-2.489806954264398e-05)},
    {F(0.0030459798511850863), F(0.0043974680729636775),
     F(0.0037892264638562595), F(0.003610625007611811),
     F(0.003398380093172581), F(0.0027008299229199103),
     F(0.001630469931488112), F(0.0006180733156150832),
     F(-4.6868094049169154e-05), F(-0.00030741539617466416),
     F(-0.00030865803395473286), F(-0.0001961705804499046),
     F(-8.857776608524765e-05)},
    {F(0.0009277019627464414), F(0.003104760506772956),
     F(0.0026795715271798705), F(0.002319521886667974),
     F(0.0020855473019983925), F(0.001839771595223631),
     F(0.0014129278495536779), F(0.0008694451178750872),
     F(0.00034418895519004354), F(-1.5435346494936804e-06),
     F(-0.00016464631303744875), F(-0.00016967552586531212),
     F(-0.00011569632223601577)},
    {F(0.0007531248460531221), F(0.0016220306073074825),
     F(0.0016505749965357863), F(0.001554857352111099),
     F(0.0013854707366958905), F(0.0012297786731457682),
     F(0.0010338062679196244), F(0.0007842684969187691),
     F(0.00047638776229403653), F(0.00020651181349635816),
     F(6.3131137437157845e-06), F(-7.851156355889612e-05),
     F(-9.135520801400428e-05)},
    {F(0.0005173841399357102), F(0.0009353614839552292),
     F(0.0009659911181087223), F(0.0009727044517244439),
     F(0.0009187837708345736), F(0.000836981492966692),
     F(0.0007291427725706527), F(0.0006062180557538889),
     F(0.00044503455871393213), F(0.000278276238701986),
     F(0.00011966675610811414), F(1.5182300148667144e-05),
     F(-3.8400686247790214e-05)},
    {F(0.0003138435836507451), F(0.0005578314889279265),
     F(0.0005617661034443612), F(0.0005771408897902722),
     F(0.0005787802079655444), F(0.00055557571724206),
     F(0.0005067047631355396), F(0.0004419709445324487),
     F(0.0003585725006308238), F(0.0002629690597326722),
     F(0.00016114551398409215), F(7.33257704756994e-05),
     F(1.1550091327205562e-05)},
    {F(0.0001355224541772256), F(0.0003269420952600649),
     F(0.0003256333730824417), F(0.00033124058627261765),
     F(0.00034467402489334563), F(0.000348105968851823),
     F(0.00033847862586465954), F(0.0003093433497540665),
     F(0.0002692431994438712), F(0.0002145190340525794),
     F(0.00015572846488993433), F(9.328177627235625e-05),
     F(4.185679825795719e-05)},
    {F(8.135331546120023e-05), F(0.00014680981394291537),
     F(0.00016388613347864236), F(0.0001764524427814556),
     F(0.00019365063917441548), F(0.00020405851896260977),
     F(0.00021276610377939545), F(0.00020512619736365133),
     F(0.0001914349117756912), F(0.0001614972967255595),
     F(0.00013016934822094843), F(8.914283700823234e-05),
     F(5.2541610033002585e-05)},
    {F(2.0991901131402028e-05), F(5.6004740033014375e-05),
     F(6.674507404282534e-05), F(7.739667145602427e-05),
     F(9.583871496882301e-05), F(0.0001084466809820612),
     F(0.00012365963602374003), F(0.0001267380576474192),
     F(0.0001279587639484048), F(0.00011403722373677849),
     F(9.981494011190948e-05), F(7.444329619849902e-05),
     F(5.066701070792666e-05)},
    {F(3.5548036298271753e-06), F(-6.488768504500918e-06),
     F(5.773587282652752e-06), F(1.6717279705738713e-05),
     F(3.421787568131581e-05), F(4.684476058729273e-05),
     F(6.326454628099137e-05), F(7.08487719626553e-05),
     F(7.909944045729406e-05), F(7.50730662712064e-05),
     F(7.129789866684799e-05), F(5.701915404906402e-05),
     F(4.284636146850693e-05)},
    {F(-2.1553992672435735e-05), F(-3.190871607716248e-05),
     F(-2.5265412259842874e-05), F(-1.8003397599610584e-05),
     F(-3.402350244773857e-06), F(8.302008902985011e-06),
     F(2.3812994220799857e-05), F(3.290735771637773e-05),
     F(4.3581121698817434e-05), F(4.508202349954959e-05),
     F(4.717618418252233e-05), F(4.05031554030979e-05),
     F(3.3139293104454874e-05)},
    {F(-2.1390304584607624e-05), F(-5.0797900675293104e-05),
     F(-4.292327192224656e-05), F(-3.585376086801358e-05),
     F(-2.407301106812109e-05), F(-1.4193446720720575e-05),
     F(-8.222773585750967e-07), F(8.279444533676132e-06),
     F(1.905370812982598e-05), F(2.3319809420235605e-05),
     F(2.8230087485493685e-05), F(2.645357617439672e-05),
     F(2.36672584067662e-05)},
    {F(-2.9430630510270816e-05), F(-5.187789412715496e-05),
     F(-4.7960405282608636e-05), F(-4.32683753106967e-05),
     F(-3.422212800087129e-05), F(-2.6012664615882773e-05),
     F(-1.5060272777036352e-05), F(-6.747915618276559e-06),
     F(2.985766072107678e-06), F(8.379977152173557e-06),
     F(1.4252537877490156e-05), F(1.538214015258537e-05),
     F(1.544995859143608e-05)},
    {F(-2.388928568717023e-05), F(-5.311143603528577e-05),
     F(-4.867228785390872e-05), F(-4.42089111007088e-05),
     F(-3.733246695247395e-05), F(-3.0801906488065626e-05),
     F(-2.2243918459362347e-05), F(-1.5066388356753482e-05),
     F(-6.835189514594142e-06), F(-1.2606831454341887e-06),
     F(4.542393749746402e-06), F(7.213632791994044e-06),
     F(8.885257412310999e-06)},
    {F(-2.555661426219791e-05), F(-4.609010218938124e-05),
     F(-4.431171752332099e-05), F(-4.14944518332895e-05),
     F(-3.6530811321055e-05), F(-3.1322335166278747e-05),
     F(-2.4800540690074944e-05), F(-1.8832332265907542e-05),
     F(-1.2203793417603542e-05), F(-6.983523688897414e-06),
     F(-1.7724820810490829e-06), F(1.5552242829827028e-06),
     F(3.986374684098894e-06)},
    {F(-1.912723470230414e-05), F(-4.183566383496159e-05),
     F(-3.9539612299908084e-05), F(-3.6833568406222356e-05),
     F(-3.3271243967536034e-05), F(-2.928419274211118e-05),
     F(-2.4495124701581846e-05), F(-1.966866225254723e-05),
     F(-1.4521266741066074e-05), F(-9.917393266470778e-06),
     F(-5.516573787238417e-06), F(-2.084151680864296e-06),
     F(5.691881605037287e-07)},
    {F(-1.8654293718561688e-05), F(-3.363654725892615e-05),
     F(-3.307004118994532e-05), F(-3.145841146177557e-05),
     F(-2.9050365022658094e-05), F(-2.5972217702171114e-05),
     F(-2.2529429245291916e-05), F(-1.8718771503969576e-05),
     F(-1.4853964064095092e-05), F(-1.0962664040544871e-05),
     F(-7.4107007954996e-06), F(-4.193315832088815e-06),
     F(-1.6375585585350915e-06)},
    {F(-1.3077186450231607e-05), F(-2.868890685023543e-05),
     F(-2.759873735645174e-05), F(-2.6001491709891534e-05),
     F(-2.4379942193379335e-05), F(-2.210657249314352e-05),
     F(-1.9734956208069655e-05), F(-1.679054504406264e-05),
     F(-1.3975000279227949e-05), F(-1.0792026675301104e-05),
     F(-8.030237689229987e-06), F(-5.193692127114884e-06),
     F(-2.9081026187843492e-06)},
    {F(-1.2246617352839989e-05), F(-2.175821057982777e-05),
     F(-2.179333502993729e-05), F(-2.0931872565125585e-05),
     F(-1.9939563171248375e-05), F(-1.8236474471744144e-05),
     F(-1.6643956857945356e-05), F(-1.4417584089970612e-05),
     F(-1.2436676699531985e-05), F(-9.906401869994493e-06),
     F(-7.830366524091632e-06), F(-5.437942865003471e-06),
     F(-3.497210029084182e-06)},
    {F(-7.95074509362946e-06), F(-1.7788891480516228e-05),
     F(-1.7312283371759048e-05), F(-1.6401759127232034e-05),
     F(-1.5803085205604492e-05), F(-1.4599157368640324e-05),
     F(-1.3598595105093758e-05), F(-1.1951866848591171e-05),
     F(-1.060837085936084e-05), F(-8.648981526790242e-06),
     F(-7.140354283602369e-06), F(-5.194799198113228e-06),
     F(-3.613239395454767e-06)},
    {F(-7.367457133487195e-06), F(-1.2687618179958078e-05),
     F(-1.2958453509751354e-05), F(-1.2545997420158715e-05),
     F(-1.2257924997854284e-05), F(-1.1388921307666401e-05),
     F(-1.0790995376340115e-05), F(-9.603578615699492e-06),
     F(-8.737975429238669e-06), F(-7.26053652469266e-06),
     F(-6.203958497795862e-06), F(-4.67133400886351e-06),
     F(-3.427371459399085e-06)},
    {F(-4.269924822682888e-06), F(-1.0015059800623368e-05),
     F(-9.817937095073476e-06), F(-9.320820832707081e-06),
     F(-9.201268151664892e-06), F(-8.62692042143497e-06),
     F(-8.3229808572866e-06), F(-7.491649259911036e-06),
     F(-6.96995902671221e-06), F(-5.886956173689816e-06),
     F(-5.179181855123432e-06), F(-4.009295544413228e-06),
     F(-3.063714030033315e-06)},
    {F(-4.05210543133868e-06), F(-6.5649268190509935e-06),
     F(-6.88401790762521e-06), F(-6.728156192072405e-06),
     F(-6.743433422253763e-06), F(-6.351848272558447e-06),
     F(-6.229355576151122e-06), F(-5.669573674201066e-06),
     F(-5.391280563878449e-06), F(-4.6232343188871326e-06),
     F(-4.176427001956394e-06), F(-3.311488876067032e-06),
     F(-2.6173875451152284e-06)},
    {F(-1.9050075422330537e-06), F(-5.0064502739847315e-06),
     F(-4.9178435403614126e-06), F(-4.661260921392551e-06),
     F(-4.7289618565910135e-06), F(-4.502667336599595e-06),
     F(-4.50686660445722e-06), F(-4.149310706735681e-06),
     F(-4.034001823431987e-06), F(-3.5111898269170954e-06),
     F(-3.2537494092868586e-06), F(-2.637858693219596e-06),
     F(-2.1485041418600213e-06)}
};

__device__ float transport_radius(float R, float sb, uint32_t seed,
                                  uint32_t ctr, uint32_t sid, float& w) {
  const float z = fmaxf(R * sqrtf(sb), F(1e-12));
  const uint32_t base = hash_base(seed ^ 0xA5A5A5A5u, ctr);
  const float u = fminf(fmaxf(uni(base, sid, 1), F(1e-7)), F(1.0 - 1e-7));

  // the map at z_eff = clip(z, Z_LO, Z_SW)
  const float z_eff = fminf(fmaxf(z, F(Z_LO)), F(Z_SW));
  const float om = F(2.0) * ((z_eff - F(A_RAT)) / (z_eff + F(A_RAT)) -
                             F(OMEGA_R0)) /
                       F(OMEGA_R1 - OMEGA_R0) -
                   F(1.0);
  const float su = sqrtf(u);
  const float cu = sqrtf(F(1.0) - u);
  const float v = su / (su + cu);
  const float tv = F(2.0) * v - F(1.0);
  float tw[T_COLS];  // T_j(om)
  tw[0] = F(1.0);
  tw[1] = om;
#pragma unroll
  for (int j = 2; j < T_COLS; ++j)
    tw[j] = F(2.0) * om * tw[j - 1] - tw[j - 2];
  // c_i in row order, each folded into s = sum c_i T_i(tv) and S'(v) =
  // 2 sum c_i i U_{i-1}(tv) as soon as it is formed (the T/U recurrences)
  float c[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i] = TRANSPORT_COEFFS[i][0] + TRANSPORT_COEFFS[i][1] * om;
#pragma unroll
    for (int j = 2; j < T_COLS; ++j)
      c[i] = c[i] + TRANSPORT_COEFFS[i][j] * tw[j];
  }
  float t_prev = F(1.0), t_cur = tv;
  float u_prev = F(1.0), u_cur = F(2.0) * tv;
  float s_t = c[0] + c[1] * tv;
  float ds = c[1];
#pragma unroll
  for (int i = 2; i < T_ROWS; ++i) {
    float ci = TRANSPORT_COEFFS[i][0] + TRANSPORT_COEFFS[i][1] * om;
#pragma unroll
    for (int j = 2; j < T_COLS; ++j)
      ci = ci + TRANSPORT_COEFFS[i][j] * tw[j];
    const float t_next = F(2.0) * tv * t_cur - t_prev;
    t_prev = t_cur;
    t_cur = t_next;
    s_t = s_t + ci * t_cur;
    ds = ds + ((float)i * ci) * u_cur;
    const float u_next = F(2.0) * tv * u_cur - u_prev;
    u_prev = u_cur;
    u_cur = u_next;
  }
  ds = F(2.0) * ds;
  const float w1 = v * v + (F(1.0) - v) * (F(1.0) - v);
  const float mp = F(2.0) * v * (F(1.0) - v) / (w1 * w1);

  // the free density's exact draw (z > Z_SW)
  const float u1 = fmaxf(uni(base, sid, 2), F(1e-7));
  const float u2 = fmaxf(uni(base, sid, 3), F(1e-7));
  const float u0 = uni(base, sid, 4);
  const float x_f =
      -logf(u1 * u2) * sqrtf(fmaxf(F(1.0) - u0 * u0, F(1e-12)));
  const bool use_f = z > F(Z_SW);
  const float s_raw = use_f ? x_f / z : s_t;

  // the exact importance weight
  const bool invalid = s_raw >= F(1.0);
  const float s = fminf(fmaxf(s_raw, F(1e-7)), F(1.0));
  const float x = z * s;
  const float i0e_z = i0e(z), k0e_z = k0e(z);
  const float i0e_x = i0e(x), k0e_x = k0e(x);
  const float ratio = (k0e_z * i0e_x) / (i0e_z * k0e_x) *
                      expf(F(-2.0) * fmaxf(z - x, F(0.0)));
  const float one_m_ratio = fmaxf(F(1.0) - ratio, F(0.0));
  const float norm = fmaxf(one_minus_inv_i0_scaled(z, i0e_z), F(1e-30));
  const float w_f = one_m_ratio / norm;
  const float k0x = k0e_x * expf(-x);
  const float p = z * z * s * k0x * one_m_ratio / norm;
  const float w_t = p * ds / fmaxf(mp, F(1e-30));
  w = invalid ? F(0.0) : (use_f ? w_f : w_t);
  return s * R;
}

// ---- source-directed MIS next-event estimation ---------------------------

// mixture component c, column k: the narrow table or the wide form's
template <bool WIDE>
__device__ __forceinline__ float mix_at(int c, int k) {
  return WIDE ? C.wmix[c][k] : C.mix[c][k];
}

// y from 0.5 ball-Green's + 0.5 the static Gaussian mixture, weighted by
// the balance heuristic (pallas_walk.py:932-997), before the alpha factor
// and the walk weight; (gx, gy) is the Green's draw. The component pick is
// the unrolled rule idx = #{i < k-1 : u6 > cum_i}. With delta tracking the
// ball's screened Green's function and its norm, without it ln(R/r) /
// (2 pi) and R^2 / 4 (:956-961)
//
// DEALT (the dealt loop's exact savings in the survey's MIS build) takes
// the screened norm from the caller (norm_in: interior_prob / sb, the
// operations of screened_norm) and the Box-Muller pair from one sincosf
// (on the card the bits of cosf and sinf for every float in [0, 2 pi]:
// chip_probes/sincos_bits.py). Without delta tracking (the one_sincos
// build with MIS, phase 49's narrow source) it takes only the pair: the
// norm there is R^2 / 4, one product.
//
// NEAR (the chain_phases builds with MIS) sums the mixture pdf over the
// components near y only: a component with |y - c|^2 > 128 (2 w^2) has an
// exponent of -128 or less, whose expf is +0 on the card (chip_probes/
// chain_phases_ab.py checks every float at or below -128), so its term is
// +0 and leaving it out changes no bit of q; the others add in component
// order. A lane evaluates its own near components (a few of 19 on the
// notebook line), not those of the whole warp.
template <bool DELTA, bool TABLE, bool WIDE, bool NEAR = false,
          bool DEALT = false>
__device__ __forceinline__ float mis_nee(uint32_t base, uint32_t sid,
                                         float px, float py, float gx,
                                         float gy, float r, float sbar,
                                         bool ob, float t_min, float& yx,
                                         float& yy, float norm_in = F(0.0)) {
  const float u5 = uni(base, sid, 5), u6 = uni(base, sid, 6);
  const float u7 = uni(base, sid, 7), u8 = uni(base, sid, 8);
  float mx = mix_at<WIDE>(0, 0), my = mix_at<WIDE>(0, 1);
  float mw = mix_at<WIDE>(0, 2);
  for (int ci = 1; ci < C.n_mix; ++ci) {
    if (u6 > mix_at<WIDE>(ci - 1, 4)) {
      mx = mix_at<WIDE>(ci, 0);
      my = mix_at<WIDE>(ci, 1);
      mw = mix_at<WIDE>(ci, 2);
    }
  }
  const float rad = sqrtf(F(-2.0) * logf(fmaxf(u7, F(1e-12))));
  const float ang = F(TWO_PI) * u8;
  if constexpr (DEALT) {
    float s_ang, c_ang;
    sincosf(ang, &s_ang, &c_ang);
    mx = mx + mw * rad * c_ang;
    my = my + mw * rad * s_ang;
  } else {
    mx = mx + mw * rad * cosf(ang);
    my = my + mw * rad * sinf(ang);
  }
  const bool take_src = u5 < F(0.5);
  yx = take_src ? mx : gx;
  yy = take_src ? my : gy;
  const float ex = yx - px, ey = yy - py;
  const float d_y = sqrtf(ex * ex + ey * ey);
  const float d_safe = fmaxf(d_y, F(1e-12));
  float g_val, norm;
  if constexpr (DELTA) {
    g_val = fmaxf(screened_greens(d_safe, r, sbar), F(0.0));
    norm = DEALT ? norm_in : screened_norm(r, sbar);
  } else {
    g_val = fmaxf(logf(r / fmaxf(d_safe, F(1e-12))) / F(TWO_PI), F(0.0));
    norm = r * r / F(4.0);
  }
  const bool in_ball = d_y < r;
  bool in_star = in_ball;
  if (C.n_neu > 0)  // a wall between x and y blocks the sample
    in_star = in_ball &&
              !(first_hit_t<TABLE>(px, py, ex / d_safe, ey / d_safe,
                                   ob ? t_min : F(0.0)) < d_y);
  float q = F(0.0);  // the mixture pdf, one expf per component
  if constexpr (NEAR) {
    unsigned long long near = 0ull;
    for (int ci = 0; ci < C.n_mix; ++ci) {
      const float qx = yx - mix_at<WIDE>(ci, 0), qy = yy - mix_at<WIDE>(ci, 1);
      if (!(qx * qx + qy * qy > F(128.0) * mix_at<WIDE>(ci, 5)))
        near |= 1ull << ci;
    }
    while (near) {
      const int ci = __ffsll((long long)near) - 1;
      near &= near - 1ull;
      const float qx = yx - mix_at<WIDE>(ci, 0), qy = yy - mix_at<WIDE>(ci, 1);
      q = q + mix_at<WIDE>(ci, 3) * expf(-(qx * qx + qy * qy) /
                                         mix_at<WIDE>(ci, 5)) /
                  mix_at<WIDE>(ci, 6);
    }
  } else {
    for (int ci = 0; ci < C.n_mix; ++ci) {
      const float qx = yx - mix_at<WIDE>(ci, 0), qy = yy - mix_at<WIDE>(ci, 1);
      q = q + mix_at<WIDE>(ci, 3) * expf(-(qx * qx + qy * qy) /
                                         mix_at<WIDE>(ci, 5)) /
                  mix_at<WIDE>(ci, 6);
    }
  }
  // an on-boundary walker samples a hemisphere: double its density
  const float m_ob = ob ? F(2.0) : F(1.0);
  const float p_ball = in_ball ? m_ob * g_val / norm : F(0.0);
  const float p_mix = F(0.5) * p_ball + F(0.5) * q;
  return (in_star && p_mix > F(1e-30)) ? m_ob * g_val / fmaxf(p_mix, F(1e-30))
                                       : F(0.0);
}

// ---- the walk ------------------------------------------------------------

// NEE: every source at (x, y) times the weight w, added to its
// accumulator. The narrow form unrolls its MAX_SRC sources over
// registers; the wide form loops over its sources at run time and adds to
// their planes in place (unrolled over 32 sources, with the accumulators
// in registers or in the planes, the wide instantiations took 228-255
// registers a thread, and spilled)
template <bool TERMS, bool WIDE>
__device__ __forceinline__ void add_sources(float (&acc)[MAX_SRC], int lane,
                                            int n_src, float x, float y,
                                            float w) {
  if constexpr (WIDE) {
#pragma unroll 1
    for (int i = 0; i < n_src; ++i)
      C.wacc[i][lane] =
          C.wacc[i][lane] + source_value<TERMS, true>(i, x, y) * w;
  } else {
#pragma unroll
    for (int i = 0; i < MAX_SRC; ++i)
      if (i < n_src)
        acc[i] = acc[i] + field_value<TERMS>(F_SRC0 + i, x, y) * w;
  }
}

// the dealt loop's wide form: a walk's accumulators in the block's shared
// memory, source i at p[i * THREADS] (one row a thread), in place of the
// planes' global read-modify-writes; the same adds in the same order
struct SharedRow {
  float* p;
};

template <bool TERMS, bool WIDE>
__device__ __forceinline__ void add_sources(SharedRow acc, int, int n_src,
                                            float x, float y, float w) {
#pragma unroll 1
  for (int i = 0; i < n_src; ++i)
    acc.p[i * THREADS] =
        acc.p[i * THREADS] + source_value<TERMS, true>(i, x, y) * w;
}

// ---- the freeze builds' repack loop ----------------------------------------

// one walker lane's state: registers while a thread steps it; the repack
// loop moves it between threads through shared memory
struct Lane {
  float px, py, nx, ny, atten;
  float acc[MAX_SRC], asum[MAX_SRC], asq[MAX_SRC];  // the narrow form's
  int quota, steps, ndone, life;
  bool ob;
  float tn, tw, wmax, bmax;
  float a_cur, a_p0;  // the alpha cache of delta tracking
  uint32_t sid;
  float p0x, p0y;     // the walk's start,
  bool ob0;           // and its boundary-snap start
  float n0x, n0y;
  int lane;           // the lane's plane index
  int it;             // iterations taken in this launch
};

// the launch's constants of the step
struct Launch {
  int n_src;
  uint32_t seed;  // a launch of one shard: its seed
  bool snap;
  float eps, rmin, t_min, sigma_bar;
  int max_steps;
  float freeze_thr;
};

// a lane's planes into registers (a lane with quota)
template <bool DELTA, bool TERMS, bool WIDE>
__device__ __forceinline__ void load_lane(Lane& L, int lane, int quota,
                                          const Launch& K) {
  const Planes& P = C.pl;
  L.lane = lane;
  L.it = 0;
  L.quota = quota;
  L.sid = (uint32_t)P.sid[lane];
  L.p0x = P.p0x[lane];
  L.p0y = P.p0y[lane];
  L.ob0 = K.snap ? P.ob0[lane] != 0 : false;
  L.n0x = K.snap ? P.n0x[lane] : F(0.0);
  L.n0y = K.snap ? P.n0y[lane] : F(0.0);
  L.px = P.px[lane];
  L.py = P.py[lane];
  L.nx = P.nx[lane];
  L.ny = P.ny[lane];
  L.atten = P.atten[lane];
  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < MAX_SRC; ++i) {
      L.acc[i] = i < K.n_src ? P.acc[i][lane] : F(0.0);
      L.asum[i] = i < K.n_src ? P.asum[i][lane] : F(0.0);
      L.asq[i] = i < K.n_src ? P.asq[i][lane] : F(0.0);
    }
  }
  L.steps = P.steps[lane];
  L.ndone = P.ndone[lane];
  L.life = P.life[lane];
  L.ob = P.ob[lane] != 0;
  L.tn = P.tn[lane];
  L.tw = P.tw[lane];
  L.wmax = P.wmax[lane];
  L.bmax = P.bmax[lane];
  L.a_p0 = F(0.0);
  L.a_cur = F(0.0);
  if constexpr (DELTA) {
    L.a_p0 = alpha_c<TERMS>(L.p0x, L.p0y);
    L.a_cur = alpha_c<TERMS>(L.px, L.py);
  }
}

// a lane's registers back into its planes
template <bool WIDE>
__device__ __forceinline__ void store_lane(const Lane& L, int n_src) {
  const Planes& P = C.pl;
  const int lane = L.lane;
  P.px[lane] = L.px;
  P.py[lane] = L.py;
  P.nx[lane] = L.nx;
  P.ny[lane] = L.ny;
  P.atten[lane] = L.atten;
  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < MAX_SRC; ++i) {
      if (i < n_src) {
        P.acc[i][lane] = L.acc[i];
        P.asum[i][lane] = L.asum[i];
        P.asq[i][lane] = L.asq[i];
      }
    }
  }
  P.quota[lane] = L.quota;
  P.steps[lane] = L.steps;
  P.ndone[lane] = L.ndone;
  P.ob[lane] = L.ob ? 1 : 0;
  P.life[lane] = L.life;
  P.tn[lane] = L.tn;
  P.tw[lane] = L.tw;
  P.wmax[lane] = L.wmax;
  P.bmax[lane] = L.bmax;
}

// one iteration of a lane (walk_step.inc); false when the lane freezes:
// it stays as it is for the rest of the launch
template <int ROBIN, bool MAJ, bool MIS, bool TABLE, bool DELTA,
          bool TRANSPORT, bool WIDE, bool GRID, bool TERMS, bool SHARDS>
__device__ __forceinline__ bool walk_step(Lane& L, const Launch& K) {
  constexpr bool FREEZE = true;
  float &px = L.px, &py = L.py, &nx = L.nx, &ny = L.ny, &atten = L.atten;
  float(&acc)[MAX_SRC] = L.acc;
  float(&asum)[MAX_SRC] = L.asum;
  float(&asq)[MAX_SRC] = L.asq;
  int &quota = L.quota, &steps = L.steps, &ndone = L.ndone, &life = L.life;
  bool& ob = L.ob;
  float &tn = L.tn, &tw = L.tw, &wmax = L.wmax, &bmax = L.bmax;
  float& a_cur = L.a_cur;
  const float a_p0 = L.a_p0;
  [[maybe_unused]] const int lane = L.lane;
  const uint32_t sid = L.sid;
  const float p0x = L.p0x, p0y = L.p0y;
  const bool ob0 = L.ob0;
  const float n0x = L.n0x, n0y = L.n0y;
  const int n_src = K.n_src;
  const uint32_t seed = SHARDS ? lane_seed(L.lane) : K.seed;
  const bool snap = K.snap;
  const float eps = K.eps, rmin = K.rmin, t_min = K.t_min;
  const float sigma_bar = K.sigma_bar;
  const int max_steps = K.max_steps;
  const float freeze_thr = K.freeze_thr;
#define WALK_NEXT return true
#define WALK_FROZEN return false
#include "walk_step.inc"
#undef WALK_NEXT
#undef WALK_FROZEN
  return true;
}

// ---- the chain_phases builds' step: the chain's wall work in full warps --

// site (a), on a lane standing on the wall: the Robin chord mass
// c = 4 gamma J(r), the radius r shrunk until |c| <= 1/2 (walk_step.inc's
// arithmetic, for the chain)
template <bool TERMS>
__device__ __forceinline__ void chord_mass(float px, float py, float nx,
                                           float ny, float rmin, float sbar,
                                           float& r, float& c_mag) {
  float glx0, gly0;
  grad_log_alpha<TERMS>(px, py, glx0, gly0);
  const float gamma0 = F(-0.5) * (nx * glx0 + ny * gly0);
  const float g_eff = fmaxf(fabsf(gamma0), C.gamma_floor);
  float chord_j = chord_integral(r, sbar);
  c_mag = F(4.0) * g_eff * chord_j;
  for (int k = 0; k < 4; ++k) {
    if (c_mag > F(0.5)) {
      r = fmaxf(rmin, r * (F(0.5) / fmaxf(c_mag, F(1e-12))));
      chord_j = chord_integral(r, sbar);
      c_mag = F(4.0) * g_eff * chord_j;
    }
  }
  c_mag = fminf(c_mag, F(0.9));
}

// site (b), on a lane that reaches the wall at (hx, hy) with the inward
// normal (hnx, hny): the Robin wall-arrival factor 1 + gamma rho / cos(phi)
template <bool TERMS>
__device__ __forceinline__ float arrival_factor(float hx, float hy,
                                                float hnx, float hny,
                                                float dx, float dy,
                                                float t_hit, float r,
                                                float sbar) {
  float glx, gly;
  grad_log_alpha<TERMS>(hx, hy, glx, gly);
  const float gamma = F(-0.5) * (hnx * glx + hny * gly);
  const float cosphi = fmaxf(-(dx * hnx + dy * hny), C.arrival_clamp);
  const float rho = wall_ratio(t_hit, r, sbar);
  return F(1.0) + gamma * rho / cosphi;
}

// site (c), on a wall lane that branches: the chord continuation to
// z = x + zeta t_hat with the weight 2 gamma(z) G_s / p_mix / q; returns
// the lane's new atten, z and alpha(z)
template <bool TABLE, bool TERMS>
__device__ __forceinline__ void chord_branch(float px, float py, float nx,
                                             float ny, float r, float sbar,
                                             uint32_t base, uint32_t sid,
                                             float a_p, float atten_pre,
                                             float q_c, float& atten,
                                             float& zx, float& zy,
                                             float& a_z) {
  const float u10 = uni(base, sid, 10), u11 = uni(base, sid, 11);
  const float q_scr = sqrtf(fmaxf(sbar, F(1e-12)));
  const float side = u10 < F(0.5) ? F(-1.0) : F(1.0);
  const float v = fabsf(F(2.0) * u10 - F(1.0));
  const float u2 = fabsf(F(2.0) * u11 - F(1.0));
  const float z_log = r * fmaxf(v * u2, F(1e-12));
  const float trunc = F(1.0) - expf(-q_scr * r);
  const float z_exp = -logf(fmaxf(F(1.0) - v * trunc, F(1e-12))) / q_scr;
  const float az = fminf(u11 < F(0.5) ? z_log : z_exp, r);
  const float zeta = side * az;
  const float p_log = -logf(fmaxf(az / r, F(1e-12))) / (F(2.0) * r);
  const float p_exp =
      q_scr * expf(-q_scr * az) / (F(2.0) * fmaxf(trunc, F(1e-12)));
  const float p_mix = F(0.5) * (p_log + p_exp);
  const float g_ch = fmaxf(screened_greens(az, r, sbar), F(0.0));
  float t_cx, t_cy, s_lo, s_hi;
  chord_frame<TABLE>(px, py, t_cx, t_cy, s_lo, s_hi);
  zx = px + zeta * t_cx;
  zy = py + zeta * t_cy;
  float glxz, glyz;
  grad_log_alpha<TERMS>(zx, zy, glxz, glyz);
  const float gamma_z = F(-0.5) * (nx * glxz + ny * glyz);
  a_z = alpha_c<TERMS>(zx, zy);
  float w_ch = F(2.0) * gamma_z * g_ch / fmaxf(p_mix, F(1e-30)) *
               sqrtf(a_z / a_p);
  if (!(zeta >= s_lo && zeta <= s_hi)) w_ch = F(0.0);
  atten = atten_pre * w_ch / fmaxf(q_c, F(1e-6));
}

// the block's queue of wall work, in the repack loop's stash (free within
// a step): entry k in column k. Rows 0-5 hold the chord mass's entries
// (x, n, r, sigma_bar in; r and c out in rows 4 and 5); rows 6-14 and the
// two int rows the second queue's: the branches from column 0 up (x, n,
// r, sigma_bar, alpha_p, atten, q and the hash base and stream in; atten,
// z and alpha_z out in rows 6-9), the arrivals from the last column down
// (the hit, its normal, the direction, t_hit, r, sigma_bar in; the
// factor out in row 6); rows 15-18 and int rows 2-5 the redraw queue's
// (walk_step_chain, the builds without MIS and the majorant). Each
// counter is zeroed after the barrier that ends its queue's work, and
// taken again only after another queue's first barrier.
struct WallQueue {
  float (*f)[REPACK_THREADS];
  int (*w)[REPACK_THREADS];
  unsigned int* n;  // chord masses, branches, arrivals
};

// the queues' three counters (a template: only the chain_phases builds
// hold them)
template <bool>
__device__ __forceinline__ unsigned int* wall_counts() {
  __shared__ unsigned int n[3];
  return n;
}

// the chain_phases builds that queue the rejection sampler's redraw
// rounds (walk_step_chain): those without MIS, the transport map and the
// majorant
__host__ __device__ constexpr bool redraw_queued(bool maj, bool mis,
                                                  bool transport) {
  return !maj && !mis && !transport;
}

// the redraw queue's counter (only the redraw_queued builds hold it)
template <bool>
__device__ __forceinline__ unsigned int& redraw_count() {
  __shared__ unsigned int n;
  return n;
}
static_assert(LANE_FLOATS >= 19 && LANE_INTS >= 6, "the queues' rows");

// One iteration of a lane of a chain_phases build: walk_step.inc's
// iteration for the chain with delta tracking, with MIS or without, and
// without the freeze, in three phases that every thread of the block runs,
// with or without a lane (`on`) and whether or not its lane banks. A lane
// that stands on the wall queues its chord mass after the first; one that
// branches queues its chord branch, and one that reaches the wall without
// branching its arrival factor, after the second; the block's threads then
// run the queued entries, one a thread, so the wall work that one lane in
// a warp used to hold the whole warp for runs in full warps. Without MIS,
// the transport map and the majorant, where the rejection sampler runs
// more than two rounds, a lane whose screened radius rejected its round-0
// draw queues its redraw rounds too, between the chord mass and the
// second phase. Every entry runs walk_step.inc's arithmetic on the lane's
// own values, so the lane's result is the same bit for bit. The arrival
// factor of a branching lane and the collision or edge move of a
// branching lane are not computed: the branch overwrites them.
template <bool MAJ, bool MIS, bool TABLE, bool TRANSPORT, bool WIDE,
          bool GRID, bool TERMS, bool SHARDS>
__device__ __forceinline__ void walk_step_chain(Lane& L, const Launch& K,
                                                bool on,
                                                const WallQueue& Q) {
  const int t = threadIdx.x;
  float &px = L.px, &py = L.py, &nx = L.nx, &ny = L.ny, &atten = L.atten;
  float(&acc)[MAX_SRC] = L.acc;
  float(&asum)[MAX_SRC] = L.asum;
  float(&asq)[MAX_SRC] = L.asq;
  int &quota = L.quota, &steps = L.steps, &ndone = L.ndone, &life = L.life;
  bool& ob = L.ob;
  float &tn = L.tn, &tw = L.tw, &wmax = L.wmax, &bmax = L.bmax;
  float& a_cur = L.a_cur;
  [[maybe_unused]] const int lane = L.lane;
  const uint32_t sid = L.sid;
  const int n_src = K.n_src;
  const uint32_t seed = SHARDS && on ? lane_seed(L.lane) : K.seed;
  const float rmin = K.rmin, t_min = K.t_min;

  // ---- 1. bank a finished walk, or the star radius and the majorant
  bool go = on;  // the lane takes a step in this iteration
  uint32_t ctr = 0u, base = 0u;
  float u1 = F(0.0), u4 = F(0.0), r = F(0.0), sbar = K.sigma_bar;
  if (go) {
    ctr = (uint32_t)ndone * (uint32_t)(K.max_steps + 2) + (uint32_t)steps;
    base = hash_base(seed, ctr);
    u1 = uni(base, sid, 1);
    u4 = uni(base, sid, 4);
    float cx, cy;
    const float dD = closest_point<TABLE>(px, py, cx, cy);
    const bool done_eps = dD <= K.eps;
    if (done_eps || steps >= K.max_steps) {
      // bank the walk, then recycle the slot into its next walk
      float bx = (C.project && done_eps) ? cx : px;
      float by = (C.project && done_eps) ? cy : py;
      float g_bc;
      if constexpr (GRID)
        g_bc = grid_value(bx, by) * atten;
      else
        g_bc = field_value<TERMS>(F_BC, bx, by) * atten;
      float bank_mag = F(0.0);
      if constexpr (WIDE) {
#pragma unroll 1
        for (int i = 0; i < n_src; ++i) {
          float contrib = C.wacc[i][lane] + g_bc;
          C.wasum[i][lane] = C.wasum[i][lane] + contrib;
          C.wasq[i][lane] = C.wasq[i][lane] + contrib * contrib;
          bank_mag = fmaxf(bank_mag, fabsf(contrib));
          C.wacc[i][lane] = F(0.0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < MAX_SRC; ++i) {
          if (i < n_src) {
            float contrib = acc[i] + g_bc;
            asum[i] = asum[i] + contrib;
            asq[i] = asq[i] + contrib * contrib;
            bank_mag = fmaxf(bank_mag, fabsf(contrib));
            acc[i] = F(0.0);
          }
        }
      }
      bmax = fmaxf(bmax, bank_mag);
      ndone += 1;
      quota -= 1;
      if (!done_eps && fabsf(atten) > F(0.0)) {
        tn = tn + F(1.0);
        tw = tw + fabsf(atten);
      }
      px = L.p0x;
      py = L.p0y;
      atten = F(1.0);
      if (K.snap) {
        ob = L.ob0;
        nx = L.n0x;
        ny = L.n0y;
      } else {
        ob = false;
      }
      steps = 0;
      a_cur = L.a_p0;
      go = false;
    } else {
      // the star radius stops at the nearest silhouette vertex
      r = fmaxf(rmin, C.n_vert > 0 ? fminf(dD, silhouette<TABLE>(px, py))
                                   : dD);
      if constexpr (MAJ) {
        const float d_far = majorant_distance(px, py);
        const float rB = fminf(r, d_far);
        if (d_far >= rmin && fminf(rB, C.mfp_bg) > fminf(r, C.mfp_gl)) {
          r = rB;
          sbar = C.sb_bg;
        }
      }
    }
  }

  // ---- the chord mass of the lanes on the wall, one a thread
  float c_mag = F(0.0);
  const bool mass = go && ob;
  int slot = 0;
  if (mass) {
    slot = (int)atomicAdd(&Q.n[0], 1u);
    Q.f[0][slot] = px, Q.f[1][slot] = py, Q.f[2][slot] = nx;
    Q.f[3][slot] = ny, Q.f[4][slot] = r, Q.f[5][slot] = sbar;
  }
  if (__syncthreads_count(mass) > 0) {
    if (t < (int)Q.n[0]) {
      float r_t = Q.f[4][t], c_t;
      chord_mass<TERMS>(Q.f[0][t], Q.f[1][t], Q.f[2][t], Q.f[3][t], rmin,
                        Q.f[5][t], r_t, c_t);
      Q.f[4][t] = r_t;
      Q.f[5][t] = c_t;
    }
    __syncthreads();
    if (t == 0) Q.n[0] = 0u;
    if (mass) {
      r = Q.f[4][slot];
      c_mag = Q.f[5][slot];
    }
  }

  // ---- the screened radius of the builds without MIS, the transport
  // map or the majorant, where its redraw rounds loop (more than two
  // rounds; the same on every thread): round 0 on the lane, the redraw
  // rounds of the lanes that rejected it one a thread (float rows 15-18
  // and int rows 2-5: z, k0e_z, i0e_z, a_rate, the small-z flag, ctr, sid
  // and, in a launch of several shards, the lane's seed in; s and w_r out
  // in rows 15 and 16). At two rounds a rejecting
  // lane runs one round on its lane: the queue's barriers cost more than
  // that round; and the majorant build (the accuracy path, at two rounds)
  // ran 4% slower with the queue's code compiled in (PERF.md, section 6).
  constexpr bool REDRAW = redraw_queued(MAJ, MIS, TRANSPORT);
  const bool redraw_queue = REDRAW && C.rounds > 2;
  float r_q = F(0.0), w_q = F(1.0);
  if constexpr (REDRAW) {
    if (redraw_queue) {
      Rej q = {};
      float a_rate = F(0.0), s_round0 = F(0.0);
      bool redraw = false;
      if (go) {
        redraw = !radius_round0(r, sbar, seed, ctr, sid, C.rounds, q,
                                a_rate, s_round0, w_q);
        if (redraw) {
          slot = (int)atomicAdd(&redraw_count<true>(), 1u);
          Q.f[15][slot] = q.z, Q.f[16][slot] = q.k0e_z;
          Q.f[17][slot] = q.i0e_z, Q.f[18][slot] = a_rate;
          Q.w[2][slot] = q.small ? 1 : 0, Q.w[3][slot] = (int)ctr;
          Q.w[4][slot] = (int)sid;
          if constexpr (SHARDS) Q.w[5][slot] = (int)seed;
        }
      }
      float s_cur = s_round0;
      if (__syncthreads_count(redraw) > 0) {
        if (t < (int)redraw_count<true>()) {
          const Rej qt = {Q.f[15][t], Q.f[16][t], Q.f[17][t],
                          Q.w[2][t] != 0};
          float s_t = F(0.0), w_t = F(0.0);
          radius_redraws(qt, Q.f[18][t], SHARDS ? (uint32_t)Q.w[5][t] : seed,
                         (uint32_t)Q.w[3][t], (uint32_t)Q.w[4][t], C.rounds,
                         s_t, w_t);
          Q.f[15][t] = s_t;
          Q.f[16][t] = w_t;
        }
        __syncthreads();
        if (t == 0) redraw_count<true>() = 0u;
        if (redraw) {
          s_cur = Q.f[15][slot];
          w_q = Q.f[16][slot];
        }
      }
      if (go) r_q = radius_finish(r, q.z, s_round0, s_cur, w_q);
    }
  }

  // ---- 2. direction, first hit, screened radius, NEE, the move
  bool hit = false, branch = false, edge_hit = false, new_ob = false;
  float hnx = F(0.0), hny = F(0.0), scale = F(0.0), newx = F(0.0);
  float newy = F(0.0), a_next = F(0.0), q_c = F(0.0);
  if (go) {
    // one sin/cos pair: free direction at 2 phi, hemisphere at phi
    const float phi = F(3.141592653589793) * u1;
    const float cphi = cosf(phi), sphi = sinf(phi);
    float dx = F(1.0) - F(2.0) * sphi * sphi;
    float dy = F(2.0) * sphi * cphi;
    float hx, hy, t_hit = r;
    if (C.n_neu > 0) {
      if (ob) {
        const float cb = sphi, sb = -cphi;
        const float hdx = nx * cb - ny * sb;
        const float hdy = ny * cb + nx * sb;
        dx = hdx;
        dy = hdy;
      }
      const float tmw = ob ? t_min : F(0.0);
      float fnx, fny, hxs, hys;
      const float t_best =
          first_hit<TABLE>(px, py, dx, dy, tmw, r, fnx, fny, hxs, hys);
      hit = t_best <= r;
      if (hit) {
        t_hit = t_best;
        const bool flip = (fnx * dx + fny * dy) > F(0.0);
        hnx = flip ? -fnx : fnx;
        hny = flip ? -fny : fny;
        hx = hxs;
        hy = hys;
      } else {
        hx = px + r * dx;
        hy = py + r * dy;
      }
    } else {
      hx = px + r * dx;
      hy = py + r * dy;
    }
    float w_rej = w_q;
    float r_s = r_q;  // the redraw queue's radius
    if constexpr (TRANSPORT)
      r_s = transport_radius(r, sbar, seed, ctr, sid, w_rej);
    else if (!redraw_queue)
      r_s = screened_radius(r, sbar, seed, ctr, sid, C.rounds, w_rej);
    atten = atten * w_rej;
    const bool beyond = r_s > t_hit;
    const float sx = beyond ? hx : px + r_s * dx;
    const float sy = beyond ? hy : py + r_s * dy;
    const float a_p = a_cur;
    const float a_s = alpha_c<TERMS>(sx, sy);
    if constexpr (MIS) {
      // source-directed MIS NEE toward the mixture
      float yx, yy;
      float w_mis = mis_nee<true, TABLE, WIDE, true>(
          base, sid, px, py, px + r_s * dx, py + r_s * dy, r, sbar, ob,
          t_min, yx, yy);
      const float a_y = alpha_c<TERMS>(yx, yy);
      w_mis = w_mis / sqrtf(a_y * a_p) * atten;
      add_sources<TERMS, WIDE>(acc, lane, n_src, yx, yy, w_mis);
    } else if (C.has_source && !beyond) {
      // NEE at the sample, inside the star
      const float w_src = screened_norm(r, sbar) / sqrtf(a_s * a_p) * atten;
      add_sources<TERMS, WIDE>(acc, lane, n_src, sx, sy, w_src);
    }

    const bool interior = u4 < interior_prob(r, sbar);
    const bool collide = interior && !(hit && (r_s >= t_hit - t_min));
    // chord continuation along the wall: branch with q = min(1/2, |c|)
    q_c = fminf(F(0.5), c_mag);
    branch = ob && uni(base, sid, 9) < q_c && q_c > F(1e-6);
    if (branch) {
      slot = (int)atomicAdd(&Q.n[1], 1u);
      Q.f[6][slot] = px, Q.f[7][slot] = py, Q.f[8][slot] = nx;
      Q.f[9][slot] = ny, Q.f[10][slot] = r, Q.f[11][slot] = sbar;
      Q.f[12][slot] = a_p, Q.f[13][slot] = atten, Q.f[14][slot] = q_c;
      Q.w[0][slot] = (int)base, Q.w[1][slot] = (int)sid;
    } else {
      if (collide) {
        // signed null-collision factor: no zero clamp
        scale = sqrtf(a_s / a_p) * (F(1.0) - sigma_prime<TERMS>(sx, sy) / sbar);
        newx = sx;
        newy = sy;
        a_next = a_s;
      } else {
        const float a_h = alpha_c<TERMS>(hx, hy);
        scale = sqrtf(a_h / a_p);
        newx = hx;
        newy = hy;
        a_next = a_h;
      }
      new_ob = hit && !collide;
      edge_hit = new_ob;
      if (edge_hit) {
        slot = REPACK_THREADS - 1 - (int)atomicAdd(&Q.n[2], 1u);
        Q.f[6][slot] = hx, Q.f[7][slot] = hy, Q.f[8][slot] = hnx;
        Q.f[9][slot] = hny, Q.f[10][slot] = dx, Q.f[11][slot] = dy;
        Q.f[12][slot] = t_hit, Q.f[13][slot] = r, Q.f[14][slot] = sbar;
      }
    }
  }

  // ---- the branches and the arrival factors, one a thread
  if (__syncthreads_count(branch || edge_hit) > 0) {
    if (t < (int)Q.n[1]) {
      float a_br, zx, zy, a_z;
      chord_branch<TABLE, TERMS>(
          Q.f[6][t], Q.f[7][t], Q.f[8][t], Q.f[9][t], Q.f[10][t], Q.f[11][t],
          (uint32_t)Q.w[0][t], (uint32_t)Q.w[1][t], Q.f[12][t], Q.f[13][t],
          Q.f[14][t], a_br, zx, zy, a_z);
      Q.f[6][t] = a_br, Q.f[7][t] = zx, Q.f[8][t] = zy, Q.f[9][t] = a_z;
    } else if (t >= REPACK_THREADS - (int)Q.n[2]) {
      Q.f[6][t] = arrival_factor<TERMS>(Q.f[6][t], Q.f[7][t], Q.f[8][t],
                                        Q.f[9][t], Q.f[10][t], Q.f[11][t],
                                        Q.f[12][t], Q.f[13][t], Q.f[14][t]);
    }
    __syncthreads();
    if (t == 0) Q.n[1] = 0u, Q.n[2] = 0u;
  }

  // ---- 3. the lane's weight and move
  if (go) {
    if (branch) {
      atten = Q.f[6][slot];
      newx = Q.f[7][slot];
      newy = Q.f[8][slot];
      a_next = Q.f[9][slot];
      new_ob = true;
    } else {
      if (edge_hit) scale = scale * Q.f[6][slot];
      atten = atten * scale;
      // the other wall lanes pay 1 / (1 - q)
      if (ob && q_c > F(1e-6)) atten = atten * (F(1.0) / (F(1.0) - q_c));
    }
    if (C.clip) {  // max_attenuation, symmetric: chord weights can be < 0
      const float m = C.max_att;
      atten = atten > m ? m : (atten < -m ? -m : atten);
    }
    px = newx;
    py = newy;
    ob = new_ob;
    if (hit && !branch) {  // a chord stays on its own wall
      nx = hnx;
      ny = hny;
    }
    steps += 1;
    if (C.roulette) {
      const float thr = C.roulette_thr;
      const float u_r = uni(hash_base(seed ^ 0x0F1E2D3Cu, ctr), sid, 1);
      if (fabsf(atten) < thr) {
        const bool survive = u_r * thr < fabsf(atten);
        atten = survive ? (atten < F(0.0) ? -thr : thr) : F(0.0);
        if (!survive) steps = K.max_steps;
      }
    }
    life += 1;
    wmax = fmaxf(wmax, fabsf(atten));
    a_cur = a_next;
  }
}

// a lane's registers to (PUT) or from its slot of the block's shared
// stash (word-major: a warp's threads touch consecutive words)
template <bool WIDE, bool PUT>
__device__ __forceinline__ void stash_lane(Lane& L, int s,
                                           float (*f)[REPACK_THREADS],
                                           int (*w)[REPACK_THREADS]) {
  int kf = 0, kw = 0;
  const auto mf = [&](float& x) {
    if (PUT)
      f[kf][s] = x;
    else
      x = f[kf][s];
    ++kf;
  };
  const auto mw = [&](int& x) {
    if (PUT)
      w[kw][s] = x;
    else
      x = w[kw][s];
    ++kw;
  };
  mf(L.px), mf(L.py), mf(L.nx), mf(L.ny), mf(L.atten);
  mf(L.tn), mf(L.tw), mf(L.wmax), mf(L.bmax), mf(L.a_cur), mf(L.a_p0);
  mf(L.p0x), mf(L.p0y), mf(L.n0x), mf(L.n0y);
  if constexpr (!WIDE) {
#pragma unroll
    for (int i = 0; i < MAX_SRC; ++i)
      mf(L.acc[i]), mf(L.asum[i]), mf(L.asq[i]);
  }
  int ob = L.ob, ob0 = L.ob0, sid = (int)L.sid;
  mw(L.quota), mw(L.steps), mw(L.ndone), mw(L.life), mw(L.lane), mw(L.it);
  mw(ob), mw(ob0), mw(sid);
  if (!PUT) {
    L.ob = ob != 0;
    L.ob0 = ob0 != 0;
    L.sid = (uint32_t)sid;
  }
}

// the launch's pool: the first lane no block has taken yet (walk_launch
// sets the current card's to 0 before every repack launch); in a dealt
// launch, the first walk no thread has taken yet (walk_dealt)
__device__ unsigned int next_lane;

// The freeze builds' loop. Blocks take lanes from the launch's pool in
// lane order, as many as they have free threads. A lane stays live until
// the one-thread loop would have left it: its quota drains, it has taken
// `budget` iterations, or it freezes. Live lanes take rounds of
// REPACK_STEPS iterations; a lane that stops writes its planes back at
// once (they are final for the launch). After a round, while the pool
// lasts and at least REPACK_REFILL threads are free, the free threads take
// the next lanes; once it is empty, the live lanes move through shared
// memory into the block's lowest threads whenever that frees a warp (in
// lane order), and threads without a lane wait at the barriers.
template <int ROBIN, bool MAJ, bool MIS, bool TABLE, bool DELTA,
          bool TRANSPORT, bool WIDE, bool GRID, bool TERMS, bool CHAIN,
          bool SHARDS>
__device__ __forceinline__ void walk_repacked(int n_lanes, int budget,
                                              float freeze_thr) {
  __shared__ float s_f[LANE_FLOATS][REPACK_THREADS];
  __shared__ int s_w[LANE_INTS][REPACK_THREADS];
  __shared__ int s_scan[REPACK_THREADS];
  __shared__ unsigned int s_take;
  const int t = threadIdx.x;
  const Launch K = {C.n_src, C.seed, C.snap != 0, C.eps,
                    C.rmin,  C.t_min,        C.sigma_bar, C.max_steps,
                    freeze_thr};
  // an inclusive scan over the block of one int a thread
  const auto scan = [&](int v) {
    s_scan[t] = v;
    __syncthreads();
    for (int d = 1; d < REPACK_THREADS; d <<= 1) {
      const int u = s_scan[t] + (t >= d ? s_scan[t - d] : 0);
      __syncthreads();
      s_scan[t] = u;
      __syncthreads();
    }
    return s_scan[t];
  };
  Lane L;
  bool live = false, more = budget > 0;  // more: the pool may hold lanes
  int n = 0, packed = REPACK_THREADS;    // live lanes, threads in use
  if constexpr (CHAIN) {  // zero before the first refill's barriers
    if (t < 3) wall_counts<true>()[t] = 0u;
    if constexpr (redraw_queued(MAJ, MIS, TRANSPORT)) {
      if (t == 0) redraw_count<true>() = 0u;
    }
  }
  for (;;) {
    if (more && REPACK_THREADS - n >= REPACK_REFILL) {
      const unsigned int free = REPACK_THREADS - n;
      const int rank = scan(live ? 0 : 1);
      if (t == 0) s_take = atomicAdd(&next_lane, free);
      __syncthreads();
      const unsigned int take = s_take, lane = take + rank - 1;
      more = take + free < (unsigned int)n_lanes;
      if (!live && lane < (unsigned int)n_lanes) {
        const int quota = C.pl.quota[lane];
        if (quota > 0) {  // a lane without quota writes nothing
          load_lane<DELTA, TERMS, WIDE>(L, (int)lane, quota, K);
          live = true;
        }
      }
    }
    if constexpr (CHAIN) {
      // every thread runs the step's phases, with a lane or without
      const WallQueue Q = {s_f, s_w, wall_counts<true>()};
      for (int k = 0; k < REPACK_STEPS; ++k) {
        const bool was = live;
        if (live) ++L.it;
        walk_step_chain<MAJ, MIS, TABLE, TRANSPORT, WIDE, GRID, TERMS,
                        SHARDS>(L, K, live, Q);
        live = live && L.it < budget && L.quota > 0;
        if (was && !live) store_lane<WIDE>(L, K.n_src);
      }
    } else if (live) {
      for (int k = 0; k < REPACK_STEPS && live; ++k) {
        ++L.it;
        live = walk_step<ROBIN, MAJ, MIS, TABLE, DELTA, TRANSPORT, WIDE,
                         GRID, TERMS, SHARDS>(L, K) &&
               L.it < budget && L.quota > 0;
      }
      if (!live) store_lane<WIDE>(L, K.n_src);
    }
    n = __syncthreads_count(live);
    if (n == 0 && !more) return;
    if (!more && (n + 31) / 32 < (packed + 31) / 32) {
      const int slot = scan(live ? 1 : 0) - 1;
      if (live) stash_lane<WIDE, true>(L, slot, s_f, s_w);
      __syncthreads();
      live = t < n;
      if (live) stash_lane<WIDE, false>(L, t, s_f, s_w);
      packed = n;
      if constexpr (CHAIN) __syncthreads();  // the stash: the next queue
    }
  }
}

// ---- the kernel ----------------------------------------------------------

template <int ROBIN, bool MAJ, bool MIS, bool FREEZE, bool TABLE, bool DELTA,
          bool TRANSPORT, bool WIDE = false, bool GRID = false,
          bool TERMS_FORM = false, bool SHARDS = false>
__global__ void __launch_bounds__(repacked(ROBIN, MIS, FREEZE, TABLE,
                                           TERMS_FORM)
                                      ? REPACK_THREADS
                                      : THREADS)
walk_kernel(int n_lanes, int budget, float freeze_thr) {
  static_assert(walk_rules::valid_variant(ROBIN, MAJ, MIS, FREEZE, TABLE,
                                          DELTA, TRANSPORT, TERMS_FORM),
                "not a switch combination the TPU kernel traces");
  constexpr bool TERMS =
      TERMS_FORM || terms_fields(ROBIN, MAJ, MIS, FREEZE, TABLE, DELTA);
  if constexpr (repacked(ROBIN, MIS, FREEZE, TABLE, TERMS_FORM)) {
    walk_repacked<ROBIN, MAJ, MIS, TABLE, DELTA, TRANSPORT, WIDE, GRID,
                  TERMS,
                  chain_phases(ROBIN, MIS, FREEZE, TABLE, TERMS_FORM),
                  SHARDS>(n_lanes, budget, freeze_thr);
  } else {
    // one thread per lane for the whole launch (its own loads and stores,
    // not load_lane/store_lane: routed through the Lane struct, the
    // non-freeze builds compiled to other code)
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    if (lane >= n_lanes) return;
    const Planes& P = C.pl;
    int quota = P.quota[lane];
    if (quota <= 0 || budget <= 0) return;  // a no-op lane: nothing to write

    const int n_src = C.n_src;
    const uint32_t seed = SHARDS ? lane_seed(lane) : C.seed;
    const uint32_t sid = (uint32_t)P.sid[lane];
    const float p0x = P.p0x[lane], p0y = P.p0y[lane];
    const bool snap = C.snap != 0;
    const bool ob0 = snap ? P.ob0[lane] != 0 : false;
    const float n0x = snap ? P.n0x[lane] : F(0.0);
    const float n0y = snap ? P.n0y[lane] : F(0.0);

    float px = P.px[lane], py = P.py[lane], nx = P.nx[lane], ny = P.ny[lane];
    float atten = P.atten[lane];
    // the narrow form carries the accumulators and moments in registers;
    // the wide form adds to its planes in place
    float acc[MAX_SRC], asum[MAX_SRC], asq[MAX_SRC];
    if constexpr (!WIDE) {
#pragma unroll
      for (int i = 0; i < MAX_SRC; ++i) {
        acc[i] = i < n_src ? P.acc[i][lane] : F(0.0);
        asum[i] = i < n_src ? P.asum[i][lane] : F(0.0);
        asq[i] = i < n_src ? P.asq[i][lane] : F(0.0);
      }
    }
    int steps = P.steps[lane], ndone = P.ndone[lane], life = P.life[lane];
    bool ob = P.ob[lane] != 0;
    float tn = P.tn[lane], tw = P.tw[lane], wmax = P.wmax[lane];
    float bmax = P.bmax[lane];

    const float eps = C.eps, rmin = C.rmin, t_min = C.t_min;
    const float sigma_bar = C.sigma_bar;
    const int max_steps = C.max_steps;
    // the alpha cache of delta tracking (a walk without it reads none)
    float a_p0 = F(0.0), a_cur = F(0.0);
    if constexpr (DELTA) {
      a_p0 = alpha_c<TERMS>(p0x, p0y);
      a_cur = alpha_c<TERMS>(px, py);
    }
#if WALK_CULLED_CLOSEST
#define WALK_CLOSEST closest_point_culled
#endif
#if WALK_ONE_SINCOS
#define WALK_SINCOS
#endif
#if WALK_CULLED_CHORD
#define WALK_CHORD chord_frame_culled
#endif

    for (int it = 0; it < budget && quota > 0; ++it) {
#define WALK_NEXT continue
#define WALK_FROZEN break
#include "walk_step.inc"
#undef WALK_NEXT
#undef WALK_FROZEN
    }
#undef WALK_CLOSEST
#undef WALK_SINCOS
#undef WALK_CHORD

    P.px[lane] = px;
    P.py[lane] = py;
    P.nx[lane] = nx;
    P.ny[lane] = ny;
    P.atten[lane] = atten;
    if constexpr (!WIDE) {
#pragma unroll
      for (int i = 0; i < MAX_SRC; ++i) {
        if (i < n_src) {
          P.acc[i][lane] = acc[i];
          P.asum[i][lane] = asum[i];
          P.asq[i][lane] = asq[i];
        }
      }
    }
    P.quota[lane] = quota;
    P.steps[lane] = steps;
    P.ndone[lane] = ndone;
    P.ob[lane] = ob ? 1 : 0;
    P.life[lane] = life;
    P.tn[lane] = tn;
    P.tw[lane] = tw;
    P.wmax[lane] = wmax;
    P.bmax[lane] = bmax;
  }
}

// ---- the dealt loop: walks, not lanes, to the threads ---------------------

// A launch of a walk_variant.h::dealt build that holds one shard, whose
// budget covers every lane's quota (quota x (max_steps + 1) iterations,
// which solver/wost.py's adaptive single launch gives) and whose every
// lane with quota stands at a walk's start (fresh_lane) deals walks, not
// lanes, to its threads. Walk k of lane l (k < its quota) starts as the
// bank's recycle leaves a lane, at ndone = ndone_l + k; its draws are
// keyed on (seed, its counter, the lane's stream) alone, so any thread may
// run it at any time and draw what the one-thread loop draws. A walk meets
// the rest of its lane only at the bank, whose float32 sums add in walk
// order: each walk writes a record, and walk_fold adds a lane's records in
// walk order with the bank's operations, leaving every plane as the
// one-thread loop leaves it. Three plan kernels lay the walks out first
// (walk_plan: each lane's first record, the walks, the largest quota and
// whether every lane with quota is fresh); the host reads the plan back
// and picks the loop. In the one-thread loop a thread walks its lane's
// walks one after another and its warp waits for the warp's longest lane
// (a lane occupancy of 0.68 on the survey); here a thread that banks takes
// the launch's next walk (one atomicAdd on next_lane), so every thread
// walks until the launch's walks run out.
constexpr int PLAN_THREADS = 256;  // lanes a tile of the plan
// a walk's record, int32 words: its steps, the |atten| of a walk the bank
// counts as cut at max_steps (else 0), its largest |atten| and banked
// |total|, its last wall normal (REC_UNSET: none; runs without snap
// starts carry it from walk to walk), then one contribution a source
constexpr int REC_LIFE = 0, REC_TW = 1, REC_WMAX = 2, REC_BMAX = 3,
              REC_NX = 4, REC_NY = 5, REC_SRC = 6;
constexpr uint32_t REC_UNSET = 0x7FC0BEEFu;  // a NaN no step computes

__device__ __forceinline__ int float_bits(float x) {
  int u;
  memcpy(&u, &x, sizeof u);
  return u;
}

__device__ __forceinline__ float bits_float(int u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}

// whether a lane stands at a walk's start, as the bank's recycle leaves it
template <bool WIDE>
__device__ __forceinline__ bool fresh_lane(int lane) {
  const Planes& P = C.pl;
  const bool snap = C.snap != 0;
  bool ok = P.steps[lane] == 0 && P.px[lane] == P.p0x[lane] &&
            P.py[lane] == P.p0y[lane] && P.atten[lane] == F(1.0) &&
            (P.ob[lane] != 0) == (snap && P.ob0[lane] != 0);
  if (snap) ok = ok && P.nx[lane] == P.n0x[lane] && P.ny[lane] == P.n0y[lane];
  for (int i = 0; i < C.n_src; ++i)
    ok = ok && (WIDE ? C.wacc[i][lane] : P.acc[i & (MAX_SRC - 1)][lane]) ==
                   F(0.0);
  return ok;
}

// an inclusive scan over the plan's block of (sum, max) pairs
__device__ __forceinline__ void plan_scan(long long* s_sum, int* s_max,
                                          int t) {
  __syncthreads();
  for (int d = 1; d < PLAN_THREADS; d <<= 1) {
    const long long u = s_sum[t] + (t >= d ? s_sum[t - d] : 0);
    const int m = max(s_max[t], t >= d ? s_max[t - d] : 0);
    __syncthreads();
    s_sum[t] = u;
    s_max[t] = m;
    __syncthreads();
  }
}

// plan, 1 of 3: a tile's lanes, one a thread: each lane's first walk
// within the tile; the tile's walks, largest quota and stale lanes
template <bool WIDE>
__global__ void __launch_bounds__(PLAN_THREADS)
    walk_plan_tiles(int n_lanes, int* offsets, long long* tiles) {
  __shared__ long long s_sum[PLAN_THREADS];
  __shared__ int s_max[PLAN_THREADS];
  const int t = threadIdx.x, b = blockIdx.x;
  const int lane = b * PLAN_THREADS + t;
  const int q = lane < n_lanes ? max(C.pl.quota[lane], 0) : 0;
  const bool stale = q > 0 && !fresh_lane<WIDE>(lane);
  s_sum[t] = q;
  s_max[t] = q;
  plan_scan(s_sum, s_max, t);
  const int n_stale = __syncthreads_count(stale);
  if (lane < n_lanes) offsets[lane] = (int)(s_sum[t] - q);
  if (t == PLAN_THREADS - 1) {
    tiles[3 * b] = s_sum[t];
    tiles[3 * b + 1] = s_max[t];
    tiles[3 * b + 2] = n_stale;
  }
}

// plan, 2 of 3: one block over the tiles: each tile's first walk; stats =
// (walks, or -1 past INT32_MAX; the largest quota; the stale lanes)
template <bool WIDE>
__global__ void __launch_bounds__(PLAN_THREADS)
    walk_plan_scan(int n_tiles, int n_lanes, int* offsets, long long* tiles,
                   int* stats) {
  __shared__ long long s_sum[PLAN_THREADS];
  __shared__ int s_max[PLAN_THREADS];
  const int t = threadIdx.x;
  const int per = (n_tiles + PLAN_THREADS - 1) / PLAN_THREADS;
  const int lo = min(t * per, n_tiles), hi = min(lo + per, n_tiles);
  long long sum = 0;
  int qmax = 0, stale = 0;
  for (int b = lo; b < hi; ++b) {
    sum += tiles[3 * b];
    qmax = max(qmax, (int)tiles[3 * b + 1]);
    stale = stale || tiles[3 * b + 2] != 0;
  }
  s_sum[t] = sum;
  s_max[t] = qmax;
  plan_scan(s_sum, s_max, t);
  const int n_stale = __syncthreads_count(stale);
  long long run = s_sum[t] - sum;
  for (int b = lo; b < hi; ++b) {
    const long long s = tiles[3 * b];
    tiles[3 * b] = run;
    run += s;
  }
  if (t == PLAN_THREADS - 1) {
    const long long total = s_sum[t];
    const bool fits = total <= 0x7FFFFFFFLL;
    offsets[n_lanes] = fits ? (int)total : 0;
    stats[0] = fits ? (int)total : -1;
    stats[1] = s_max[t];
    stats[2] = n_stale;
  }
}

// plan, 3 of 3: each lane's first walk in the launch
template <bool WIDE>
__global__ void __launch_bounds__(PLAN_THREADS)
    walk_plan_offsets(int n_lanes, int* offsets, const long long* tiles) {
  const int lane = blockIdx.x * PLAN_THREADS + threadIdx.x;
  if (lane < n_lanes)
    offsets[lane] = (int)(offsets[lane] + tiles[3 * blockIdx.x]);
}

// a walk's accumulators: registers in the narrow form, the thread's row of
// the block's shared memory in the wide form (SharedRow)
template <bool WIDE>
struct WalkAcc {
  typedef float type[MAX_SRC];
};
template <>
struct WalkAcc<true> {
  typedef SharedRow type;
};

// the walks, from a launch-wide counter (next_lane, set to 0 on the
// launch's card), one at a time a thread: walk w is walk w - offsets[l] of
// the last lane l with offsets[l] <= w, and writes record w. One loop, as
// the one-thread loop's: a thread whose walk banks writes its record and
// takes its next walk within that iteration (WALK_NEXT), so a warp
// reconverges every iteration; a loop over a walk's steps nested in a loop
// over walks made each thread wait at the inner loop's exit for its warp's
// longest walk. The transport build's launch bounds ask for
// DEALT_MIN_BLOCKS blocks a SM, at most 64 registers a thread (ptxas alone
// chose 96, 5 blocks a SM, and ran slower on the card: PERF.md, section
// 6); the other builds keep ptxas's choice (64 or 63 registers)
constexpr int DEALT_MIN_BLOCKS = 8;
#if WALK_TRANSPORT
#define WALK_DEALT_BOUNDS __launch_bounds__(THREADS, DEALT_MIN_BLOCKS)
#else
#define WALK_DEALT_BOUNDS __launch_bounds__(THREADS)
#endif
template <int ROBIN, bool MAJ, bool MIS, bool FREEZE, bool TABLE, bool DELTA,
          bool TRANSPORT, bool WIDE, bool GRID, bool TERMS_FORM>
__global__ void WALK_DEALT_BOUNDS
    walk_dealt(int n_lanes, int n_walks, const int* offsets, int* records) {
  static_assert(walk_rules::dealt(ROBIN, MAJ, MIS, FREEZE, TABLE, DELTA,
                                  TRANSPORT, WIDE, GRID, TERMS_FORM),
                "the dealt loop runs the walk_variant.h::dealt builds");
  constexpr bool TERMS =
      TERMS_FORM || terms_fields(ROBIN, MAJ, MIS, FREEZE, TABLE, DELTA);
  const Planes& P = C.pl;
  const int n_src = C.n_src;
  const uint32_t seed = C.seed;
  const bool snap = C.snap != 0;
  const float eps = C.eps, rmin = C.rmin, t_min = C.t_min;
  const float sigma_bar = C.sigma_bar;
  const int max_steps = C.max_steps;
  [[maybe_unused]] const float freeze_thr = F(0.0);  // no freeze here
  const int words = REC_SRC + n_src;
  const float unset = bits_float((int)REC_UNSET);
  typename WalkAcc<WIDE>::type acc;
  if constexpr (WIDE) {
    __shared__ float s_acc[MAX_WIDE_SRC * THREADS];
    acc.p = s_acc + threadIdx.x;
  }
  unsigned int w = atomicAdd(&next_lane, 1u);
  if (w >= (unsigned int)n_walks) return;

  // the walk's lane and its constants, the walk's state, its own
  // counters; the narrow bank's sums start at -0 each walk, so that each
  // holds the walk's contribution bit for bit
  int lane = 0;
  int* rec = records;
  uint32_t sid = 0;
  float p0x = F(0.0), p0y = F(0.0), n0x = F(0.0), n0y = F(0.0);
  bool ob0 = false;
  float px, py, nx, ny, atten;
  bool ob;
  int steps, life, quota, ndone;
  float tn, tw, wmax, bmax;
  float asum[MAX_SRC], asq[MAX_SRC];
  float a_p0 = F(0.0), a_cur = F(0.0);
  // walk w from its start, as the bank's recycle leaves a lane
  const auto start = [&]() {
    int lo = 0, hi = n_lanes;  // offsets[lo] <= w < offsets[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if ((unsigned int)offsets[mid] <= w)
        lo = mid;
      else
        hi = mid;
    }
    lane = lo;
    rec = records + (size_t)w * words;
    sid = (uint32_t)P.sid[lane];
    p0x = P.p0x[lane];
    p0y = P.p0y[lane];
    ob0 = snap ? P.ob0[lane] != 0 : false;
    n0x = snap ? P.n0x[lane] : F(0.0);
    n0y = snap ? P.n0y[lane] : F(0.0);
    px = p0x;
    py = p0y;
    atten = F(1.0);
    nx = snap ? n0x : unset;
    ny = snap ? n0y : unset;
    ob = ob0;
    steps = 0;
    life = 0;
    quota = 1;
    ndone = P.ndone[lane] + (int)(w - (unsigned int)offsets[lane]);
    tn = tw = wmax = bmax = F(0.0);
#pragma unroll
    for (int i = 0; i < MAX_SRC; ++i) {
      asum[i] = F(-0.0);
      asq[i] = F(-0.0);
      if constexpr (!WIDE) acc[i] = F(0.0);
    }
    if constexpr (WIDE) {
#pragma unroll 1
      for (int i = 0; i < n_src; ++i) acc.p[i * THREADS] = F(0.0);
    }
    if constexpr (DELTA) {
      a_p0 = alpha_c<TERMS>(p0x, p0y);
      a_cur = a_p0;
    }
  };
  // the walk's record, once its bank ran (the wide form's contributions
  // went in at the bank, WALK_BANK_WIDE)
  const auto finish = [&]() {
    rec[REC_LIFE] = life;
    rec[REC_TW] = float_bits(tw);
    rec[REC_WMAX] = float_bits(wmax);
    rec[REC_BMAX] = float_bits(bmax);
    rec[REC_NX] = float_bits(nx);
    rec[REC_NY] = float_bits(ny);
    if constexpr (!WIDE) {
#pragma unroll
      for (int i = 0; i < MAX_SRC; ++i)
        if (i < n_src) rec[REC_SRC + i] = float_bits(asum[i]);
    }
  };
  start();
  for (;;) {
    // the step's exact savings: alpha and sigma' at a colliding sample in
    // one pass (alpha_sample); in the survey's MIS build the ball's
    // interior probability once a step and one sincosf (mis_nee's DEALT)
#define WALK_ONE_PASS
#define WALK_BALL_ONCE
#define WALK_NEXT                          \
  {                                        \
    finish();                              \
    w = atomicAdd(&next_lane, 1u);         \
    if (w >= (unsigned int)n_walks) break; \
    start();                               \
    continue;                              \
  }
#define WALK_FROZEN break
#define WALK_BANK_WIDE                               \
  for (int i = 0; i < n_src; ++i) {                  \
    const float contrib = acc.p[i * THREADS] + g_bc; \
    rec[REC_SRC + i] = float_bits(contrib);          \
    bank_mag = fmaxf(bank_mag, fabsf(contrib));      \
    acc.p[i * THREADS] = F(0.0);                     \
  }
#include "walk_step.inc"
#undef WALK_BANK_WIDE
#undef WALK_NEXT
#undef WALK_FROZEN
#undef WALK_BALL_ONCE
#undef WALK_ONE_PASS
  }
  (void)tn;
  (void)quota;
}

// a lane's records added in walk order with the bank's float32
// operations; its planes end as the one-thread loop leaves a drained lane
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
    walk_fold(int n_lanes, const int* offsets, const int* records) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  const Planes& P = C.pl;
  const int quota = P.quota[lane];
  if (quota <= 0) return;  // a lane without quota: nothing to write
  const int n_src = C.n_src, words = REC_SRC + n_src;
  const bool snap = C.snap != 0;
  const int* const first = records + (size_t)offsets[lane] * words;
#pragma unroll 1
  for (int i = 0; i < n_src; ++i) {
    float* const sum_p = WIDE ? C.wasum[i] : P.asum[i & (MAX_SRC - 1)];
    float* const sq_p = WIDE ? C.wasq[i] : P.asq[i & (MAX_SRC - 1)];
    float* const acc_p = WIDE ? C.wacc[i] : P.acc[i & (MAX_SRC - 1)];
    float s = sum_p[lane], q = sq_p[lane];
    const int* r = first + REC_SRC + i;
    for (int k = 0; k < quota; ++k, r += words) {
      const float contrib = bits_float(*r);
      s = s + contrib;
      q = q + contrib * contrib;
    }
    sum_p[lane] = s;
    sq_p[lane] = q;
    acc_p[lane] = F(0.0);
  }
  float tn = P.tn[lane], tw = P.tw[lane], wmax = P.wmax[lane];
  float bmax = P.bmax[lane];
  int life = P.life[lane];
  float nx = snap ? P.n0x[lane] : P.nx[lane];
  float ny = snap ? P.n0y[lane] : P.ny[lane];
  const int* r = first;
  for (int k = 0; k < quota; ++k, r += words) {
    life += r[REC_LIFE];
    wmax = fmaxf(wmax, bits_float(r[REC_WMAX]));
    bmax = fmaxf(bmax, bits_float(r[REC_BMAX]));
    const float t = bits_float(r[REC_TW]);
    if (t > F(0.0)) {
      tn = tn + F(1.0);
      tw = tw + t;
    }
    if (!snap && (uint32_t)r[REC_NX] != REC_UNSET) {
      nx = bits_float(r[REC_NX]);
      ny = bits_float(r[REC_NY]);
    }
  }
  P.px[lane] = P.p0x[lane];
  P.py[lane] = P.p0y[lane];
  P.nx[lane] = nx;
  P.ny[lane] = ny;
  P.atten[lane] = F(1.0);
  P.quota[lane] = 0;
  P.steps[lane] = 0;
  P.ndone[lane] = P.ndone[lane] + quota;
  P.ob[lane] = (snap && P.ob0[lane] != 0) ? 1 : 0;
  P.life[lane] = life;
  P.tn[lane] = tn;
  P.tw[lane] = tw;
  P.wmax[lane] = wmax;
  P.bmax[lane] = bmax;
}

}  // namespace

// the library's one variant (walk_variant.h), from its -D macros
constexpr int BUILT[12] = {WALK_ROBIN,     WALK_MAJORANT, WALK_MIS,
                           WALK_FREEZE,    WALK_TABLE,    WALK_DELTA,
                           WALK_TRANSPORT, WALK_WIDE,     WALK_GRID,
                           WALK_TERMS,     WALK_ROWS,     WALK_LARGE};

// the repack loop runs the freeze and chain_phases builds (walk_variant.h),
// one thread per lane the others; threads (and lanes) per block
constexpr bool REPACKED = repacked(WALK_ROBIN, WALK_MIS != 0,
                                   WALK_FREEZE != 0, WALK_TABLE != 0,
                                   WALK_TERMS != 0);
constexpr int BLOCK = REPACKED ? REPACK_THREADS : THREADS;

// a launch of one shard, or (SHARDS, the builds without the freeze, which
// the sharded loop launches) of several
template <bool SHARDS>
void launch_built(int grid, cudaStream_t st, int n_lanes, int budget,
                  float thr) {
  walk_kernel<WALK_ROBIN, WALK_MAJORANT != 0, WALK_MIS != 0,
              WALK_FREEZE != 0, WALK_TABLE != 0, WALK_DELTA != 0,
              WALK_TRANSPORT != 0, WALK_WIDE != 0, WALK_GRID != 0,
              WALK_TERMS != 0, SHARDS>
      <<<grid, BLOCK, 0, st>>>(n_lanes, budget, thr);
}

// the library's variant deals walks to its threads in the launches that
// drain every quota from fresh walks (walk_variant.h::dealt); the
// preprocessor's copy of the rule keeps the dealt kernels out of the
// other builds' libraries altogether
#define WALK_DEALT                                                     \
  (WALK_ROBIN == 0 && !WALK_MAJORANT && !WALK_FREEZE && !WALK_TABLE && \
   WALK_DELTA && !WALK_GRID && !WALK_TERMS &&                          \
   !(WALK_TRANSPORT && (WALK_MIS || WALK_WIDE)))
constexpr bool DEALT = walk_rules::dealt(
    WALK_ROBIN, WALK_MAJORANT != 0, WALK_MIS != 0, WALK_FREEZE != 0,
    WALK_TABLE != 0, WALK_DELTA != 0, WALK_TRANSPORT != 0, WALK_WIDE != 0,
    WALK_GRID != 0, WALK_TERMS != 0);
static_assert(DEALT == (WALK_DEALT != 0), "walk_variant.h::dealt");

// a launch of kernel k through the runtime's launch call (the host
// stand-in of tests/host_cuda runs it by the kernel's parameter types)
template <class K>
static cudaError_t launch_kernel(K* k, dim3 grid, dim3 block, void** args,
                                 cudaStream_t st) {
#ifdef __CUDACC__
  return cudaLaunchKernel((const void*)k, grid, block, args, 0, st);
#else
  return cudaLaunchKernel(k, grid, block, args, 0, st);
#endif
}

// a dealt launch's plan (walk_plan)
static int plan_dealt(cudaStream_t st, int n_lanes, int* offsets,
                      long long* tiles, int* stats) {
#if WALK_DEALT
  {
    int n_tiles = (n_lanes + PLAN_THREADS - 1) / PLAN_THREADS;
    void* a1[] = {&n_lanes, &offsets, &tiles};
    cudaError_t e = launch_kernel(walk_plan_tiles<WALK_WIDE != 0>,
                                  dim3(n_tiles), dim3(PLAN_THREADS), a1, st);
    if (e != cudaSuccess) return (int)e;
    void* a2[] = {&n_tiles, &n_lanes, &offsets, &tiles, &stats};
    e = launch_kernel(walk_plan_scan<WALK_WIDE != 0>, dim3(1),
                      dim3(PLAN_THREADS), a2, st);
    if (e != cudaSuccess) return (int)e;
    void* a3[] = {&n_lanes, &offsets, &tiles};
    e = launch_kernel(walk_plan_offsets<WALK_WIDE != 0>, dim3(n_tiles),
                      dim3(PLAN_THREADS), a3, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
#else
  (void)st, (void)n_lanes, (void)offsets, (void)tiles, (void)stats;
  return (int)cudaErrorInvalidValue;
#endif
}

// a dealt launch: the walks on as many blocks as the card holds at once
// (the launch-wide counter deals them), then the fold, one thread a lane
static int launch_dealt(cudaStream_t st, int n_lanes, const int* offsets,
                        int* records, int n_walks) {
#if WALK_DEALT
  {
    auto* walks =
        walk_dealt<WALK_ROBIN, WALK_MAJORANT != 0, WALK_MIS != 0,
                   WALK_FREEZE != 0, WALK_TABLE != 0, WALK_DELTA != 0,
                   WALK_TRANSPORT != 0, WALK_WIDE != 0, WALK_GRID != 0,
                   WALK_TERMS != 0>;
    int dev = 0, sms = 1, per_sm = 1;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walks,
                                                        THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    const long long need = ((long long)n_walks + THREADS - 1) / THREADS;
    const int grid = (int)(need < (long long)sms * per_sm
                               ? need
                               : (long long)sms * per_sm);
    static const unsigned int zero = 0;  // the card's counter, as C's
    e = cudaMemcpyToSymbolAsync(next_lane, &zero, sizeof zero, 0,
                                cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
    void* a1[] = {&n_lanes, &n_walks, &offsets, &records};
    e = launch_kernel(walks, dim3(grid > 0 ? grid : 1), dim3(THREADS), a1, st);
    if (e != cudaSuccess) return (int)e;
    const int* recs = records;
    void* a2[] = {&n_lanes, &offsets, &recs};
    e = launch_kernel(walk_fold<WALK_WIDE != 0>,
                      dim3((n_lanes + THREADS - 1) / THREADS), dim3(THREADS),
                      a2, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
#else
  (void)st, (void)n_lanes, (void)offsets, (void)records, (void)n_walks;
  return (int)cudaErrorInvalidValue;
#endif
}

// the rows per chunk of the table form's chunk records (ops/walk_kernel.py
// reads it back after loading the library)
extern "C" int walk_chunk_rows() { return CHUNK_ROWS; }

// a dealt launch's layout: lanes a tile of the plan (walk_plan's tiles:
// 3 int64 a tile) and the words of a walk's record before its sources'
// (ops/walk_kernel.py::launch_loop sizes the plan and the records by them)
extern "C" int walk_dealt_layout(int* out, int n) {
  if (n != 2) return (int)cudaErrorInvalidValue;
  out[0] = PLAN_THREADS;
  out[1] = REC_SRC;
  return 0;
}

// the switches of this library: robin, majorant, mis, freeze, table,
// delta, transport, wide, grid, terms form, general rows, then (n = 12) the
// large-table build (ops/walk_kernel.py reads them back after loading it)
extern "C" int walk_switches(int* out, int n) {
  if (n != 11 && n != 12) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n; ++k) out[k] = BUILT[k];
  return 0;
}

// the large-table build's record layout: vertex rows a silhouette chunk,
// chunks a group (ops/walk_kernel.py checks them after loading it)
extern "C" int walk_large_layout(int* out, int n) {
  if (n != 2) return (int)cudaErrorInvalidValue;
  out[0] = SIL_ROWS;
  out[1] = GROUP_CHUNKS;
  return 0;
}

// the launch's schedule: threads a block, then the repack loop's
// iterations a round and the free threads at which a block refills from
// the pool (0 and 0 in the builds that run one thread a lane for the
// whole launch); chip_smoke.py replays it
extern "C" int walk_schedule(int* out, int n) {
  if (n != 3) return (int)cudaErrorInvalidValue;
  out[0] = BLOCK;
  out[1] = REPACKED ? REPACK_STEPS : 0;
  out[2] = REPACKED ? REPACK_REFILL : 0;
  return 0;
}

// fp: eps, rmin, t_min, sigma_bar, roulette_thr, gamma_floor,
//     arrival_clamp, sb_bg, mfp_bg, mfp_gl, max_att, then in the static
//     form dir (n_dir x 5), neu (n_neu x 6), chord (n_neu x 8); boxes
//     (n_box x 4), bands (n_band x 2), mixture (n_mix x 7), in the static
//     form vertices (n_vert x 8), then each field's parameters in field
//     order.
// ip: seed, max_steps, rounds, roulette, project, snap, n_src, has_source,
//     n_dir, n_neu, robin, majorant, n_box, n_band, clip, n_mix, freeze,
//     n_vert, table, delta, transport, then (kind, n_params) per field: bc,
//     alpha, sigma, sources[n_src if has_source]. A TERMS field's
//     parameters are its background, then TERM_COLS per term. More than
//     MAX_SRC sources or MAX_MIX mixture components launch the wide form,
//     whose sources from MAX_SRC on are dipoles, or of any kind but
//     K_GRID in the general rows build (which takes a launch with one
//     that is not a dipole). A bc of kind K_GRID (GRID_COLS parameters)
//     launches the grid form.
// planes: N_PLANES + N_WIDE_PLANES device pointers in
//     ops/walk_kernel.py::_PLANE_ORDER (the wide form's acc, asum and asq
//     planes of sources MAX_SRC.. last).
// thr: the freeze threshold of this launch (freeze builds; +inf = none).
// geom: N_GEOM device pointers: the table form's rows (dir, neu, vert;
//     16-byte aligned float4 rows, the vertices two per row), null in the
//     static form; the grid's (nx, ny) float32 nodes, null without one.
// seeds, n_shards, shard_lanes: the shard table, one int32 seed pattern
//     per shard (1 to MAX_SHARDS), shard s holding lanes [s shard_lanes,
//     (s + 1) shard_lanes), a multiple of THREADS when several (no freeze
//     build: the sharded loop never freezes); a launch of one solve passes
//     ip[0] and n_lanes.
// chunks: the Neumann rows' chunk records (CHUNK_F4 16-byte aligned
//     float4 per chunk of CHUNK_ROWS rows) in the culled_scans build, in
//     its large-table build followed by the first hit's group records
//     (CHUNK_F4 float4 per GROUP_CHUNKS chunks), the silhouette's chunk
//     records (SIL_F4 float4 per SIL_ROWS vertex rows) and their group
//     records (SIL_F4 per GROUP_CHUNKS chunks); the Dirichlet rows' chunk
//     records in the culled_closest build; null otherwise.
//
// offsets, records, n_walks: a dealt launch (walk_plan's offsets, n_walks
//     records of REC_SRC + n_src int32 words, its walks), which the host
//     asks for after walk_plan found the launch dealable; null, null, 0
//     otherwise (one thread a lane, or the repack loop).
// one field of kind `kind` and `n` parameters from fp[off..] into fd (a
// TERMS field's background; its terms into terms, their count n_terms),
// checked as the kernel reads it; false for a field it cannot read (a
// grid goes by its own rule)
static bool load_field(int kind, int n, const float* fp, int n_fp, int& off,
                       Field& fd, int& n_terms,
                       float (*terms)[TERM_COLS]) {
  const bool is_terms = kind == K_TERMS;
  if (n < 1 || n > (is_terms ? 1 + MAX_TERMS * TERM_COLS : MAX_FP) ||
      off + n > n_fp || (kind == K_CONST && n != 1) ||
      (kind == K_DIPOLE && n != 6) ||
      (kind == K_BUMPS && (n - 1) % 6 != 0) ||
      (is_terms && (n - 1) % TERM_COLS != 0) ||
      (kind != K_CONST && kind != K_BUMPS && kind != K_DIPOLE && !is_terms))
    return false;
  fd.kind = kind;
  fd.n = is_terms ? 1 : n;
  for (int k = 0; k < (is_terms ? 1 : n); ++k) fd.p[k] = fp[off++];
  if (is_terms) {
    n_terms = (n - 1) / TERM_COLS;
    for (int t = 0; t < n_terms; ++t) {
      for (int k = 0; k < TERM_COLS; ++k) terms[t][k] = fp[off++];
      for (int k = 21; k < TERM_COLS; k += 3) {  // the factors' kinds
        const float sk = terms[t][k];
        if (sk != F(S_NONE) && sk != F(S_SIN) && sk != F(S_COS)) return false;
      }
    }
  }
  return true;
}

#if WALK_ROWS
// a loaded TERMS source's pole record (cx, cy, amp, g), where the field is
// one Gaussian pole amp exp(-g |p - c|^2): background +0 (its bits), one
// term whose polynomial is its constant amp != 0 alone, ax = ay = 0,
// g != 0 and no sin or cos factor (ops/walk_kernel.py::pole_record, the
// same rule); false for any other field
static bool pole_record(const Field& fd, int n_terms,
                        const float (*terms)[TERM_COLS], float4& rec) {
  uint32_t bg;
  memcpy(&bg, &fd.p[0], sizeof bg);
  if (fd.kind != K_TERMS || bg != 0u || n_terms != 1) return false;
  const float* q = terms[0];
  for (int k = 1; k < 16; ++k)
    if (q[k] != F(0.0)) return false;
  if (q[0] == F(0.0) || q[16] != F(0.0) || q[17] != F(0.0) ||
      q[18] == F(0.0) || q[21] != F(S_NONE) || q[24] != F(S_NONE))
    return false;
  rec = make_float4(q[19], q[20], q[0], q[18]);
  return true;
}
#endif

static int put_header(const float* fp, int n_fp, const int* ip, int n_ip,
                      void* const* planes, int n_planes, int n_lanes,
                      void* const* geom, int n_geom, cudaStream_t st,
                      const int* seeds, int n_shards, int shard_lanes,
                      const void* chunks) {
  WalkConst h;  // pageable: the async copy stages it before returning
  memset(&h, 0, sizeof(h));
  if (n_ip < N_IP || n_fp < N_FP || n_planes != N_PLANES + N_WIDE_PLANES ||
      !seeds || n_shards < 1 || n_shards > MAX_SHARDS || shard_lanes < 1 ||
      n_lanes < 0 || (long long)n_shards * shard_lanes < n_lanes ||
      (n_shards > 1 && (WALK_FREEZE != 0 || shard_lanes % THREADS != 0)))
    return (int)cudaErrorInvalidValue;
  h.n_shards = n_shards;
  h.shard_lanes = shard_lanes;
  for (int k = 0; k < n_shards; ++k) h.shard_seed[k] = (uint32_t)seeds[k];
  if (n_shards == 1 && seeds[0] != ip[0]) return (int)cudaErrorInvalidValue;
  h.seed = (uint32_t)ip[0];
  h.max_steps = ip[1];
  h.rounds = ip[2];
  h.roulette = ip[3];
  h.project = ip[4];
  h.snap = ip[5];
  h.n_src = ip[6];
  h.has_source = ip[7];
  h.n_dir = ip[8];
  h.n_neu = ip[9];
  h.robin = ip[10];
  h.majorant = ip[11];
  h.n_box = ip[12];
  h.n_band = ip[13];
  h.clip = ip[14];
  h.n_mix = ip[15];
  const int freeze = ip[16];
  h.n_vert = ip[17];
  const int table = ip[18];
  const int delta = ip[19];
  const int transport = ip[20];
  h.eps = fp[0];
  h.rmin = fp[1];
  h.t_min = fp[2];
  h.sigma_bar = fp[3];
  h.roulette_thr = fp[4];
  h.gamma_floor = fp[5];
  h.arrival_clamp = fp[6];
  h.sb_bg = fp[7];
  h.mfp_bg = fp[8];
  h.mfp_gl = fp[9];
  h.max_att = fp[10];
  const int n_fields = 3 + (h.has_source ? h.n_src : 0);
  // the table form's rows lie in global memory, so any count goes but
  // one whose vertex index 2 v (two float4 a row) leaves an int
  const bool rows_fit =
      table ? h.n_vert < (1 << 30)
            : h.n_dir <= MAX_SEG && h.n_neu <= MAX_SEG && h.n_vert <= MAX_VERT;
  const bool wide = h.n_src > MAX_SRC || h.n_mix > MAX_MIX;
  if (h.n_src < 1 || h.n_src > MAX_WIDE_SRC || !rows_fit || table < 0 ||
      table > 1 || h.n_dir < 1 || h.n_neu < 0 || h.n_vert < 0 ||
      (h.n_vert && !h.n_neu) || h.rounds < 1 || n_geom != N_GEOM ||
      h.robin < ROBIN_OFF || h.robin > ROBIN_REFLECT ||
      (h.robin != ROBIN_OFF && h.n_neu < 1) || h.majorant < 0 ||
      h.majorant > 1 || h.n_box < 0 || h.n_box > MAX_BOXES ||
      h.n_band < 0 || h.n_band > MAX_BANDS ||
      (!h.majorant && (h.n_box || h.n_band)) || h.clip < 0 || h.clip > 1 ||
      h.n_mix < 0 || h.n_mix > MAX_WIDE_MIX || (h.n_mix && !h.has_source) ||
      freeze < 0 || freeze > 1 || delta < 0 || delta > 1 || transport < 0 ||
      transport > 1 || (transport && !delta) ||
      (!delta && (h.robin != ROBIN_OFF || h.majorant || h.roulette ||
                  h.clip)) ||
      n_ip != N_IP + 2 * n_fields)
    return (int)cudaErrorInvalidValue;
  // the Dirichlet field's kind picks the grid form, a TERMS field the
  // TERMS form of a variant that lacks the kind, a wide source that is not
  // a dipole the general rows build; the header's switches must be this
  // library's
  const int grid = ip[N_IP] == K_GRID;
  bool any_terms = false, rows = false;
  for (int f = 0; f < n_fields; ++f) {
    const int kind = ip[N_IP + 2 * f];
    any_terms = any_terms || kind == K_TERMS || kind == K_POLE;
    rows = rows || (f >= N_FIELDS && kind != K_DIPOLE);
  }
  const bool mis = h.n_mix > 0;
  const int switches[11] = {
      h.robin, h.majorant, mis, freeze, table, delta, transport, wide, grid,
      any_terms && !terms_fields(h.robin, h.majorant, mis, freeze, table,
                                 delta),
      rows};
  for (int k = 0; k < 11; ++k)
    if (switches[k] != BUILT[k]) return (int)cudaErrorInvalidValue;
  const int n_static = table ? 0 : 5 * h.n_dir + 14 * h.n_neu + 8 * h.n_vert;
  int off = N_FP;
  if (n_fp < off + n_static + 4 * h.n_box + 2 * h.n_band +
                 MIX_COLS * h.n_mix)
    return (int)cudaErrorInvalidValue;
  if (table) {
    h.tab_dir = (const float4*)geom[0];
    h.tab_neu = (const float4*)geom[1];
    h.tab_vert = (const float4*)geom[2];
    if (!h.tab_dir || (h.n_neu && !h.tab_neu) || (h.n_vert && !h.tab_vert))
      return (int)cudaErrorInvalidValue;
    for (int g = 0; g < 3; ++g)
      if ((uintptr_t)geom[g] % 16) return (int)cudaErrorMisalignedAddress;
    if (CULLED_CLOSEST) {  // the Dirichlet rows' chunk records
      if (!chunks) return (int)cudaErrorInvalidValue;
      if ((uintptr_t)chunks % 16) return (int)cudaErrorMisalignedAddress;
      h.chunk = (const float4*)chunks;
    }
    if ((CULLED || CULLED_CHORD) && h.n_neu > 0) {  // no Neumann row: none
      if (!chunks) return (int)cudaErrorInvalidValue;
      if ((uintptr_t)chunks % 16) return (int)cudaErrorMisalignedAddress;
      h.chunk = (const float4*)chunks;
#if WALK_LARGE
      const int n_ch = (h.n_neu + CHUNK_ROWS - 1) / CHUNK_ROWS;
      const int n_sil = (h.n_vert + SIL_ROWS - 1) / SIL_ROWS;
      h.hit_group = h.chunk + CHUNK_F4 * n_ch;
      h.sil_chunk =
          h.hit_group + CHUNK_F4 * ((n_ch + GROUP_CHUNKS - 1) / GROUP_CHUNKS);
      h.sil_group = h.sil_chunk + SIL_F4 * n_sil;
#endif
    }
  } else {
    for (int s = 0; s < h.n_dir; ++s)
      for (int k = 0; k < 5; ++k) h.dir[s][k] = fp[off++];
    for (int s = 0; s < h.n_neu; ++s)
      for (int k = 0; k < 6; ++k) h.neu[s][k] = fp[off++];
    for (int s = 0; s < h.n_neu; ++s)
      for (int k = 0; k < 8; ++k) h.chord[s][k] = fp[off++];
  }
  for (int b = 0; b < h.n_box; ++b)
    for (int k = 0; k < 4; ++k) h.box[b][k] = fp[off++];
  for (int b = 0; b < h.n_band; ++b)
    for (int k = 0; k < 2; ++k) h.band[b][k] = fp[off++];
  for (int c = 0; c < h.n_mix; ++c)
    for (int k = 0; k < MIX_COLS; ++k)
      (wide ? h.wmix[c][k] : h.mix[c][k]) = fp[off++];
  if (!table)
    for (int v = 0; v < h.n_vert; ++v)
      for (int k = 0; k < 8; ++k) h.vert[v][k] = fp[off++];
  for (int f = 0; f < n_fields; ++f) {
    int kind = ip[N_IP + 2 * f];
    const int n = ip[N_IP + 1 + 2 * f];
    // a source marked as a pole: a TERMS field, which must be one pole (a
    // mark on any other field, or outside the general rows build, is
    // refused: a marked source never takes the general text)
    const bool pole = kind == K_POLE;
    if (pole) {
      if (!WALK_ROWS || f < F_SRC0) return (int)cudaErrorInvalidValue;
      kind = K_TERMS;
    }
    if (f >= N_FIELDS) {  // the wide form's rows
#if WALK_ROWS
      WideRow& w = h.wrow[f - N_FIELDS];
      if (!load_field(kind, n, fp, n_fp, off, w.f, w.n_terms, w.terms) ||
          (pole && !pole_record(w.f, w.n_terms, w.terms, h.pole[f - F_SRC0])))
        return (int)cudaErrorInvalidValue;
      if (pole) h.pole_mask |= 1u << (f - F_SRC0);
#else
      if (kind != K_DIPOLE || n != DIPOLE_COLS || off + n > n_fp)
        return (int)cudaErrorInvalidValue;
      for (int k = 0; k < n; ++k) h.wsrc[f - N_FIELDS][k] = fp[off++];
#endif
      continue;
    }
    if (kind == K_GRID) {  // the Dirichlet field only, nodes by geom[3]
      if (f != F_BC || n != GRID_COLS || off + n > n_fp || !geom[3] ||
          (uintptr_t)geom[3] % 4)
        return (int)cudaErrorInvalidValue;
      h.field[f].kind = kind;
      h.field[f].n = n;
      for (int k = 0; k < n; ++k) h.field[f].p[k] = fp[off++];
      const float* p = h.field[f].p;
      if (!(p[6] >= F(2.0) && p[7] >= F(2.0) && p[6] == (float)(int)p[6] &&
            p[7] == (float)(int)p[7] && p[6] * p[7] <= F(16777216.0) &&
            p[1] > F(0.0) && p[3] > F(0.0) && p[4] >= F(0.0) &&
            p[4] <= p[6] - F(1.0) && p[5] >= F(0.0) &&
            p[5] <= p[7] - F(1.0)))
        return (int)cudaErrorInvalidValue;
      h.grid = (const float*)geom[3];
      continue;
    }
    if (!load_field(kind, n, fp, n_fp, off, h.field[f], h.n_terms[f],
                    h.terms[f]))
      return (int)cudaErrorInvalidValue;
#if WALK_ROWS
    if (pole) {
      if (!pole_record(h.field[f], h.n_terms[f], h.terms[f],
                       h.pole[f - F_SRC0]))
        return (int)cudaErrorInvalidValue;
      h.pole_mask |= 1u << (f - F_SRC0);
    }
#endif
  }
  if (off != n_fp) return (int)cudaErrorInvalidValue;

  Planes& pl = h.pl;
  int q = 0;
  pl.p0x = (const float*)planes[q++];
  pl.p0y = (const float*)planes[q++];
  pl.sid = (const int*)planes[q++];
  pl.ob0 = (const int*)planes[q++];
  pl.n0x = (const float*)planes[q++];
  pl.n0y = (const float*)planes[q++];
  pl.px = (float*)planes[q++];
  pl.py = (float*)planes[q++];
  pl.nx = (float*)planes[q++];
  pl.ny = (float*)planes[q++];
  pl.atten = (float*)planes[q++];
  for (int i = 0; i < MAX_SRC; ++i) pl.acc[i] = (float*)planes[q++];
  for (int i = 0; i < MAX_SRC; ++i) pl.asum[i] = (float*)planes[q++];
  for (int i = 0; i < MAX_SRC; ++i) pl.asq[i] = (float*)planes[q++];
  pl.quota = (int*)planes[q++];
  pl.steps = (int*)planes[q++];
  pl.ndone = (int*)planes[q++];
  pl.ob = (int*)planes[q++];
  pl.life = (int*)planes[q++];
  pl.tn = (float*)planes[q++];
  pl.tw = (float*)planes[q++];
  pl.wmax = (float*)planes[q++];
  pl.bmax = (float*)planes[q++];
  if (!pl.p0x || !pl.p0y || !pl.sid || !pl.px || !pl.quota || !pl.bmax ||
      (h.snap && (!pl.ob0 || !pl.n0x || !pl.n0y)))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < MAX_WIDE_SRC; ++i) {
    const int w = i - MAX_SRC;  // the wide planes' index
    h.wacc[i] = i < MAX_SRC ? pl.acc[i] : (float*)planes[q + w];
    h.wasum[i] = i < MAX_SRC ? pl.asum[i]
                             : (float*)planes[q + (MAX_WIDE_SRC - MAX_SRC) + w];
    h.wasq[i] = i < MAX_SRC
                    ? pl.asq[i]
                    : (float*)planes[q + 2 * (MAX_WIDE_SRC - MAX_SRC) + w];
  }
  for (int i = 0; i < h.n_src; ++i)
    if (!h.wacc[i] || !h.wasum[i] || !h.wasq[i])
      return (int)cudaErrorInvalidValue;

  // a narrow launch reads no wide field, so its copy skips them, and
  // every launch copies only the seeds of its shards (and in the general
  // rows build the rows of its sources): the copy is part of every
  // launch's host time
  const size_t n_end =
      offsetof(WalkConst, shard_seed) + sizeof(uint32_t) * (size_t)n_shards;
#if WALK_ROWS
  const size_t n_head = offsetof(WalkConst, wrow) +
                        sizeof(WideRow) * (size_t)(n_fields - N_FIELDS);
#else
  const size_t n_head = wide ? n_end : offsetof(WalkConst, wsrc);
#endif
  cudaError_t e =
      cudaMemcpyToSymbolAsync(C, &h, n_head, 0, cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  if (WALK_ROWS || !wide) {  // the grid's pointer, the chunks and the
                             // shard table, or the shard table after rows
    const size_t off = WALK_ROWS ? offsetof(WalkConst, n_shards)
                                 : offsetof(WalkConst, grid);
    e = cudaMemcpyToSymbolAsync(C, (const char*)&h + off, n_end - off, off,
                                cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int walk_launch(const float* fp, int n_fp, const int* ip,
                           int n_ip, void* const* planes, int n_planes,
                           int n_lanes, int budget, float thr,
                           void* const* geom, int n_geom, void* stream,
                           const int* seeds, int n_shards, int shard_lanes,
                           const void* chunks, const int* offsets,
                           int* records, int n_walks) {
  cudaStream_t st = (cudaStream_t)stream;
  const int fault =
      put_header(fp, n_fp, ip, n_ip, planes, n_planes, n_lanes, geom, n_geom,
                 st, seeds, n_shards, shard_lanes, chunks);
  if (fault) return fault;
  if (records) {
    if (!DEALT || n_shards != 1 || !offsets || n_walks < 1 || n_lanes < 1)
      return (int)cudaErrorInvalidValue;
    return launch_dealt(st, n_lanes, offsets, records, n_walks);
  }
  if (n_lanes > 0 && budget > 0) {
    if (REPACKED) {  // the repack loop's pool starts at lane 0 (the
                     // current card's, as the constant block above)
      static const unsigned int zero = 0;
      const cudaError_t e = cudaMemcpyToSymbolAsync(
          next_lane, &zero, sizeof zero, 0, cudaMemcpyHostToDevice, st);
      if (e != cudaSuccess) return (int)e;
    }
    const int grid = (n_lanes + BLOCK - 1) / BLOCK;
    if constexpr (WALK_FREEZE == 0) {
      if (n_shards > 1) {
        launch_built<true>(grid, st, n_lanes, budget, thr);
        return (int)cudaGetLastError();
      }
    }
    launch_built<false>(grid, st, n_lanes, budget, thr);
  }
  return (int)cudaGetLastError();
}

// the plan of a dealt launch of this library's walk_variant.h::dealt build
// over the planes (walk_launch's first sixteen arguments, of which it
// reads the header, the planes and the lanes): offsets (n_lanes + 1
// int32: each lane's first record, then the walks), tiles (3 int64 a tile
// of PLAN_THREADS lanes) and stats (3 int32: the walks, or -1 past
// INT32_MAX; the largest quota; the lanes with quota not at a walk's
// start), on the launch's stream
extern "C" int walk_plan(const float* fp, int n_fp, const int* ip, int n_ip,
                         void* const* planes, int n_planes, int n_lanes,
                         int budget, float thr, void* const* geom,
                         int n_geom, void* stream, const int* seeds,
                         int n_shards, int shard_lanes, const void* chunks,
                         int* offsets, long long* tiles, int* stats) {
  (void)budget;
  (void)thr;
  if (!DEALT || n_shards != 1 || n_lanes < 1 || !offsets || !tiles ||
      !stats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int fault =
      put_header(fp, n_fp, ip, n_ip, planes, n_planes, n_lanes, geom, n_geom,
                 st, seeds, n_shards, shard_lanes, chunks);
  if (fault) return fault;
  return plan_dealt(st, n_lanes, offsets, tiles, stats);
}
