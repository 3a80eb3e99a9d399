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
// Variants are compile-time: walk_kernel<ROBIN, MAJ, MIS, FREEZE, TABLE>,
// and the host picks one per launch. Only the combinations a path
// launches are instantiated (walk_pick below;
// ops/walk_kernel.py::KERNEL_VARIANTS holds the same list):
//   <OFF,   false, false, false, false>  the survey's main path
//   <OFF,   false, true,  false, false>  the survey with source_mis
//   <OFF,   true,  false, false, false>  the majorant with Robin off
//   <CHAIN, false, false, false, false>  the chord chain
//   <CHAIN, true,  false, false, false>  the accuracy path
//   <CHAIN, true,  true,  true,  false>  the flagship gate (chain +
//                                        majorant + MIS + freeze, under
//                                        the host launch loop)
//   <REFLECT, false|true, false, false, false>  the reflectance fold
//   <OFF,   false, false, false, true >  the topographic survey
//   <CHAIN, false, false, false, true >  the chain on a terrain
// walk_kernel<ROBIN_OFF, false, false, false, false> carries none of the
// other variants' code or registers. max_attenuation is a run-time switch
// (three selects per step) in every instantiation.
//
// Geometry forms (TABLE), chosen on the host by the TPU kernel's rule
// (boundary segments plus interior vertices <= 96: static). The static
// form reads __constant__ tables whose edge vectors, normals and
// silhouette edges were formed on the host in float64 and rounded once,
// and its first hit multiplies by 1/den, as the TPU kernel's register
// unroll does. The table form reads float32 endpoint rows (up to 8192
// rows in all) from global memory and forms edges, normals and chord
// tangents per step in float32, dividing in the first hit, as the TPU
// kernel's SMEM loops do; the two arithmetics differ by an ulp, which
// desynchronizes walks, so each form copies its reference. Every thread
// of a warp reads the same row in the same iteration and the trip counts
// are uniform, so the read-only loads are L1 broadcasts and the loops do
// not diverge; a row's normal or chord tangent (a sqrt and two divides)
// is formed only when the row wins. The table loops dominate the step on
// the topographic survey (~200 first-hit and ~199 silhouette rows):
// FP32 and divide throughput bound them, not bytes. A boundary without
// vertices never enters the silhouette loop.
//
// Design: one thread per walker lane. A thread loads its lane's planes
// into registers once, runs `for (i < budget && quota > 0)` steps, and
// writes back once, so the ~23 planes x 4 B move once per launch. The
// work is bound by FP32 and SFU throughput per step (Bessel polynomials,
// sqrt/log/exp/sin/cos, the segment scans), not by memory. A lane whose
// quota drains exits on its own; that is exact, because a step of a lane
// without quota changes nothing (the TPU kernel's per-block exit relies on
// the same fact). Threads of a warp whose quota drained idle while the
// rest of the warp walks on: that divergence is what a later change
// should attack (lane recycling across warps). On the accuracy path the
// chord mass (a Bessel-integral series per shrink round) runs only on
// lanes standing on the wall, and the chord branch's extra work (frame
// scan, three field evaluations, a screened Green's function) only on
// lanes that take the branch, a few percent of wall visits.
//
// MIS adds per step, on every stepping lane (not only those whose radius
// stays inside the star, so it adds work but no divergence): four more
// hash draws, a component pick, a Box-Muller offset (one logf, one sqrtf,
// cosf and sinf), the screened Green's function at the sample (two K0 and
// two I0: a logf and up to three expf) and its norm, a first-hit scan
// along the sample direction (the star test), one expf per mixture
// component, a third alpha_c, and the sources at the sample. That is FP32
// and SFU work again, not bytes. The freeze is a per-thread exit: the TPU
// kernel runs its block until no lane is steppable (:1183-1203); here a
// thread leaves its loop once its own lane's |atten| passes the launch's
// threshold, after the bank/recycle of that step. That is exact: a frozen
// lane draws nothing, advances no counter and does not move, and
// walk_done is decided before the freeze test, so a lane that is frozen
// and not done stays so for the rest of the launch. Frozen lanes thus
// cost nothing; the threshold is a launch argument (no rebuild per
// launch).
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
// Build: one library per instantiation, all compiled at once. With
// -DWALK_PART=<code> the unit keeps only the instantiation whose walk_pick
// code is <code> (ops/walk_kernel.py::variant_code); without it, every
// instantiation (one library, as a host build for rehearsal compiles it).
//
// Interface: plain C (walk_launch), loaded with ctypes. Parameters and
// plane pointers go to __constant__ memory with an async copy on the
// launch stream, so launches on one stream are ordered; two streams must
// not launch concurrently.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifndef WALK_PART
#define WALK_PART -1
#endif

#define F(x) ((float)(x))

namespace {

constexpr int MAX_SEG = 96;    // static form, per boundary
constexpr int MAX_VERT = 96;   // static form, silhouette vertices
constexpr int MAX_TABLE = 8192;  // table form, all rows
constexpr int MAX_SRC = 4;
constexpr int MAX_BUMPS = 8;
constexpr int MAX_FP = 1 + 6 * MAX_BUMPS;
constexpr int F_BC = 0, F_ALPHA = 1, F_SIGMA = 2, F_SRC0 = 3;
constexpr int N_FIELDS = 3 + MAX_SRC;
constexpr int K_CONST = 0, K_BUMPS = 1, K_DIPOLE = 2;
constexpr int N_PLANES = 6 + 5 + 3 * MAX_SRC + 9;
constexpr int THREADS = 128;
constexpr int MAX_BOXES = 8, MAX_BANDS = 8;  // problems/majorant.py
constexpr int ROBIN_OFF = 0, ROBIN_CHAIN = 1, ROBIN_REFLECT = 2;
constexpr int MAX_MIX = 8;   // MIS mixture components
constexpr int MIX_COLS = 7;  // cx, cy, w, a, cum, 2 w^2, 2 pi w^2
constexpr int N_IP = 19, N_FP = 11;  // header lengths of ip and fp
constexpr int N_GEOM = 3;  // table form: dir, neu, vert row pointers

struct Field {
  int kind;
  int n;
  float p[MAX_FP];
};

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
  uint32_t seed;
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
};

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

__device__ float field_value(int f, float x, float y) {
  const Field& fd = C.field[f];
  const float* p = fd.p;
  if (fd.kind == K_CONST) return p[0] + F(0.0) * x;
  if (fd.kind == K_DIPOLE) {
    float epx = x - p[0], epy = y - p[1], enx = x - p[2], eny = y - p[3];
    float dp = epx * epx + epy * epy;
    float dn = enx * enx + eny * eny;
    return p[4] * (expf(-dp / p[5]) - expf(-dn / p[5]));
  }
  float total = p[0] + F(0.0) * x;
  const int nb = (fd.n - 1) / 6;
  for (int b = 0; b < nb; ++b) {
    const float* q = p + 1 + 6 * b;  // amp, cx, cy, radius, k, w2
    float ex = x - q[1], ey = y - q[2];
    float rho = sqrtf((ex * ex + ey * ey) + q[5]);
    total = total + q[0] * sigmoid(-q[4] * (rho - q[3]));
  }
  return total;
}

__device__ __forceinline__ float alpha_c(float x, float y) {
  return fmaxf(field_value(F_ALPHA, x, y), F(1e-8));
}

// alpha_c = max(alpha, 1e-8) with its gradient (and, for LAP, Laplacian),
// zero where the clamp is active: hand-derived derivatives of the bump sum
// (fields.BumpSum.value_grad_lap, fields._alpha_parts)
template <bool LAP>
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
  }
  bool live = a > F(1e-8);
  ac = fmaxf(a, F(1e-8));
  if (!live) { gx = F(0.0); gy = F(0.0); lap = F(0.0); }
}

// sigma' = sigma/a + (lap a / a - |grad ln a|^2 / 2) / 2
__device__ float sigma_prime(float x, float y) {
  float ac, gx, gy, lap;
  alpha_parts<true>(x, y, ac, gx, gy, lap);
  float la = ac + F(1e-8);
  float glx = gx / la, gly = gy / la;
  float gn2 = glx * glx + gly * gly;
  return field_value(F_SIGMA, x, y) / ac +
         F(0.5) * (lap / ac - gn2 / F(2.0));
}

// grad ln(alpha_c + 1e-8) (fields.grad_log_alpha_fn)
__device__ void grad_log_alpha(float x, float y, float& glx, float& gly) {
  float ac, gx, gy, lap;
  alpha_parts<false>(x, y, ac, gx, gy, lap);
  float la = ac + F(1e-8);
  glx = gx / la;
  gly = gy / la;
}

// ---- geometry of the accuracy path --------------------------------------

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

// the first Neumann hit along (dx, dy) at t >= tmw: its distance (3e38 for
// none), the winning segment's CCW normal and the on-segment hit point;
// _first_hit_unrolled (reciprocal multiply, host normals) /
// _first_hit_smem (divides, normals formed in float32)
template <bool TABLE>
__device__ __forceinline__ float first_hit(float px, float py, float dx,
                                           float dy, float tmw, float& fnx,
                                           float& fny, float& hxs,
                                           float& hys) {
  float t_best = F(3e38);
  fnx = F(0.0);
  fny = F(0.0);
  hxs = F(0.0);
  hys = F(0.0);
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
  return first_hit<TABLE>(px, py, dx, dy, tmw, fnx, fny, hxs, hys);
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

// ---- the walk ------------------------------------------------------------

template <int ROBIN, bool MAJ, bool MIS, bool FREEZE, bool TABLE>
__global__ void __launch_bounds__(THREADS)
walk_kernel(int n_lanes, int budget, float freeze_thr) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  const Planes& P = C.pl;
  int quota = P.quota[lane];
  if (quota <= 0 || budget <= 0) return;  // a no-op lane: nothing to write

  const int n_src = C.n_src;
  const uint32_t seed = C.seed;
  const uint32_t sid = (uint32_t)P.sid[lane];
  const float p0x = P.p0x[lane], p0y = P.p0y[lane];
  const bool snap = C.snap != 0;
  const bool ob0 = snap ? P.ob0[lane] != 0 : false;
  const float n0x = snap ? P.n0x[lane] : F(0.0);
  const float n0y = snap ? P.n0y[lane] : F(0.0);

  float px = P.px[lane], py = P.py[lane], nx = P.nx[lane], ny = P.ny[lane];
  float atten = P.atten[lane];
  float acc[MAX_SRC], asum[MAX_SRC], asq[MAX_SRC];
#pragma unroll
  for (int i = 0; i < MAX_SRC; ++i) {
    acc[i] = i < n_src ? P.acc[i][lane] : F(0.0);
    asum[i] = i < n_src ? P.asum[i][lane] : F(0.0);
    asq[i] = i < n_src ? P.asq[i][lane] : F(0.0);
  }
  int steps = P.steps[lane], ndone = P.ndone[lane], life = P.life[lane];
  bool ob = P.ob[lane] != 0;
  float tn = P.tn[lane], tw = P.tw[lane], wmax = P.wmax[lane];
  float bmax = P.bmax[lane];

  const float eps = C.eps, rmin = C.rmin, t_min = C.t_min;
  const float sigma_bar = C.sigma_bar;
  const int max_steps = C.max_steps;
  const float a_p0 = alpha_c(p0x, p0y);
  float a_cur = alpha_c(px, py);

  for (int it = 0; it < budget && quota > 0; ++it) {
    const uint32_t ctr =
        (uint32_t)ndone * (uint32_t)(max_steps + 2) + (uint32_t)steps;
    const uint32_t base = hash_base(seed, ctr);
    const float u1 = uni(base, sid, 1);
    const float u4 = uni(base, sid, 4);

    float cx, cy;
    const float dD = closest_point<TABLE>(px, py, cx, cy);
    const bool done_eps = dD <= eps;

    if (done_eps || steps >= max_steps) {
      // bank the walk, then recycle the slot into its next walk; the rest
      // of this step is masked off for the lane
      float bx = (C.project && done_eps) ? cx : px;
      float by = (C.project && done_eps) ? cy : py;
      float g_bc = field_value(F_BC, bx, by) * atten;
      float bank_mag = F(0.0);
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
      bmax = fmaxf(bmax, bank_mag);
      ndone += 1;
      quota -= 1;
      if (!done_eps && fabsf(atten) > F(0.0)) {
        tn = tn + F(1.0);
        tw = tw + fabsf(atten);
      }
      px = p0x;
      py = p0y;
      atten = F(1.0);
      if (snap) {
        ob = ob0;
        nx = n0x;
        ny = n0y;
      } else {
        ob = false;
      }
      steps = 0;
      a_cur = a_p0;
      continue;
    }
    if constexpr (FREEZE) {
      // a heavy lane waits for the launch-boundary split instead of
      // compounding further: a fixed point for the rest of the launch
      if (!(fabsf(atten) <= freeze_thr)) break;
    }

    // the star radius stops at the nearest silhouette vertex
    float r = fmaxf(rmin, C.n_vert > 0
                              ? fminf(dD, silhouette<TABLE>(px, py))
                              : dD);
    float sbar = sigma_bar;
    if constexpr (MAJ) {
      // two-level local majorant: shrink the ball out of the high-sigma'
      // regions and walk at the background majorant where that promises
      // more progress min(radius, 1/sqrt(sigma_bar))
      const float d_far = majorant_distance(px, py);
      const float rB = fminf(r, d_far);
      if (d_far >= rmin && fminf(rB, C.mfp_bg) > fminf(r, C.mfp_gl)) {
        r = rB;
        sbar = C.sb_bg;
      }
    }
    // on-boundary Robin chord mass c = 4 gamma J(r), the radius shrunk
    // until |c| <= 1/2: the chain's branch rate, or the reflectance fold
    float c_mag = F(0.0);
    if constexpr (ROBIN != ROBIN_OFF) {
      if (ob) {
        float glx0, gly0;
        grad_log_alpha(px, py, glx0, gly0);
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
        if constexpr (ROBIN == ROBIN_REFLECT) {
          const float c_ch =
              fminf(fmaxf(F(4.0) * gamma0 * chord_j, F(-0.9)), F(0.9));
          atten = atten / (F(1.0) - c_ch);
        }
      }
    }

    // one sin/cos pair: free direction at 2 phi, hemisphere at phi
    const float phi = F(3.141592653589793) * u1;
    const float cphi = cosf(phi), sphi = sinf(phi);
    float dx = F(1.0) - F(2.0) * sphi * sphi;
    float dy = F(2.0) * sphi * cphi;

    float hx, hy, hnx = F(0.0), hny = F(0.0), t_hit = r;
    bool hit = false;
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
          first_hit<TABLE>(px, py, dx, dy, tmw, fnx, fny, hxs, hys);
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

    float w_rej;
    const float r_s =
        screened_radius(r, sbar, seed, ctr, sid, C.rounds, w_rej);
    atten = atten * w_rej;
    const bool beyond = r_s > t_hit;
    const float sx = beyond ? hx : px + r_s * dx;
    const float sy = beyond ? hy : py + r_s * dy;

    const float a_p = a_cur;
    const float a_s = alpha_c(sx, sy);
    if constexpr (!MIS) {
      if (C.has_source && !beyond) {
        const float w_src =
            screened_norm(r, sbar) / sqrtf(a_s * a_p) * atten;
#pragma unroll
        for (int i = 0; i < MAX_SRC; ++i)
          if (i < n_src)
            acc[i] = acc[i] + field_value(F_SRC0 + i, sx, sy) * w_src;
      }
    } else {
      // source-directed MIS NEE: y from 0.5 ball-Green's + 0.5 the
      // static Gaussian mixture, weighted by the balance heuristic; the
      // component pick is the unrolled rule idx = #{i < k-1 : u6 > cum_i}
      const float u5 = uni(base, sid, 5), u6 = uni(base, sid, 6);
      const float u7 = uni(base, sid, 7), u8 = uni(base, sid, 8);
      float mx = C.mix[0][0], my = C.mix[0][1], mw = C.mix[0][2];
      for (int ci = 1; ci < C.n_mix; ++ci) {
        if (u6 > C.mix[ci - 1][4]) {
          mx = C.mix[ci][0];
          my = C.mix[ci][1];
          mw = C.mix[ci][2];
        }
      }
      const float rad = sqrtf(F(-2.0) * logf(fmaxf(u7, F(1e-12))));
      const float ang = F(TWO_PI) * u8;
      mx = mx + mw * rad * cosf(ang);
      my = my + mw * rad * sinf(ang);
      const bool take_src = u5 < F(0.5);
      const float yx = take_src ? mx : px + r_s * dx;
      const float yy = take_src ? my : py + r_s * dy;
      const float ex = yx - px, ey = yy - py;
      const float d_y = sqrtf(ex * ex + ey * ey);
      const float d_safe = fmaxf(d_y, F(1e-12));
      const float g_val = fmaxf(screened_greens(d_safe, r, sbar), F(0.0));
      const float norm = screened_norm(r, sbar);
      const bool in_ball = d_y < r;
      bool in_star = in_ball;
      if (C.n_neu > 0)  // a wall between x and y blocks the sample
        in_star = in_ball &&
                  !(first_hit_t<TABLE>(px, py, ex / d_safe, ey / d_safe,
                                       ob ? t_min : F(0.0)) < d_y);
      float q = F(0.0);  // the mixture pdf, one expf per component
      for (int ci = 0; ci < C.n_mix; ++ci) {
        const float* m = C.mix[ci];
        const float qx = yx - m[0], qy = yy - m[1];
        q = q + m[3] * expf(-(qx * qx + qy * qy) / m[5]) / m[6];
      }
      // an on-boundary walker samples a hemisphere: double its density
      const float m_ob = ob ? F(2.0) : F(1.0);
      const float p_ball = in_ball ? m_ob * g_val / norm : F(0.0);
      const float p_mix = F(0.5) * p_ball + F(0.5) * q;
      float w_mis = (in_star && p_mix > F(1e-30))
                        ? m_ob * g_val / fmaxf(p_mix, F(1e-30))
                        : F(0.0);
      const float a_y = alpha_c(yx, yy);
      w_mis = w_mis / sqrtf(a_y * a_p) * atten;
#pragma unroll
      for (int i = 0; i < MAX_SRC; ++i)
        if (i < n_src)
          acc[i] = acc[i] + field_value(F_SRC0 + i, yx, yy) * w_mis;
    }

    const bool interior = u4 < interior_prob(r, sbar);
    const bool collide = interior && !(hit && (r_s >= t_hit - t_min));
    const float atten_pre = atten;  // chord-branch lanes skip the scale
    float a_next, newx, newy;
    if (collide) {
      // signed null-collision factor: no zero clamp
      const float scale_int =
          sqrtf(a_s / a_p) * (F(1.0) - sigma_prime(sx, sy) / sbar);
      atten = atten * scale_int;
      newx = sx;
      newy = sy;
      a_next = a_s;
    } else {
      const float a_h = alpha_c(hx, hy);
      float scale_edge = sqrtf(a_h / a_p);
      if constexpr (ROBIN != ROBIN_OFF) {
        if (hit) {
          // Robin wall-arrival weight 1 + gamma rho / cos(phi): signed,
          // the grazing cosine clamped
          float glx, gly;
          grad_log_alpha(hx, hy, glx, gly);
          const float gamma = F(-0.5) * (hnx * glx + hny * gly);
          const float cosphi = fmaxf(-(dx * hnx + dy * hny), C.arrival_clamp);
          const float rho = wall_ratio(t_hit, r, sbar);
          scale_edge = scale_edge * (F(1.0) + gamma * rho / cosphi);
        }
      }
      atten = atten * scale_edge;
      newx = hx;
      newy = hy;
      a_next = a_h;
    }
    bool new_ob = hit && !collide;
    bool branch = false;
    if constexpr (ROBIN == ROBIN_CHAIN) {
      if (ob) {
        // chord continuation along the wall: branch with q = min(1/2, |c|)
        // to z = x + zeta t_hat, weight 2 gamma(z) G_s / p_mix / q; the
        // other wall lanes pay 1 / (1 - q)
        const float q_c = fminf(F(0.5), c_mag);
        branch = uni(base, sid, 9) < q_c && q_c > F(1e-6);
        if (branch) {
          const float u10 = uni(base, sid, 10), u11 = uni(base, sid, 11);
          const float q_scr = sqrtf(fmaxf(sbar, F(1e-12)));
          const float side = u10 < F(0.5) ? F(-1.0) : F(1.0);
          const float v = fabsf(F(2.0) * u10 - F(1.0));
          const float u2 = fabsf(F(2.0) * u11 - F(1.0));
          const float z_log = r * fmaxf(v * u2, F(1e-12));
          const float trunc = F(1.0) - expf(-q_scr * r);
          const float z_exp =
              -logf(fmaxf(F(1.0) - v * trunc, F(1e-12))) / q_scr;
          const float az = fminf(u11 < F(0.5) ? z_log : z_exp, r);
          const float zeta = side * az;
          const float p_log = -logf(fmaxf(az / r, F(1e-12))) / (F(2.0) * r);
          const float p_exp = q_scr * expf(-q_scr * az) /
                              (F(2.0) * fmaxf(trunc, F(1e-12)));
          const float p_mix = F(0.5) * (p_log + p_exp);
          const float g_ch = fmaxf(screened_greens(az, r, sbar), F(0.0));
          float t_cx, t_cy, s_lo, s_hi;
          chord_frame<TABLE>(px, py, t_cx, t_cy, s_lo, s_hi);
          const float zx = px + zeta * t_cx, zy = py + zeta * t_cy;
          float glxz, glyz;
          grad_log_alpha(zx, zy, glxz, glyz);
          const float gamma_z = F(-0.5) * (nx * glxz + ny * glyz);
          const float a_z = alpha_c(zx, zy);
          float w_ch = F(2.0) * gamma_z * g_ch / fmaxf(p_mix, F(1e-30)) *
                       sqrtf(a_z / a_p);
          if (!(zeta >= s_lo && zeta <= s_hi)) w_ch = F(0.0);
          atten = atten_pre * w_ch / fmaxf(q_c, F(1e-6));
          newx = zx;
          newy = zy;
          a_next = a_z;
          new_ob = true;
        } else if (q_c > F(1e-6)) {
          atten = atten * (F(1.0) / (F(1.0) - q_c));
        }
      }
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
        if (!survive) steps = max_steps;
      }
    }
    life += 1;
    wmax = fmaxf(wmax, fabsf(atten));
    a_cur = a_next;
  }

  P.px[lane] = px;
  P.py[lane] = py;
  P.nx[lane] = nx;
  P.ny[lane] = ny;
  P.atten[lane] = atten;
#pragma unroll
  for (int i = 0; i < MAX_SRC; ++i) {
    if (i < n_src) {
      P.acc[i][lane] = acc[i];
      P.asum[i][lane] = asum[i];
      P.asq[i][lane] = asq[i];
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

}  // namespace

typedef void (*LaunchFn)(int, cudaStream_t, int, int, float);

template <int ROBIN, bool MAJ, bool MIS, bool FREEZE, bool TABLE>
void launch(int grid, cudaStream_t st, int n_lanes, int budget, float thr) {
  walk_kernel<ROBIN, MAJ, MIS, FREEZE, TABLE><<<grid, THREADS, 0, st>>>(
      n_lanes, budget, thr);
}

// instantiation CODE of this unit: compiled only in the unit of its part
template <int CODE, int ROBIN, bool MAJ, bool MIS, bool FREEZE, bool TABLE>
LaunchFn pick() {
  if constexpr (WALK_PART < 0 || WALK_PART == CODE)
    return launch<ROBIN, MAJ, MIS, FREEZE, TABLE>;
  else
    return nullptr;
}

#define WALK_CASE(code, ...) \
  case code:                 \
    return pick<code, __VA_ARGS__>()

// the instantiated variants (head comment), by (robin, majorant, mis,
// freeze, table); nullptr for a combination no path launches, or one
// another part's library holds
LaunchFn walk_pick(int robin, int majorant, int mis, int freeze,
                   int table) {
  switch ((((robin * 2 + majorant) * 2 + mis) * 2 + freeze) * 2 + table) {
    WALK_CASE(0, ROBIN_OFF, false, false, false, false);
    WALK_CASE(1, ROBIN_OFF, false, false, false, true);
    WALK_CASE(4, ROBIN_OFF, false, true, false, false);
    WALK_CASE(8, ROBIN_OFF, true, false, false, false);
    WALK_CASE(16, ROBIN_CHAIN, false, false, false, false);
    WALK_CASE(17, ROBIN_CHAIN, false, false, false, true);
    WALK_CASE(24, ROBIN_CHAIN, true, false, false, false);
    WALK_CASE(30, ROBIN_CHAIN, true, true, true, false);
    WALK_CASE(32, ROBIN_REFLECT, false, false, false, false);
    WALK_CASE(40, ROBIN_REFLECT, true, false, false, false);
    default: return nullptr;
  }
}

// fp: eps, rmin, t_min, sigma_bar, roulette_thr, gamma_floor,
//     arrival_clamp, sb_bg, mfp_bg, mfp_gl, max_att, then in the static
//     form dir (n_dir x 5), neu (n_neu x 6), chord (n_neu x 8); boxes
//     (n_box x 4), bands (n_band x 2), mixture (n_mix x 7), in the static
//     form vertices (n_vert x 8), then each field's parameters in field
//     order.
// ip: seed, max_steps, rounds, roulette, project, snap, n_src, has_source,
//     n_dir, n_neu, robin, majorant, n_box, n_band, clip, n_mix, freeze,
//     n_vert, table, then (kind, n_params) per field: bc, alpha, sigma,
//     sources[n_src if has_source].
// planes: N_PLANES device pointers in ops/walk_kernel.py::_PLANE_ORDER.
// thr: the freeze threshold of this launch (freeze builds; +inf = none).
// geom: N_GEOM device pointers of the table form's rows (dir, neu, vert;
//     16-byte aligned float4 rows, the vertices two per row), null in the
//     static form.
extern "C" int walk_launch(const float* fp, int n_fp, const int* ip,
                           int n_ip, void* const* planes, int n_planes,
                           int n_lanes, int budget, float thr,
                           void* const* geom, int n_geom, void* stream) {
  WalkConst h;  // pageable: the async copy stages it before returning
  memset(&h, 0, sizeof(h));
  if (n_ip < N_IP || n_fp < N_FP || n_planes != N_PLANES)
    return (int)cudaErrorInvalidValue;
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
  const bool rows_fit =
      table ? h.n_dir + h.n_neu + h.n_vert <= MAX_TABLE
            : h.n_dir <= MAX_SEG && h.n_neu <= MAX_SEG && h.n_vert <= MAX_VERT;
  if (h.n_src < 1 || h.n_src > MAX_SRC || !rows_fit || table < 0 ||
      table > 1 || h.n_dir < 1 || h.n_neu < 0 || h.n_vert < 0 ||
      (h.n_vert && !h.n_neu) || h.rounds < 1 || n_geom != N_GEOM ||
      h.robin < ROBIN_OFF || h.robin > ROBIN_REFLECT ||
      (h.robin != ROBIN_OFF && h.n_neu < 1) || h.majorant < 0 ||
      h.majorant > 1 || h.n_box < 0 || h.n_box > MAX_BOXES ||
      h.n_band < 0 || h.n_band > MAX_BANDS ||
      (!h.majorant && (h.n_box || h.n_band)) || h.clip < 0 || h.clip > 1 ||
      h.n_mix < 0 || h.n_mix > MAX_MIX || (h.n_mix && !h.has_source) ||
      freeze < 0 || freeze > 1 || n_ip != N_IP + 2 * n_fields)
    return (int)cudaErrorInvalidValue;
  const LaunchFn fn =
      walk_pick(h.robin, h.majorant, h.n_mix > 0, freeze, table);
  if (!fn) return (int)cudaErrorInvalidValue;
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
    for (int g = 0; g < N_GEOM; ++g)
      if ((uintptr_t)geom[g] % 16) return (int)cudaErrorMisalignedAddress;
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
    for (int k = 0; k < MIX_COLS; ++k) h.mix[c][k] = fp[off++];
  if (!table)
    for (int v = 0; v < h.n_vert; ++v)
      for (int k = 0; k < 8; ++k) h.vert[v][k] = fp[off++];
  for (int f = 0; f < n_fields; ++f) {
    const int kind = ip[N_IP + 2 * f], n = ip[N_IP + 1 + 2 * f];
    if (n < 1 || n > MAX_FP || off + n > n_fp ||
        (kind == K_CONST && n != 1) || (kind == K_DIPOLE && n != 6) ||
        (kind == K_BUMPS && (n - 1) % 6 != 0) ||
        (kind != K_CONST && kind != K_BUMPS && kind != K_DIPOLE))
      return (int)cudaErrorInvalidValue;
    h.field[f].kind = kind;
    h.field[f].n = n;
    for (int k = 0; k < n; ++k) h.field[f].p[k] = fp[off++];
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
  for (int i = 0; i < h.n_src; ++i)
    if (!pl.acc[i] || !pl.asum[i] || !pl.asq[i])
      return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemcpyToSymbolAsync(C, &h, sizeof(h), 0, cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  if (n_lanes > 0 && budget > 0)
    fn((n_lanes + THREADS - 1) / THREADS, st, n_lanes, budget, thr);
  return (int)cudaGetLastError();
}
