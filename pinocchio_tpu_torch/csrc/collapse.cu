// Collapse update for one smoothing radius (K3 and K7).
//
// K3 replaces pinocchio_tpu/ops/collapse.py:collapse_update (lines 282-303),
// fusing eigenvalues_descending (40-84), ell_classic (87-140),
// eval_inverse_growth (240-251), the strict running max into Fmax/Rmax and
// the _safe_mean statistics of delta and delta^2 (274-278).
//
// K11 replaces pinocchio_tpu/fmax_ooc.py:OocEngine.cycle_slab (506-535): the
// classic update of one x-slab of the out-of-core engine, from the slab's six
// real Hessian components into its rows of Fmax, with no Rmax (the JAX
// engine keeps none) and the slab's delta and delta^2 means.  It is the K3
// kernel launched on the slab with a null Rmax.
//
// K13 replaces OocEngine.cycle_slab_tab (fmax_ooc.py:539-561), the same slab
// update with F looked up in the radius's TABULATED_CT / ELL_SNG table: the
// K7 kernel launched on the slab with a null Rmax, so a slab's F is K7's F
// cell for cell.  It is bound as K7 is, per cell, on a slab of 16 x-planes.
//
// K7 replaces collapse.py:collapse_update_table (254-271) with the lookups
// of pinocchio_tpu/ops/tabulated.py (_locate 130-145, interpolate_F 148-172,
// _d_spline_at 221, interpolate_F_bilinear 233, interpolate_F_bicubic 246):
// F comes from the per-radius (delta, x, y) table [NXY, NXY, ND] in one of
// three variants.  One kernel template serves both: it is instantiated over
// how F is obtained (the classic solve with inverse growth, or one of the
// three lookups), and shares the eigenvalues, the running max and the
// statistics.  What bounds K7 on the H100: the same 36 B per cell as K3,
// plus 8 (trilinear), 16 (bilinear) or 64 (bicubic) scattered 4-byte table
// reads per cell.  A radius's table pair is 2 MB, so those reads hit the
// 50 MB L2, and the L1 holds the part of it that neighbouring cells share;
// they go through the read-only path (__ldg).  The 8192-entry
// aux map of the delta bin and the 100-entry delta grid are copied to
// shared memory by each block.  Every table index is clamped into the
// table, so a non-finite or far out-of-range cell never reads outside it
// (such cells are overwritten with F = -10 where the eigenvalues fail).
// Float operations follow the plain PyTorch lookups op for op
// (ops/tabulated.py): no contraction, constant divisions as float32
// reciprocal multiplies, true divisions by the per-radius amplitude.
//
// What bounds it on the H100: not the bytes (six float32 Hessian
// components in, Fmax read and written, Rmax written: 36 B per cell, 0.60
// GB at 256^3) but the issued instructions.  With -fmad=false every
// multiply and add issues on its own, and a cell runs the accurate acosf
// and cosf of the eigenvalues, then on ell_classic's single-root branch a
// cube root, on its three-root branch a second acosf and cosf, then expf,
// log10f, exp2f and a 16-step Horner: on the order of a thousand
// instructions a cell, and a warp whose cells take both branches runs
// both.  Design:
// - one thread per cell with every intermediate in registers; the JAX
//   select lattice becomes per-thread branches that compute the same
//   values; the 23-float inverse growth fit is a kernel argument (constant
//   bank), evaluated by the same Horner order;
// - the cube root is the plain version's float64 pow rounded once (torch
//   has no cbrt), computed as the float64 cbrt of the same argument
//   rounded to float, which is the same float unless the float64 result
//   lies within kCbrtWindow float64 ulps of a float32 rounding midpoint;
//   only there the pow is taken (cube_root).  pow(x, 1/3.) and cbrt(x)
//   differ by at most about 20 float64 ulps over the float32 range, so
//   both round alike outside the window: bit-identical by construction,
//   and checked on every positive finite float32 by cbrt_check;
// - the classic update streams its inputs through shared memory: tiles of
//   kTile cells of the six components and of Fmax come in by Hopper's bulk
//   asynchronous copies (cp.async.bulk, completion on an mbarrier) into a
//   ring of kStages stages per block, so that the next tile is in flight
//   while one is computed.  Direct loads walk the same cells in the same
//   order on the same grid where the planes are not 16-byte aligned, or
//   where a block has fewer than kRingTiles tiles to stream (an
//   out-of-core slab), as the ring's first tile comes in unhidden.  The
//   table lookups load their cells directly: their scattered table reads
//   live on the L1, which a ring's shared memory would take; for the same
//   reason they keep 2-4 blocks on an SM (table_blocks) with a
//   shared-memory carveout that leaves the rest of the SM's memory to the
//   L1.  The grid is the blocks that the occupancy query says are
//   resident, times the SMs;
// - the delta and delta^2 sums are float64 per-block partials in a layout
//   that depends on n alone (a block's tiles are b, b + G, ...); the last
//   block to finish (an atomic ticket after __threadfence) sums them in
//   fixed block order and writes the means, so a call is one launch and
//   the statistics are deterministic.  They replace the hierarchical
//   float32 mean of the JAX package and agree with it to about 1e-6
//   relative.
// Built without --use_fast_math (acosf, cosf, cbrt, pow, expf, log10f and
// exp2f are the accurate library versions) and with -fmad=false: every
// operation rounds as in the plain PyTorch version, op for op, except the
// Horner steps, which are explicit fmaf (the compiled JAX function fuses
// them too).  That matters here: where the cubic of ell_classic has large
// coefficients (three real roots, |a1| ~ 1e2-1e3), the float32 formula
// cancels and an ulp of difference in one product moves F by up to 1e-3.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kDeg = 16;
constexpr int kPack = kDeg + 1 + 6;
constexpr int kThreads = 256;
// cells of a thread in a tile (two in flight keep more of the table
// lookups' reads outstanding) and of a tile
constexpr int kPer = 2;
constexpr int kTile = kThreads * kPer;
// the classic update streams its tiles through a ring of kStages stages
// and is built for kClassicBlocks resident blocks per SM (40 registers);
// the table lookups load their cells directly: the ring's shared memory
// would take the L1 that their table reads hit
constexpr int kStages = 2;
constexpr int kClassicBlocks = 6;
// tiles a block streams at the least for the ring to pay: on the H100 it
// paid on K3's full grids (41 tiles a block at 256^3) and not on K11's
// slabs (3 and 10 tiles a block at 256^3 and 512^3; PERF.md section 6)
constexpr int kRingTiles = 16;
// devices whose resident block counts are cached
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmem = 228 * 1024;     // an SM's shared memory at most
constexpr int kArrays = 7;                 // six components and Fmax
// float64 ulps around a float32 rounding midpoint where cube_root takes
// the float64 pow
constexpr unsigned kCbrtWindow = 256;
constexpr float kSmall = 1e-20f;
constexpr float kBig = 1e10f;
constexpr float kHalfSqrt3 = 0.8660254037844386f;
// divisions by constants as multiplications by float32 reciprocals (what
// XLA and PyTorch's CUDA division by a scalar both compute)
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kInv9 = (float)(1.0 / 9.0);
constexpr float kInv14 = (float)(1.0 / 14.0);
constexpr float kInv54 = (float)(1.0 / 54.0);
constexpr float kInv84 = (float)(1.0 / 84.0);
constexpr float kInv126 = (float)(1.0 / 126.0);

struct Pack {
  float c[kPack];
};

__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 0.0f ? a / b : 0.0f;
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(fmaxf(x, 0.0f));
}

__device__ __forceinline__ float clip1(float x) {
  return fminf(fmaxf(x, -1.0f), 1.0f);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// eigenvalues_descending: closed form, sorted l1 >= l2 >= l3; returns fail
__device__ __forceinline__ bool eigenvalues(const float d[6], float& l1,
                                            float& l2, float& l3) {
  const float d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3], d4 = d[4],
              d5 = d[5];
  const float mu1 = d0 + d1 + d2;
  const float mu1_2 = mu1 * mu1;
  const float mu2 = (0.5f * mu1_2 - 0.5f * (d0 * d0 + d1 * d1 + d2 * d2)) -
                    (d3 * d3 + d4 * d4 + d5 * d5);
  const float mu3 = d0 * d1 * d2 + 2.0f * d3 * d4 * d5 - d0 * d5 * d5 -
                    d1 * d4 * d4 - d2 * d3 * d3;
  const float q = (mu1_2 - 3.0f * mu2) * kInv9;
  const float r =
      -(2.0f * mu1_2 * mu1 - 9.0f * mu1 * mu2 + 27.0f * mu3) * kInv54;

  const bool diagonal = q == 0.0f;
  const bool fail = !diagonal && ((q * q * q < r * r) || (q < 0.0f));

  float x1, x2, x3;
  if (diagonal) {
    x1 = d0;
    x2 = d1;
    x3 = d2;
  } else {
    const float sq = 2.0f * safe_sqrt(q);
    const float t = acosf(clip1(safe_div(2.0f * r, q * sq)));
    const float c = cosf(t * kThird);
    const float sn = safe_sqrt(1.0f - c * c);
    const float m3 = mu1 * kThird;
    x1 = -sq * c + m3;
    x2 = -sq * (-0.5f * c - kHalfSqrt3 * sn) + m3;
    x3 = -sq * (-0.5f * c + kHalfSqrt3 * sn) + m3;
  }
  const float hi = fmaxf(fmaxf(x1, x2), x3);
  const float lo = fminf(fminf(x1, x2), x3);
  l1 = hi;
  l2 = x1 + x2 + x3 - hi - lo;
  l3 = lo;
  return fail;
}

// whether the float32 rounding of a float64 cube root y could differ from
// that of the float64 pow: y within kCbrtWindow float64 ulps of a float32
// midpoint (the 29 mantissa bits that the rounding drops are 2^28 there;
// every cube root of a positive float32 is a normal float32)
__device__ __forceinline__ bool near_midpoint(double y) {
  const unsigned lo =
      (unsigned)(__double_as_longlong(y) & ((1ll << 29) - 1));
  const unsigned mid = 1u << 28;
  return (lo > mid ? lo - mid : mid - lo) <= kCbrtWindow;
}

// the cube root as the plain version takes it (torch has no cbrt): the
// float64 pow of x to the float64 1/3, rounded once; x >= 0
__device__ __forceinline__ float cube_root(float x) {
  const double y = cbrt((double)x);
  if (!near_midpoint(y)) return (float)y;
  return (float)pow((double)x, 1.0 / 3.0);
}

// ell_classic: growing mode at collapse, -0.1 when it never collapses
__device__ __forceinline__ float ell_classic(float l1, float l2, float l3) {
  const float delta = l1 + l2 + l3;
  float out;
  if (fabsf(l1) < kSmall) {
    out = -0.1f;
  } else {
    const float det = l1 * l2 * l3;
    const float den =
        det * kInv126 + 5.0f * l1 * delta * (delta - l1) * kInv84;
    if (fabsf(den) < kSmall) {
      // 1st/2nd-order branches when den vanishes
      if (fabsf(delta - l1) < kSmall) {
        out = l1 > 0.0f ? safe_div(1.0f, l1) : -0.1f;
      } else {
        const float dis = 7.0f * l1 * (l1 + 6.0f * delta);
        float e2 = safe_div(7.0f * l1 - safe_sqrt(dis),
                            3.0f * l1 * (l1 - delta));
        out = (dis < 0.0f || e2 < 0.0f) ? -0.1f : e2;
      }
    } else {
      const float rden = safe_div(1.0f, den);
      const float a1 = 3.0f * l1 * (delta - l1) * kInv14 * rden;
      const float a2 = l1 * rden;
      const float a3 = -rden;
      const float q = (a1 * a1 - 3.0f * a2) * kInv9;
      const float r =
          (2.0f * (a1 * a1 * a1) - 9.0f * a1 * a2 + 27.0f * a3) * kInv54;
      const float r2q3 = r * r - q * q * q;
      if (r2q3 > 0.0f) {
        // single real root; cbrtf is off by an ulp in a tenth of the
        // isotropic cells, and the cancellation below turns that into
        // several ulps of F
        const float sq1 = cube_root(safe_sqrt(r2q3) + fabsf(r));
        const float ea = -signf(r) * (sq1 + safe_div(q, sq1)) - a1 * kThird;
        out = ea < 0.0f ? -0.1f : ea;
      } else {
        // three real roots: the smallest non-negative one
        const float sq2 = 2.0f * safe_sqrt(q);
        const float t = acosf(clip1(safe_div(2.0f * r, q * sq2)));
        const float c = cosf(t * kThird);
        const float sn = safe_sqrt(1.0f - c * c);
        const float a13 = a1 * kThird;
        float s1 = -sq2 * c - a13;
        float s2 = -sq2 * (-0.5f * c - kHalfSqrt3 * sn) - a13;
        float s3 = -sq2 * (-0.5f * c + kHalfSqrt3 * sn) - a13;
        s1 = s1 < 0.0f ? kBig : s1;
        s2 = s2 < 0.0f ? kBig : s2;
        s3 = s3 < 0.0f ? kBig : s3;
        const float eb = fminf(fminf(s1, s2), s3);
        out = eb == kBig ? -0.1f : eb;
      }
    }
  }
  // spherical-collapse correction (collapse_times.c:215-218)
  if (delta > 0.0f && out > 0.0f) {
    const float inv_del = safe_div(1.0f, delta);
    const float corr = -0.364f * inv_del *
                       expf(-6.5f * (l1 - l2) * inv_del -
                            2.8f * (l2 - l3) * inv_del);
    out = out + corr;
  }
  return out;
}

__device__ __forceinline__ float inverse_growth(const Pack& p, float x) {
  const float lo = p.c[kDeg + 1];
  const float hi = p.c[kDeg + 2];
  if (x < lo) return p.c[kDeg + 3] * x + p.c[kDeg + 4];
  if (x > hi) return p.c[kDeg + 5] * x + p.c[kDeg + 6];
  const float t = clip1((2.0f * x - (lo + hi)) / (hi - lo));
  float acc = p.c[0];
#pragma unroll
  for (int k = 1; k <= kDeg; ++k) acc = fmaf(acc, t, p.c[k]);
  return acc;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---- K7: table lookups (ops/tabulated.py) ----

constexpr int kNXY = 50;
constexpr int kND = 100;
constexpr int kAuxN = 8192;
constexpr float kRangeD = 7.0f;
constexpr float kInvBinX = (float)(1.0 / (3.5 / 50));
// (d + 7) / 14 * 8191 with its two constants folded, as XLA compiles it
constexpr float kUScale = (float)((double)(float)(1.0 / 14.0) * 8191.0);
constexpr float kSixth = (float)(1.0 / 6.0);
constexpr float kNat4 = (float)(6.0 / 15.0);

enum Mode { kClassic = 0, kTrilinear = 1, kBilinear = 2, kBicubic = 3 };

struct Table {
  const float* tab;    // [NXY, NXY, ND], indexed [iy, ix, id]
  const float* tab2;   // delta-spline second derivatives, same layout
  const float* dv;     // [ND] delta grid
  const int* idx_map;  // [AUX_N] aux grid -> delta bin
  float ampl;          // sqrt variance of the radius
};

// int index of f clipped to [0, hi], truncating toward zero; NaN gives 0
__device__ __forceinline__ int clip_index(float f, float hi) {
  return (int)fminf(fmaxf(f, 0.0f), hi);
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float node(const float* t, int iy, int ix,
                                      int id) {
  return __ldg(t + (iy * kNXY + ix) * kND + id);
}

struct Loc {
  float d, fx, fy;
  int ix, iy, id;
};

__device__ __forceinline__ Loc locate(const Table& T, const int* s_idx,
                                      float l1, float l2, float l3) {
  Loc L;
  L.d = (l1 + l2 + l3) / T.ampl;
  const float x = (l1 - l2) / T.ampl;
  const float y = (l2 - l3) / T.ampl;
  L.fx = x * kInvBinX;
  L.fy = y * kInvBinX;
  L.ix = clip_index(L.fx, (float)(kNXY - 2));
  L.iy = clip_index(L.fy, (float)(kNXY - 2));
  const float u = (L.d + kRangeD) * kUScale;
  L.id = min(max(s_idx[clip_index(u, (float)(kAuxN - 1))], 0), kND - 2);
  return L;
}

// one natural-cubic segment (ops/tabulated.py:_spline_seg)
__device__ __forceinline__ float spline_seg(float y0, float y1, float m0,
                                            float m1, float d, float d0,
                                            float d1) {
  const float h = d1 - d0;
  const float A = (d1 - d) / h;
  const float B = 1.0f - A;
  const float c = (A * A * A - A) * m0 + (B * B * B - B) * m1;
  return (A * y0 + B * y1) + c * (h * h) * kSixth;
}

// natural cubic through 4 points at 0..3, at t (ops/tabulated.py:_nat4)
__device__ __forceinline__ float nat4(float y0, float y1, float y2, float y3,
                                      float t) {
  const float c1 = y0 - 2.0f * y1 + y2;
  const float c2 = y1 - 2.0f * y2 + y3;
  const float m1 = kNat4 * (4.0f * c1 - c2);
  const float m2 = kNat4 * (4.0f * c2 - c1);
  const int s = clip_index(t, 2.0f);
  if (s == 0) return spline_seg(y0, y1, 0.0f, m1, t, 0.0f, 1.0f);
  if (s == 1) return spline_seg(y1, y2, m1, m2, t, 1.0f, 2.0f);
  return spline_seg(y2, y3, m2, 0.0f, t, 2.0f, 3.0f);
}

// the delta spline of control point (iy, ix) at d, d clamped to the table
__device__ __forceinline__ float d_spline_at(const Table& T, const float* s_dv,
                                             int iy, int ix, int id,
                                             float d) {
  const float d_cl = clampf(d, s_dv[0], s_dv[kND - 1]);
  return spline_seg(node(T.tab, iy, ix, id), node(T.tab, iy, ix, id + 1),
                    node(T.tab2, iy, ix, id), node(T.tab2, iy, ix, id + 1),
                    d_cl, s_dv[id], s_dv[id + 1]);
}

__device__ __forceinline__ float trilinear(const Table& T, const float* s_dv,
                                           const Loc& L) {
  const float d0 = s_dv[L.id], d1 = s_dv[L.id + 1];
  const float r = (L.d - d0) / (d1 - d0);
  float dd = clampf(r, 0.0f, 1.0f);
  // out-of-range d keeps the edge bin with an extrapolated offset
  if (L.d <= s_dv[0]) dd = r;
  if (L.d >= s_dv[kND - 1]) dd = r;
  const float dx = L.fx - (float)L.ix, dy = L.fy - (float)L.iy;
  const float ed = 1.0f - dd, ex = 1.0f - dx, ey = 1.0f - dy;
  const int iy = L.iy, ix = L.ix, id = L.id;
  float acc = ed * ex * ey * node(T.tab, iy, ix, id);
  acc = acc + dd * ex * ey * node(T.tab, iy, ix, id + 1);
  acc = acc + ed * dx * ey * node(T.tab, iy, ix + 1, id);
  acc = acc + dd * dx * ey * node(T.tab, iy, ix + 1, id + 1);
  acc = acc + ed * ex * dy * node(T.tab, iy + 1, ix, id);
  acc = acc + dd * ex * dy * node(T.tab, iy + 1, ix, id + 1);
  acc = acc + ed * dx * dy * node(T.tab, iy + 1, ix + 1, id);
  acc = acc + dd * dx * dy * node(T.tab, iy + 1, ix + 1, id + 1);
  return acc;
}

__device__ __forceinline__ float bilinear(const Table& T, const float* s_dv,
                                          const Loc& L) {
  const float dx = L.fx - (float)L.ix, dy = L.fy - (float)L.iy;
  const float ex = 1.0f - dx, ey = 1.0f - dy;
  const float g00 = d_spline_at(T, s_dv, L.iy, L.ix, L.id, L.d);
  const float g01 = d_spline_at(T, s_dv, L.iy, L.ix + 1, L.id, L.d);
  const float g10 = d_spline_at(T, s_dv, L.iy + 1, L.ix, L.id, L.d);
  const float g11 = d_spline_at(T, s_dv, L.iy + 1, L.ix + 1, L.id, L.d);
  return ex * ey * g00 + dx * ey * g01 + ex * dy * g10 + dx * dy * g11;
}

__device__ __forceinline__ int patch_start(int i) {
  return i == 0 ? 0 : (i >= kNXY - 2 ? kNXY - 4 : i - 1);
}

__device__ __forceinline__ float bicubic(const Table& T, const float* s_dv,
                                         const Loc& L) {
  const int ixs = patch_start(L.ix), iys = patch_start(L.iy);
  const float tx = L.fx - (float)ixs, ty = L.fy - (float)iys;
  float rows[4];
#pragma unroll
  for (int jy = 0; jy < 4; ++jy) {
    float v[4];
#pragma unroll
    for (int jx = 0; jx < 4; ++jx)
      v[jx] = d_spline_at(T, s_dv, iys + jy, ixs + jx, L.id, L.d);
    rows[jy] = nat4(v[0], v[1], v[2], v[3], tx);
  }
  return nat4(rows[0], rows[1], rows[2], rows[3], ty);
}

// F = 1 + z_c of one cell, -10 on the eigenvalue fail branch
template <int MODE>
__device__ __forceinline__ float cell_F(const float d[6], const Pack& pack,
                                        const Table& T, const float* s_dv,
                                        const int* s_idx) {
  float l1, l2, l3;
  if (eigenvalues(d, l1, l2, l3)) return -10.0f;
  if (MODE == kClassic) {
    const float bc = ell_classic(l1, l2, l3);
    if (!(bc > 0.0f)) return 0.0f;
    // F = 1 + z_c = 10^-log10(a_c)
    const float loga = inverse_growth(pack, log10f(fmaxf(bc, 1e-30f)));
    return exp2f(-3.321928094887362f * loga);
  }
  const Loc L = locate(T, s_idx, l1, l2, l3);
  if (MODE == kTrilinear) return trilinear(T, s_dv, L);
  if (MODE == kBilinear) return bilinear(T, s_dv, L);
  return bicubic(T, s_dv, L);
}

// ---- shared memory: the bulk-copy ring and its barriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// this thread's arrival, expecting ``bytes`` of bulk copies
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global memory to shared
// memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Args {
  const float* derivs;  // [6, n]
  float* Fmax;          // [n]
  int* Rmax;            // [n] or null
  int64_t n;
  int ismooth;
  double* partials;     // [2, gridDim.x]
  unsigned* ticket;     // 0 on entry; the last block resets it
  double* means;        // [2]
};

// the table modes' aux map and delta grid ahead of the ring, in words
constexpr int kTableWords = kAuxN + 112;

template <int MODE>
__host__ __device__ constexpr int table_words() {
  return MODE == kClassic ? 0 : kTableWords;
}

// the ring's stages (0: direct loads)
template <bool RING>
__host__ __device__ constexpr int stages() {
  return RING ? kStages : 0;
}

template <int MODE, bool RING>
__host__ __device__ constexpr size_t dynamic_smem() {
  return sizeof(float) *
         (table_words<MODE>() + stages<RING>() * kArrays * kTile);
}

// one cell: F, the strict running max (a tie keeps the earlier radius)
// and the statistics; the cell's Fmax is read at fold once F is known
template <int MODE>
__device__ __forceinline__ void update_cell(const Args& a, int64_t i,
                                            const float d[6],
                                            const float* fold,
                                            const Pack& pack, const Table& T,
                                            const float* s_dv,
                                            const int* s_idx, double& s1,
                                            double& s2) {
  const float delta = d[0] + d[1] + d[2];
  const float F = cell_F<MODE>(d, pack, T, s_dv, s_idx);
  if (*fold < F) {
    a.Fmax[i] = F;
    if (a.Rmax != nullptr) a.Rmax[i] = a.ismooth;
  }
  s1 += (double)delta;
  s2 += (double)(delta * delta);
}

// the block's sums into its partials; the last block to finish sums every
// block's partials in block order into the means
__device__ __forceinline__ void reduce_and_finish(const Args& a, double s1,
                                                  double s2) {
  __shared__ double sh[2][kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double x = 0.0, y = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      x += sh[0][w];
      y += sh[1][w];
    }
    a.partials[2 * blockIdx.x] = x;
    a.partials[2 * blockIdx.x + 1] = y;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  s1 = 0.0;
  s2 = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    s1 += __ldcg(a.partials + 2 * b);
    s2 += __ldcg(a.partials + 2 * b + 1);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double x = 0.0, y = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      x += sh[0][w];
      y += sh[1][w];
    }
    a.means[0] = x / (double)a.n;
    a.means[1] = y / (double)a.n;
    *a.ticket = 0u;
  }
}

// block b walks the tiles b, b + G, ... of kTile cells; thread t takes
// cells t and t + kThreads of each.  RING: the tiles come through the
// shared-memory ring (n a multiple of 4, every plane 16-byte aligned).
// The classic update is built to fit kClassicBlocks blocks on an SM.
template <int MODE, bool RING>
__global__ void __launch_bounds__(kThreads,
                                  MODE == kClassic ? kClassicBlocks : 1)
collapse_kernel(Args a, Pack pack, Table table) {
  constexpr int STAGES = stages<RING>();
  extern __shared__ __align__(128) float smem[];
  __shared__ uint64_t bars[STAGES > 0 ? STAGES : 1];
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_dv = smem + kAuxN;
  float* ring = smem + table_words<MODE>();
  if (MODE != kClassic) {
    for (int k = threadIdx.x; k < kAuxN; k += blockDim.x)
      s_idx[k] = __ldg(table.idx_map + k);
    for (int k = threadIdx.x; k < kND; k += blockDim.x)
      s_dv[k] = __ldg(table.dv + k);
  }
  const int64_t n = a.n;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const int64_t G = gridDim.x;
  double s1 = 0.0, s2 = 0.0;
  if constexpr (!RING) {
    if (MODE != kClassic) __syncthreads();
    for (int64_t t = blockIdx.x; t < ntiles; t += G) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int64_t i = t * kTile + j * kThreads + threadIdx.x;
        if (i >= n) break;
        float d[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) d[c] = __ldg(a.derivs + c * n + i);
        update_cell<MODE>(a, i, d, a.Fmax + i, pack, table, s_dv, s_idx, s1,
                          s2);
      }
    }
  } else {
    const int64_t mine = (ntiles - blockIdx.x + G - 1) / G;
    // tile k of this block into its stage
    auto issue = [&](int64_t k) {
      const int st = (int)(k % STAGES);
      const int64_t start = (blockIdx.x + k * G) * kTile;
      const uint32_t bytes =
          (uint32_t)(sizeof(float) *
                     min((long long)kTile, (long long)(n - start)));
      float* dst = ring + st * kArrays * kTile;
      bar_expect(&bars[st], kArrays * bytes);
      for (int c = 0; c < 6; ++c)
        bulk_load(dst + c * kTile, a.derivs + c * n + start, bytes,
                  &bars[st]);
      bulk_load(dst + 6 * kTile, a.Fmax + start, bytes, &bars[st]);
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) bar_init(&bars[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int64_t k = 0; k < STAGES && k < mine; ++k) issue(k);
    }
    __syncthreads();
    for (int64_t k = 0; k < mine; ++k) {
      const int st = (int)(k % STAGES);
      bar_wait(&bars[st], (uint32_t)((k / STAGES) & 1));
      const float* tile = ring + st * kArrays * kTile;
      const int64_t start = (blockIdx.x + k * G) * kTile;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int l = j * kThreads + threadIdx.x;
        if (start + l >= n) break;
        float d[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) d[c] = tile[c * kTile + l];
        update_cell<MODE>(a, start + l, d, tile + 6 * kTile + l, pack, table,
                          s_dv, s_idx, s1, s2);
      }
      // every thread is done with the stage before it is refilled
      __syncthreads();
      if (threadIdx.x == 0 && k + STAGES < mine) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(k + STAGES);
      }
    }
  }
  reduce_and_finish(a, s1, s2);
}

// the cube root's proof: every positive finite float32 (bit patterns 1 to
// 0x7f7fffff, and 0 and +inf) through cube_root and the float64 pow;
// counts[0] the floats whose results differ, counts[1] the floats near a
// midpoint (where cube_root took the pow)
__global__ void cbrt_check_kernel(unsigned long long* counts) {
  unsigned long long bad = 0, near = 0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u <= 0x7f800000u;
       u += stride) {
    const float x = __uint_as_float(u);
    const float want = (float)pow((double)x, 1.0 / 3.0);
    const float got = cube_root(x);
    bad += __float_as_uint(got) != __float_as_uint(want);
    near += near_midpoint(cbrt((double)x));
  }
  if (bad) atomicAdd(counts, bad);
  if (near) atomicAdd(counts + 1, near);
}

// blocks per SM of a table lookup.  Its scattered table reads hit the L1,
// so fewer blocks with a larger L1 beat occupancy: builds with caps of 2,
// 3, 4 and none (4-5 blocks) put each lookup fastest at the cap given here
template <int MODE>
constexpr int table_blocks() {
  return MODE == kTrilinear ? 4 : (MODE == kBilinear ? 3 : 2);
}

// resident blocks per SM of one instantiation on device dev, queried once
// per device (0 when the query fails).  A table lookup keeps at most
// table_blocks blocks on an SM and asks for a shared-memory carveout that
// holds just their shared memory, so that the rest of the SM's 256 KB
// serves its table reads as L1
template <int MODE, bool RING>
int resident_blocks(int dev) {
  static int blocks[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (blocks[dev] == 0) {
    auto fn = collapse_kernel<MODE, RING>;
    constexpr size_t shmem = dynamic_smem<MODE, RING>();
    if (shmem > 48 * 1024)
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shmem);
    constexpr int cap = MODE == kClassic ? 0 : table_blocks<MODE>();
    if (cap > 0)
      cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)((cap * (shmem + 2048) * 100 + kMaxSmem - 1) / kMaxSmem));
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fn, kThreads,
                                                      shmem) != cudaSuccess)
      return 0;
    blocks[dev] = cap > 0 ? std::min(b, cap) : b;
  }
  return blocks[dev];
}

// the grid of a call: every resident block, at most one a tile and
// max_blocks, at least one, so that n = 0 still writes its (NaN) means
int64_t grid_size(int64_t n, int per_sm, int sms, int max_blocks) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  return std::max<int64_t>(
      1, std::min<int64_t>(std::min<int64_t>((int64_t)per_sm * sms, ntiles),
                           max_blocks));
}

template <int MODE, bool RING>
int launch(const Args& a, const Pack& pack, const Table& table, int64_t grid,
           cudaStream_t s) {
  collapse_kernel<MODE, RING>
      <<<(unsigned)grid, kThreads, dynamic_smem<MODE, RING>(), s>>>(
          a, pack, table);
  return (int)cudaGetLastError();
}

bool aligned(const Args& a) {
  return a.n % 4 == 0 && ((uintptr_t)a.derivs & 15) == 0 &&
         ((uintptr_t)a.Fmax & 15) == 0;
}

template <int MODE, bool RING>
int info(int* out) {
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, collapse_kernel<MODE, RING>);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  cudaGetDevice(&dev);
  out[0] = f.numRegs;
  out[1] = (int)f.localSizeBytes;
  out[2] = (int)(f.sharedSizeBytes + dynamic_smem<MODE, RING>());
  out[3] = resident_blocks<MODE, RING>(dev);
  return (int)cudaGetLastError();
}

// the classic update through the ring where its planes are aligned and
// each block streams kRingTiles tiles or more, else with direct loads, on
// one grid either way (the fewer resident blocks of the two), so that the
// partials' layout is a function of n; the table lookups with direct
// loads.  A failed occupancy query raises (cudaErrorInvalidConfiguration)
// rather than launch nothing.
template <int MODE>
int launch_mode(const Args& a, const Pack& pack, const Table& table,
                int max_blocks, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm = resident_blocks<MODE, false>(dev);
  if constexpr (MODE == kClassic)
    per_sm = std::min(per_sm, resident_blocks<kClassic, true>(dev));
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = grid_size(a.n, per_sm, sms, max_blocks);
  if constexpr (MODE == kClassic) {
    if (aligned(a) && (a.n + kTile - 1) / kTile >= kRingTiles * grid)
      return launch<kClassic, true>(a, pack, table, grid, s);
  }
  return launch<MODE, false>(a, pack, table, grid, s);
}

}  // namespace

// The partials hold 2 * max_blocks doubles; ticket one unsigned, zero on
// entry and on return; means 2 doubles.

extern "C" int collapse_update(const void* derivs, void* Fmax, void* Rmax,
                               int64_t n, int ismooth, const void* pack_host,
                               void* partials, int max_blocks, void* ticket,
                               void* means, void* stream) {
  Pack pack;
  const float* src = (const float*)pack_host;
  for (int k = 0; k < kPack; ++k) pack.c[k] = src[k];
  const Args a{(const float*)derivs, (float*)Fmax, (int*)Rmax, n, ismooth,
               (double*)partials, (unsigned*)ticket, (double*)means};
  return launch_mode<kClassic>(a, pack, Table{}, max_blocks,
                               (cudaStream_t)stream);
}

// K11: derivs [6, n] of one slab, Fmax its n cells; no Rmax
extern "C" int collapse_update_slab(const void* derivs, void* Fmax,
                                    int64_t n, const void* pack_host,
                                    void* partials, int max_blocks,
                                    void* ticket, void* means,
                                    void* stream) {
  return collapse_update(derivs, Fmax, nullptr, n, 0, pack_host, partials,
                         max_blocks, ticket, means, stream);
}

// interp: 0 trilinear, 1 bilinear spline, 2 bicubic
extern "C" int collapse_update_table(const void* derivs, void* Fmax,
                                     void* Rmax, int64_t n, int ismooth,
                                     const void* tab, const void* tab2,
                                     const void* dv, const void* idx_map,
                                     float ampl, int interp, void* partials,
                                     int max_blocks, void* ticket,
                                     void* means, void* stream) {
  const Table table{(const float*)tab, (const float*)tab2, (const float*)dv,
                    (const int*)idx_map, ampl};
  const Args a{(const float*)derivs, (float*)Fmax, (int*)Rmax, n, ismooth,
               (double*)partials, (unsigned*)ticket, (double*)means};
  const Pack pack{};
  cudaStream_t s = (cudaStream_t)stream;
  if (interp == 0)
    return launch_mode<kTrilinear>(a, pack, table, max_blocks, s);
  if (interp == 1)
    return launch_mode<kBilinear>(a, pack, table, max_blocks, s);
  if (interp == 2)
    return launch_mode<kBicubic>(a, pack, table, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// K13: derivs [6, n] of one out-of-core slab, Fmax its n cells; no Rmax
extern "C" int collapse_update_slab_table(
    const void* derivs, void* Fmax, int64_t n, const void* tab,
    const void* tab2, const void* dv, const void* idx_map, float ampl,
    int interp, void* partials, int max_blocks, void* ticket, void* means,
    void* stream) {
  return collapse_update_table(derivs, Fmax, nullptr, n, 0, tab, tab2, dv,
                               idx_map, ampl, interp, partials, max_blocks,
                               ticket, means, stream);
}

// registers, local (spill) bytes, shared bytes (static and dynamic) and
// resident blocks per SM of collapse_kernel<mode, ring> on the current
// device: out[4]
extern "C" int collapse_kernel_info(int mode, int ring, int* out) {
  switch (mode) {
    case kClassic:
      return ring ? info<kClassic, true>(out) : info<kClassic, false>(out);
    case kTrilinear: return info<kTrilinear, false>(out);
    case kBilinear: return info<kBilinear, false>(out);
    case kBicubic: return info<kBicubic, false>(out);
  }
  return (int)cudaErrorInvalidValue;
}

// counts [2] unsigned long long, zeroed by the caller: see cbrt_check_kernel
extern "C" int cbrt_check(void* counts, void* stream) {
  cbrt_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
