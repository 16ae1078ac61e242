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
// statistics.  What bounds K7 on the H100: the same 40 B per cell as K3,
// plus 8 (trilinear), 16 (bilinear) or 64 (bicubic) scattered 4-byte table
// reads per cell.  A radius's table pair is 2 MB, so those reads hit the
// 50 MB L2; they go through the read-only path (__ldg).  The 8192-entry
// aux map of the delta bin and the 100-entry delta grid are copied to
// shared memory by each block.  Every table index is clamped into the
// table, so a non-finite or far out-of-range cell never reads outside it
// (such cells are overwritten with F = -10 where the eigenvalues fail).
// Float operations follow the plain PyTorch lookups op for op
// (ops/tabulated.py): no contraction, constant divisions as float32
// reciprocal multiplies, true divisions by the per-radius amplitude.
//
// What bounds it on the H100: device memory bytes first (six float32 Hessian
// components in, Fmax and Rmax read and written: 40 B per cell, 0.67 GB at
// 256^3), then the transcendentals (two acosf, two cosf, a float64 pow,
// expf, log10f, exp2f per cell).  Design: one thread per cell in a grid-stride
// loop with every intermediate in registers; the JAX select lattice becomes
// per-thread branches that compute the same values.  The 23-float inverse
// growth fit is a kernel argument (constant bank), evaluated by the same
// Horner order.  The delta and delta^2 sums are float64 per-block partials
// written by a fixed-size grid, then summed in a fixed order by a one-block
// second pass, so the statistics are deterministic; they replace the
// hierarchical float32 mean of the JAX package and agree with it to about
// 1e-6 relative.  Built without --use_fast_math (acosf, cosf, pow, expf,
// log10f and exp2f are the accurate library versions) and with
// -fmad=false: every operation rounds as in the plain PyTorch version, op
// for op, except the Horner steps, which are explicit fmaf (the compiled
// JAX function fuses them too).  That matters here: where the cubic of
// ell_classic has large coefficients (three real roots, |a1| ~ 1e2-1e3),
// the float32 formula cancels and an ulp of difference in one product
// moves F by up to 1e-3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDeg = 16;
constexpr int kPack = kDeg + 1 + 6;
constexpr int kThreads = 256;
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
        // single real root
        // the cube root as the plain version takes it (torch has no cbrt):
        // a float64 pow rounded once.  cbrtf is off by an ulp in a tenth
        // of the isotropic cells, and the cancellation below turns that
        // into several ulps of F.
        const float sq1 =
            (float)pow((double)(safe_sqrt(r2q3) + fabsf(r)), 1.0 / 3.0);
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
collapse_kernel(const float* __restrict__ derivs, float* __restrict__ Fmax,
                int* __restrict__ Rmax, int64_t n, int ismooth, Pack pack,
                Table table, double* __restrict__ partials) {
  // table modes: the aux map and the delta grid in shared memory
  extern __shared__ int smem[];
  int* s_idx = smem;
  float* s_dv = reinterpret_cast<float*>(smem + kAuxN);
  if (MODE != kClassic) {
    for (int k = threadIdx.x; k < kAuxN; k += blockDim.x)
      s_idx[k] = __ldg(table.idx_map + k);
    for (int k = threadIdx.x; k < kND; k += blockDim.x)
      s_dv[k] = __ldg(table.dv + k);
    __syncthreads();
  }
  double s1 = 0.0, s2 = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float d[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) d[c] = __ldg(derivs + c * n + i);
    const float delta = d[0] + d[1] + d[2];
    const float F = cell_F<MODE>(d, pack, table, s_dv, s_idx);
    if (Fmax[i] < F) {  // strict: a tie keeps the earlier radius
      Fmax[i] = F;
      if (Rmax != nullptr) Rmax[i] = ismooth;
    }
    s1 += (double)delta;
    s2 += (double)(delta * delta);
  }
  __shared__ double sh[2][kThreads / 32];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
mean_kernel(const double* __restrict__ partials, int nblocks, int64_t n,
            double* __restrict__ means) {
  double s1 = 0.0, s2 = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    s1 += partials[2 * b];
    s2 += partials[2 * b + 1];
  }
  __shared__ double sh[2][kThreads / 32];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][warp] = s1;
    sh[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += sh[0][w];
      b += sh[1][w];
    }
    means[0] = a / (double)n;
    means[1] = b / (double)n;
  }
}

}  // namespace

extern "C" int collapse_update(const void* derivs, void* Fmax, void* Rmax,
                               int64_t n, int ismooth, const void* pack_host,
                               void* partials, int nblocks, void* means,
                               void* stream) {
  Pack pack;
  const float* src = (const float*)pack_host;
  for (int k = 0; k < kPack; ++k) pack.c[k] = src[k];
  cudaStream_t s = (cudaStream_t)stream;
  collapse_kernel<kClassic><<<nblocks, kThreads, 0, s>>>(
      (const float*)derivs, (float*)Fmax, (int*)Rmax, n, ismooth, pack,
      Table{}, (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mean_kernel<<<1, kThreads, 0, s>>>((const double*)partials, nblocks, n,
                                     (double*)means);
  return (int)cudaGetLastError();
}

// K11: derivs [6, n] of one slab, Fmax its n cells; no Rmax
extern "C" int collapse_update_slab(const void* derivs, void* Fmax,
                                    int64_t n, const void* pack_host,
                                    void* partials, int nblocks, void* means,
                                    void* stream) {
  return collapse_update(derivs, Fmax, nullptr, n, 0, pack_host, partials,
                         nblocks, means, stream);
}

// interp: 0 trilinear, 1 bilinear spline, 2 bicubic
extern "C" int collapse_update_table(const void* derivs, void* Fmax,
                                     void* Rmax, int64_t n, int ismooth,
                                     const void* tab, const void* tab2,
                                     const void* dv, const void* idx_map,
                                     float ampl, int interp, void* partials,
                                     int nblocks, void* means, void* stream) {
  const Table table{(const float*)tab, (const float*)tab2, (const float*)dv,
                    (const int*)idx_map, ampl};
  const Pack pack{};
  const size_t shmem = kAuxN * sizeof(int) + kND * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const float* d = (const float*)derivs;
  double* part = (double*)partials;
  if (interp == 0)
    collapse_kernel<kTrilinear><<<nblocks, kThreads, shmem, s>>>(
        d, (float*)Fmax, (int*)Rmax, n, ismooth, pack, table, part);
  else if (interp == 1)
    collapse_kernel<kBilinear><<<nblocks, kThreads, shmem, s>>>(
        d, (float*)Fmax, (int*)Rmax, n, ismooth, pack, table, part);
  else if (interp == 2)
    collapse_kernel<kBicubic><<<nblocks, kThreads, shmem, s>>>(
        d, (float*)Fmax, (int*)Rmax, n, ismooth, pack, table, part);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mean_kernel<<<1, kThreads, 0, s>>>((const double*)partials, nblocks, n,
                                     (double*)means);
  return (int)cudaGetLastError();
}

// K13: derivs [6, n] of one out-of-core slab, Fmax its n cells; no Rmax
extern "C" int collapse_update_slab_table(const void* derivs, void* Fmax,
                                          int64_t n, const void* tab,
                                          const void* tab2, const void* dv,
                                          const void* idx_map, float ampl,
                                          int interp, void* partials,
                                          int nblocks, void* means,
                                          void* stream) {
  return collapse_update_table(derivs, Fmax, nullptr, n, 0, tab, tab2, dv,
                               idx_map, ampl, interp, partials, nblocks,
                               means, stream);
}
