// k-space derivative multipliers (K2, K5 and K8), and the out-of-core
// engine's per-kz-batch factors (K10, K14).
//
// Replaces, in pinocchio_tpu/ops/derivatives.py:
//   kspace_hessian      <- smoothed_potential + the per-pair multiply of the
//                          FFT branch of second_derivatives (lines 120-147)
//   kspace_gradient     <- the multiply of first_derivatives (lines 150-165)
//   kspace_gradient_tab <- the multiply of first_derivatives_tab (168-185):
//                          the growth factor of each mode is interpolated
//                          linearly from a table over log10 |k| (|k| in grid
//                          units, a quirk of the reference kept as is)
// and, over a shard's window of a mesh's k layout (K2s, K5s, K8s), the same
// three in pinocchio_tpu/parallel/pfft.py:
//   kspace_hessian_shard      <- distributed_second_derivatives (333-352)
//   kspace_gradient_shard     <- distributed_first_derivatives (355-366)
//   kspace_gradient_tab_shard <- distributed_first_derivatives_tab (369-390)
// A shard is the window [N, y0:y0+ny, z0:z0+nz] of the [N, N, Nhp] layout
// (Nhp >= Nh pads the kz axis so that it splits evenly over the mesh); each
// mode's k comes from its global indices (ix, y0 + iy, z0 + iz), so every
// float operation is the single-device kernel's, and the padded planes
// iz >= Nh are written as exact zeros without being read.  The full-grid
// kernels are the window (0, N, 0, Nh).
// and, in pinocchio_tpu/fmax_ooc.py, K10's three modes:
//   ooc_factors_hessian  <- OocEngine.build_hessian_batch (lines 421-434)
//   ooc_factors_gradient <- OocEngine.build_first_batch (438-465), constant
//                           growth
//   ooc_factors_pair     <- OocEngine.build_pair_batch (469-501)
// and K14:
//   ooc_factors_gradient_tab <- build_first_batch with a growth table
//                           (438-465; the tables of growth_k_tables,
//                           1286-1297): K10's gradient mode with K8's
//                           per-mode growth lookup
// The c2r transforms that follow are cuFFT's, as the JAX package leaves
// them to XLA's FFT.  The full-grid K2, K5 and K8 feed the port's own plans
// (gridfft.cu, driven by grids.irfft3_), which read the spectrum kz
// outermost, [ncomp, Nh, N, N], and do not normalize: each writes that
// layout through K10's kz-fastest form (the tiles below; their source is a
// resident [N, N, Nh] spectrum, kz fastest) and takes the c2r's 1/N^3 as
// one more real factor ``scale`` of each output (Scaled: both parts times
// it, exact at a power-of-two N, so the transform's result is the
// scale-after's bit for bit).  That kernel keeps the name window_kernel;
// the shard forms (K2s, K5s, K8s) keep the flat window kernel below and
// the [ncomp, N, ny, nz] layout of their torch.fft transforms.
//
// What bounds it on the H100: device memory bytes.  The Hessian mode reads
// one complex64 mode and writes six (56 B per mode, 0.48 GB at 256^3); the
// gradient mode reads one and writes three (32 B).  The arithmetic (one
// expf, a few dozen multiplies and adds) is far below the memory line.
// Each mode is one operation on a source value and its k (HessianOp,
// GradientOp, PairOp), shared by the dense, shard and out-of-core kernels,
// and its float operations keep the JAX order: base = delta * (smooth *
// inv_k2), then base * (k_a * k_b), each product of a complex value by a
// real or an imaginary one the complex product (cscale, cmul_i), so that a
// zero carries the plain version's sign.  K2s, K5s and K8s (one window
// kernel): a block takes kChunk consecutive modes of the
// window in its flat (ix, iy, iz) order, and sets up the (row, iz) of its
// first mode once from its index with 32-bit divisions (no 64-bit division
// a mode, which the first design paid four times); each thread takes
// kPairs pairs of consecutive modes, loads all of them (one 16-byte load a
// pair) before it computes, and writes each component of a pair as one
// 16-byte store, so a warp's loads and each output plane's stores are
// coalesced 512-byte runs.  k_x, k_y, k_z come from the mode's own indices
// (no tables).  A window whose pointers or mode count break the 16-byte
// grid takes the same kernel with 8-byte accesses.
// The tabulated-growth mode adds a log10f and a two-entry table read per
// mode (still far below the memory line); K8, K8s and K14 read the table
// (512 floats) through the read-only path (K8 copied it to shared memory
// in each of its blocks until PR 19).
// K10 and K14 work on one batch of B kz planes ([B, N, N], a few MB) and are
// bound the same way: 8 B (16 B in pair mode) read and 48, 24 or 16 B
// written per mode.  Their sources come in two layouts, and each layout has
// its form, picked by the wrapper from the strides: a resident [N, N, Nh]
// spectrum's window (kz fastest) is read with no copy by tiles of (ix, 64
// iy) x 16 kz, lanes on consecutive kz so that each (ix, iy)'s run is one
// read, and written through shared memory with lanes on consecutive iy;
// contiguous planes (K9's, K19's widened batches) by (kz, ix) rows, lanes
// on iy.  Both set up a block's indices and k_x once, with no 64-bit
// division.  The pair mode's first source, K9's planes, is read in the
// write phase by rows; K10's Hessian mode only ever reads K9's planes, so
// it has the rows form alone (K2's whole-grid Hessian takes the kz-fastest
// form, on a resident spectrum).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct KMode {
  float kx, ky, kz, k2, inv_k2;
};

// k in grid units: 2*pi/N * m computed in double and rounded once, which is
// what the JAX package's float64 numpy table cast to float32 holds
__device__ __forceinline__ double kstep(int N) {
  return 6.283185307179586 / (double)N;
}

__device__ __forceinline__ float kunit(int N, int m) {
  return (float)(kstep(N) * (double)m);
}

__device__ __forceinline__ KMode kmode_of(float kx, float ky, float kz) {
  KMode k;
  k.kx = kx;
  k.ky = ky;
  k.kz = kz;
  k.k2 = __fadd_rn(__fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky)),
                   __fmul_rn(kz, kz));
  k.inv_k2 = k.k2 > 0.0f ? __fdiv_rn(1.0f, k.k2) : 0.0f;
  return k;
}

__device__ __forceinline__ KMode kmode_at(int N, int ix, int iy, int iz) {
  const int half = N / 2;
  return kmode_of(kunit(N, ix <= half ? ix : ix - N),
                  kunit(N, iy <= half ? iy : iy - N), fabsf(kunit(N, iz)));
}

// a window [N, y0:y0+ny, z0:z0+nz] of the k layout; the full grid is
// (0, N, 0, Nh)
struct Window {
  int N, y0, ny, z0, nz;
};

// both parts of a times a real s: exact for a power of two, and the
// identity, signed zeros included, for s = 1 (cscale would turn a -0 part
// into +0 there)
__device__ __forceinline__ float2 rscale(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}

// a * s for a real s as the complex product with (s, 0), and a * (i g) as
// the one with (0, g), the way PyTorch's and XLA's complex multiplies
// compute them: a zero carries the sign that the plain version's does
__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, s), __fmul_rn(a.y, 0.0f)),
                     __fadd_rn(__fmul_rn(a.x, 0.0f), __fmul_rn(a.y, s)));
}

__device__ __forceinline__ float2 cmul_i(float2 a, float g) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, 0.0f), __fmul_rn(a.y, g)),
                     __fadd_rn(__fmul_rn(a.x, g), __fmul_rn(a.y, 0.0f)));
}

// the growth of a mode, interpolated linearly in a table over log10 |k|
// (|k| in grid units) from glo in steps of gdx, the coordinate clipped to
// [0, tmax]; tab is K8's shared-memory copy or K14's read-only view
template <typename Tab>
__device__ __forceinline__ float growth_at(const Tab& tab, float k2,
                                           float glo, float gdx,
                                           float tmax) {
  const float logk = __fmul_rn(0.5f, log10f(fmaxf(k2, 1e-12f)));
  float t = __fdiv_rn(__fsub_rn(logk, glo), gdx);
  t = t < 0.0f ? 0.0f : (t > tmax ? tmax : t);
  const int i = (int)t;
  const float w = __fsub_rn(t, (float)i);
  return __fadd_rn(__fmul_rn(tab[i], __fsub_rn(1.0f, w)),
                   __fmul_rn(tab[i + 1], w));
}

// a table in device memory read through the read-only path
struct LdgTable {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const {
    return __ldg(p + i);
  }
};

// Each mode is an operation on one source value d and its KMode k that
// writes component c of out at c * n + o (b, ix, iy: the mode's batch
// indices, read by the pair mode alone).

// The Hessian mode (K2, K10): the 6 smoothed factors k_a k_b
// exp(-k^2 R^2/2) / k^2 in ider order, exp(-0.5 * k2 * R * R) evaluated
// left to right like the JAX expression.
// eval writes the mode's components to v (the window kernel stores them);
// the call operator stores them at out[c * n + o] (K10's forms).
struct HessianOp {
  static constexpr int kComps = 6;
  float R;
  __device__ __forceinline__ void eval(float2 d, const KMode& k,
                                       float2 (&v)[kComps]) const {
    const float arg = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, k.k2), R), R);
    const float2 base = cscale(d, __fmul_rn(expf(arg), k.inv_k2));
    v[0] = cscale(base, __fmul_rn(k.kx, k.kx));
    v[1] = cscale(base, __fmul_rn(k.ky, k.ky));
    v[2] = cscale(base, __fmul_rn(k.kz, k.kz));
    v[3] = cscale(base, __fmul_rn(k.kx, k.ky));
    v[4] = cscale(base, __fmul_rn(k.kx, k.kz));
    v[5] = cscale(base, __fmul_rn(k.ky, k.kz));
  }
  __device__ __forceinline__ void operator()(float2 d, const KMode& k, int,
                                             int, int,
                                             float2* __restrict__ out,
                                             int64_t n, int64_t o) const {
    float2 v[kComps];
    eval(d, k, v);
#pragma unroll
    for (int c = 0; c < kComps; ++c) out[c * n + o] = v[c];
  }
};

// where a gradient's growth comes from: K5's and K10's scalar, K8's and
// K14's table (read-only)
struct ScalarGrowth {
  float g;
  __device__ __forceinline__ float operator()(float) const { return g; }
};

template <class Tab>
struct TableGrowth {
  Tab tab;
  float glo, gdx, tmax;
  __device__ __forceinline__ float operator()(float k2) const {
    return growth_at(tab, k2, glo, gdx, tmax);
  }
};

// The gradient mode (K5, K8, K10, K14): i k_a / k^2 * growth.
template <class Growth>
struct GradientOp {
  static constexpr int kComps = 3;
  Growth growth;
  __device__ __forceinline__ void eval(float2 d, const KMode& k,
                                       float2 (&v)[kComps]) const {
    // (a + ib) * (i g), then * inv_k2, then * k_a
    const float2 base = cscale(cmul_i(d, growth(k.k2)), k.inv_k2);
    v[0] = cscale(base, k.kx);
    v[1] = cscale(base, k.ky);
    v[2] = cscale(base, k.kz);
  }
  __device__ __forceinline__ void operator()(float2 d, const KMode& k, int,
                                             int, int,
                                             float2* __restrict__ out,
                                             int64_t n, int64_t o) const {
    float2 v[kComps];
    eval(d, k, v);
#pragma unroll
    for (int c = 0; c < kComps; ++c) out[c * n + o] = v[c];
  }
};

// The pair mode: the 3LPT-b fold operands of one Hessian component (a, b),
// k_a k_b / k^2 on two sources: the form's source is src1 (the 2LPT source
// spectrum's batch), src0 (K9's planes, iy contiguous: element (b, ix, iy)
// at s0[b * sb + ix * sx + iy]) is read here, lanes on consecutive iy.
struct PairOp {
  const float2* s0;
  int64_t sb, sx;
  int ia, ib;
  __device__ __forceinline__ void operator()(float2 d1, const KMode& k,
                                             int b, int ix, int iy,
                                             float2* __restrict__ out,
                                             int64_t n, int64_t o) const {
    const float ka = ia == 0 ? k.kx : (ia == 1 ? k.ky : k.kz);
    const float kb = ib == 0 ? k.kx : (ib == 1 ? k.ky : k.kz);
    const float f = __fmul_rn(ka, kb);
    const float2 d0 = __ldg(s0 + (int64_t)b * sb + (int64_t)ix * sx + iy);
    out[o] = cscale(cscale(d0, k.inv_k2), f);
    out[n + o] = cscale(cscale(d1, k.inv_k2), f);
  }
};

// K2, K5 and K8 on the whole grid: a mode's components (Op::eval) times the
// real scale, stored at out[c * n + o] as K10's forms store theirs
template <class Op>
struct Scaled {
  static constexpr int kComps = Op::kComps;
  Op op;
  float scale;
  __device__ __forceinline__ void operator()(float2 d, const KMode& k, int,
                                             int, int,
                                             float2* __restrict__ out,
                                             int64_t n, int64_t o) const {
    float2 v[kComps];
    op.eval(d, k, v);
#pragma unroll
    for (int c = 0; c < kComps; ++c) out[c * n + o] = rscale(v[c], scale);
  }
};

// K2s, K5s, K8s over a window [N, ny, nz], flat in
// (ix, iy, iz) order (row = ix * ny + iy): block b takes the kChunk modes
// from b * kChunk, thread t the pairs (2 (t + p kThreads), + 1) of them for
// p < kPairs.  The block's first (row, iz) comes from b with 32-bit
// divisions (b * kChunk = (q nz + r) kChunk, so its row is q kChunk +
// r kChunk / nz), each pair's from the block's with two more.  Every
// pair's source is loaded before any is computed; a padded plane (global
// kz > N/2) is written as exact zeros and not read.  kVec: 16-byte loads
// and stores a pair (the source, the output and nmodes on the 16-byte
// grid), else 8-byte ones a mode.
constexpr int kPairs = 2;
constexpr int kChunk = 2 * kPairs * kThreads;

template <bool kVec, class Op>
__global__ void __launch_bounds__(kThreads)
window_kernel(const float2* __restrict__ src, float2* __restrict__ out,
              Window w, int64_t nmodes, Op op) {
  constexpr int NC = Op::kComps;
  const unsigned nz = w.nz, ny = w.ny, b = blockIdx.x;
  const unsigned q = b / nz, rc = (b - q * nz) * (unsigned)kChunk;
  const unsigned row0 = q * (unsigned)kChunk + rc / nz, iz0 = rc % nz;
  const int64_t base = (int64_t)b * kChunk;
  const int nh = w.N / 2;
  // each pair's first mode: flat index, ix, iy, iz (window indices); the
  // second is at iz + 1 of the same row, or at iz 0 of the next
  int64_t f[kPairs];
  unsigned ix[kPairs][2], iy[kPairs][2], iz[kPairs][2];
  bool live[kPairs][2];
  float2 d[kPairs][2];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const unsigned off = 2u * (threadIdx.x + p * kThreads);
    f[p] = base + off;
    const unsigned t = iz0 + off, dr = t / nz;
    const unsigned row = row0 + dr;
    iz[p][0] = t - dr * nz;
    ix[p][0] = row / ny;
    iy[p][0] = row - ix[p][0] * ny;
    const bool wrap = iz[p][0] + 1 == nz;
    iz[p][1] = wrap ? 0u : iz[p][0] + 1;
    const bool wrap_y = wrap && iy[p][0] + 1 == ny;
    iy[p][1] = wrap ? (wrap_y ? 0u : iy[p][0] + 1) : iy[p][0];
    ix[p][1] = ix[p][0] + (wrap_y ? 1u : 0u);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      live[p][e] = f[p] + e < nmodes && w.z0 + (int)iz[p][e] <= nh;
    d[p][0] = d[p][1] = make_float2(0.0f, 0.0f);
    if (kVec && live[p][0] && live[p][1]) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + f[p]));
      d[p][0] = make_float2(v.x, v.y);
      d[p][1] = make_float2(v.z, v.w);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (live[p][e]) d[p][e] = __ldg(src + f[p] + e);
    }
  }
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    if (f[p] >= nmodes) return;
    float2 v[2][NC];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (live[p][e]) {
        op.eval(d[p][e],
                kmode_at(w.N, (int)ix[p][e], w.y0 + (int)iy[p][e],
                         w.z0 + (int)iz[p][e]),
                v[e]);
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) v[e][c] = make_float2(0.0f, 0.0f);
      }
    }
    const bool both = f[p] + 1 < nmodes;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float2* o = out + c * nmodes + f[p];
      if (kVec && both) {
        *reinterpret_cast<float4*>(o) =
            make_float4(v[0][c].x, v[0][c].y, v[1][c].x, v[1][c].y);
      } else {
        o[0] = v[0][c];
        if (both) o[1] = v[1][c];
      }
    }
  }
}

// ---- K10 and K14: the out-of-core engine's factors on one batch of kz
// planes ----
// A source batch is [B, N, N] in (kz, x, y) order: K9's planes, K19's
// widened batches, or the planes kz0..kz0+B-1 of a resident [N, N, Nh]
// spectrum.  The output is the contiguous [ncomp, B, N, N] input of one
// batched ifft2: out[c][b][ix][iy] from the source mode (b, ix, iy), at
// kz0 + b.  Each mode is an operation on one source value and its KMode,
// every float operation K2's, K5's, K8's and the R=0 Hessian's, op for op,
// so a half transform holds the dense engine's values; a form runs it over
// the batch in the order that the source's layout reads best.

// k of the signed mode of index m (m <= N/2 or m - N) in grid units, as
// kunit computes it, with 2*pi/N (step = kstep(N)) computed once a thread
__device__ __forceinline__ float kgrid(double step, int N, int m) {
  return (float)(step * (double)(m <= N / 2 ? m : m - N));
}

// The kz-fastest form: a resident spectrum's window, element (b, ix, iy) at
// src[b + ix * sx + iy * sy].  A block takes one ix, kTileY iy and up to
// kTileZ kz: lanes read consecutive kz, so each (ix, iy)'s run of 8 B a kz
// is one coalesced read, into a tile padded against bank conflicts; then
// lanes take consecutive iy of one kz and write each component's row.
constexpr int kTileY = 64;
constexpr int kTileZ = 16;

template <class Op>
__device__ __forceinline__ void kz_tile(const float2* __restrict__ src,
                                        int64_t sx, int64_t sy,
                                        float2* __restrict__ out, int N,
                                        int kz0, int B, const Op& op) {
  __shared__ float2 tile[kTileZ][kTileY + 1];
  const int iy0 = blockIdx.x * kTileY, ix = blockIdx.y;
  const int b0 = blockIdx.z * kTileZ;
  const int nb = min(kTileZ, B - b0), ny = min(kTileY, N - iy0);
  const float2* s = src + (int64_t)ix * sx + (int64_t)iy0 * sy + b0;
  for (int e = threadIdx.x; e < ny * nb; e += kThreads) {
    const int y = e / nb, b = e - y * nb;
    tile[b][y] = __ldg(s + (int64_t)y * sy + b);
  }
  __syncthreads();
  const double step = kstep(N);
  const float kx = kgrid(step, N, ix);
  const int64_t n = (int64_t)B * N * N;
  for (int e = threadIdx.x; e < nb * kTileY; e += kThreads) {
    const int b = b0 + e / kTileY, y = e % kTileY;
    if (y >= ny) continue;
    const int iy = iy0 + y;
    op(tile[b - b0][y],
       kmode_of(kx, kgrid(step, N, iy), (float)(step * (double)(kz0 + b))),
       b, ix, iy, out, n, ((int64_t)b * N + ix) * N + iy);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
factors_kz_kernel(const float2* __restrict__ src, int64_t sx, int64_t sy,
                  float2* __restrict__ out, int N, int kz0, int B, Op op) {
  kz_tile(src, sx, sy, out, N, kz0, B, op);
}

// K2, K5 and K8 on the whole grid: the kz-fastest form over every kz plane
// of a resident [N, N, Nh] spectrum, each value times scale, into [ncomp,
// Nh, N, N].  It carries the window kernel's name, as these three kernels
// always have: benchmark/roofline/kspace_{hessian,gradient,gradient_tab}
// find their device time by it.
template <class Op>
__global__ void __launch_bounds__(kThreads)
window_kernel(const float2* __restrict__ src, float2* __restrict__ out,
              int N, Op op, float scale) {
  const int nh = N / 2 + 1;
  kz_tile(src, (int64_t)N * nh, nh, out, N, 0, nh, Scaled<Op>{op, scale});
}

// The rows form: iy contiguous, element (b, ix, iy) at src[b * sb + ix * sx
// + iy] (K9's planes, K19's widened batches).  A block takes one (b, ix)
// row, its lanes consecutive iy: reads and writes are rows; the row's
// indices, k_x and k_z are set up once, with no 64-bit division.
template <class Op>
__global__ void __launch_bounds__(kThreads)
factors_rows_kernel(const float2* __restrict__ src, int64_t sb, int64_t sx,
                    float2* __restrict__ out, int N, int kz0, int B, Op op) {
  const int row = blockIdx.x;
  const int b = row / N, ix = row - b * N;
  const float2* s = src + (int64_t)b * sb + (int64_t)ix * sx;
  const int64_t n = (int64_t)B * N * N, o = (int64_t)row * N;
  const double step = kstep(N);
  const float kx = kgrid(step, N, ix), kz = (float)(step * (double)(kz0 + b));
  for (int iy = threadIdx.x; iy < N; iy += kThreads)
    op(__ldg(s + iy), kmode_of(kx, kgrid(step, N, iy), kz), b, ix, iy, out,
       n, o + iy);
}

// the window's mode count, or -1 for a window outside the k layout
int64_t window_modes(const Window& w) {
  if (w.y0 < 0 || w.ny < 0 || w.y0 + w.ny > w.N || w.z0 < 0 || w.nz < 0)
    return -1;
  return (int64_t)w.N * w.ny * w.nz;
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// at most 2^31 - 1 blocks; rows (N ny) and a row's modes fit 31 bits
template <class Op>
int launch_window(const void* src, void* out, Window w, Op op,
                  void* stream) {
  const int64_t nmodes = window_modes(w);
  if (nmodes < 0 || (int64_t)w.N * w.ny > INT32_MAX ||
      nmodes / kChunk >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (nmodes == 0) return 0;
  const unsigned blocks = (unsigned)((nmodes + kChunk - 1) / kChunk);
  if (aligned16(src) && aligned16(out) && nmodes % 2 == 0)
    window_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)src, (float2*)out, w, nmodes, op);
  else
    window_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)src, (float2*)out, w, nmodes, op);
  return (int)cudaGetLastError();
}

using TabGradientOp = GradientOp<TableGrowth<LdgTable>>;

int launch_gradient_tab(const void* src, void* out, Window w,
                        const void* gtab, int ntab, float glo, float gdx,
                        float tmax, void* stream) {
  if (ntab < 2) return (int)cudaErrorInvalidValue;
  return launch_window(
      src, out, w,
      TabGradientOp{{LdgTable{(const float*)gtab}, glo, gdx, tmax}}, stream);
}

// K10 and K14: one entry point a mode and form.  The kz-fastest form (the
// source's kz stride 1) takes the source's x and y strides, the rows form
// (its y stride 1) its kz and x strides, in complex elements; out [ncomp,
// B, N, N] for the planes kz0..kz0+B-1.
template <class Op>
int launch_factors_kz(const void* src, int64_t sx, int64_t sy, void* out,
                      int N, int kz0, int B, Op op, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (B < 0 || N < 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTileY - 1) / kTileY, N, (B + kTileZ - 1) / kTileZ);
  factors_kz_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)src, sx, sy, (float2*)out, N, kz0, B, op);
  return (int)cudaGetLastError();
}

template <class Op>
int launch_factors_rows(const void* src, int64_t sb, int64_t sx, void* out,
                        int N, int kz0, int B, Op op, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (B < 0 || N < 0 || (int64_t)B * N > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  factors_rows_kernel<<<(unsigned)(B * N), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float2*)src, sb, sx, (float2*)out, N, kz0, B, op);
  return (int)cudaGetLastError();
}

// K2, K5, K8: src the contiguous [N, N, Nh] spectrum, out [ncomp, Nh, N, N]
// (every kz plane, as K10's kz-fastest form lays out a batch of them)
template <class Op>
int launch_spectrum(const void* src, void* out, int N, Op op, float scale,
                    void* stream) {
  if (N == 0) return 0;
  if (N < 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTileY - 1) / kTileY, N,
                  (N / 2 + 1 + kTileZ - 1) / kTileZ);
  window_kernel<Op><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)src, (float2*)out, N, op, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kspace_hessian(const void* delta, void* out, int N,
                              float R_grid, float scale, void* stream) {
  return launch_spectrum(delta, out, N, HessianOp{R_grid}, scale, stream);
}

extern "C" int kspace_gradient(const void* src, void* out, int N,
                               float growth, float scale, void* stream) {
  return launch_spectrum(src, out, N, GradientOp<ScalarGrowth>{{growth}},
                         scale, stream);
}

// gtab: [ntab] growth over log10 |k| from glo in steps of gdx; tmax: the
// float32 clip of the table coordinate, ntab - 1.001
extern "C" int kspace_gradient_tab(const void* src, void* out, int N,
                                   const void* gtab, int ntab, float glo,
                                   float gdx, float tmax, float scale,
                                   void* stream) {
  if (ntab < 2) return (int)cudaErrorInvalidValue;
  return launch_spectrum(
      src, out, N,
      TabGradientOp{{LdgTable{(const float*)gtab}, glo, gdx, tmax}}, scale,
      stream);
}

// K2s, K5s, K8s: src [N, ny, nz], the window at (y0, z0) of a mesh's k
// layout; out [ncomp, N, ny, nz]
extern "C" int kspace_hessian_shard(const void* delta, void* out, int N,
                                    int y0, int ny, int z0, int nz,
                                    float R_grid, void* stream) {
  return launch_window(delta, out, Window{N, y0, ny, z0, nz},
                          HessianOp{R_grid}, stream);
}

extern "C" int kspace_gradient_shard(const void* src, void* out, int N,
                                     int y0, int ny, int z0, int nz,
                                     float growth, void* stream) {
  return launch_window(src, out, Window{N, y0, ny, z0, nz},
                          GradientOp<ScalarGrowth>{{growth}}, stream);
}

extern "C" int kspace_gradient_tab_shard(const void* src, void* out, int N,
                                         int y0, int ny, int z0, int nz,
                                         const void* gtab, int ntab,
                                         float glo, float gdx, float tmax,
                                         void* stream) {
  return launch_gradient_tab(src, out, Window{N, y0, ny, z0, nz}, gtab, ntab,
                             glo, gdx, tmax, stream);
}

extern "C" int ooc_hessian_rows(const void* src, int64_t sb, int64_t sx,
                                void* out, int N, int kz0, int B,
                                float R_grid, void* stream) {
  return launch_factors_rows(src, sb, sx, out, N, kz0, B, HessianOp{R_grid},
                             stream);
}

extern "C" int ooc_gradient_kz(const void* src, int64_t sx, int64_t sy,
                               void* out, int N, int kz0, int B,
                               float growth, void* stream) {
  return launch_factors_kz(src, sx, sy, out, N, kz0, B,
                           GradientOp<ScalarGrowth>{{growth}}, stream);
}

extern "C" int ooc_gradient_rows(const void* src, int64_t sb, int64_t sx,
                                 void* out, int N, int kz0, int B,
                                 float growth, void* stream) {
  return launch_factors_rows(src, sb, sx, out, N, kz0, B,
                             GradientOp<ScalarGrowth>{{growth}}, stream);
}

// K14: gtab [ntab] growth over log10 |k| (see kspace_gradient_tab)
extern "C" int ooc_gradient_tab_kz(const void* src, int64_t sx, int64_t sy,
                                   void* out, int N, int kz0, int B,
                                   const void* gtab, int ntab, float glo,
                                   float gdx, float tmax, void* stream) {
  if (ntab < 2) return (int)cudaErrorInvalidValue;
  return launch_factors_kz(
      src, sx, sy, out, N, kz0, B,
      TabGradientOp{{LdgTable{(const float*)gtab}, glo, gdx, tmax}},
      stream);
}

extern "C" int ooc_gradient_tab_rows(const void* src, int64_t sb,
                                     int64_t sx, void* out, int N, int kz0,
                                     int B, const void* gtab, int ntab,
                                     float glo, float gdx, float tmax,
                                     void* stream) {
  if (ntab < 2) return (int)cudaErrorInvalidValue;
  return launch_factors_rows(
      src, sb, sx, out, N, kz0, B,
      TabGradientOp{{LdgTable{(const float*)gtab}, glo, gdx, tmax}},
      stream);
}

// the pair mode: src0 (iy contiguous) with its kz and x strides, then src1
// with the strides of its form; ia, ib in 0..2
extern "C" int ooc_pair_kz(const void* src0, int64_t s0b, int64_t s0x,
                           const void* src1, int64_t s1x, int64_t s1y,
                           void* out, int N, int kz0, int B, int ia, int ib,
                           void* stream) {
  if (ia < 0 || ia > 2 || ib < 0 || ib > 2) return (int)cudaErrorInvalidValue;
  return launch_factors_kz(src1, s1x, s1y, out, N, kz0, B,
                           PairOp{(const float2*)src0, s0b, s0x, ia, ib},
                           stream);
}

extern "C" int ooc_pair_rows(const void* src0, int64_t s0b, int64_t s0x,
                             const void* src1, int64_t s1b, int64_t s1x,
                             void* out, int N, int kz0, int B, int ia,
                             int ib, void* stream) {
  if (ia < 0 || ia > 2 || ib < 0 || ib > 2) return (int)cudaErrorInvalidValue;
  return launch_factors_rows(src1, s1b, s1x, out, N, kz0, B,
                             PairOp{(const float2*)src0, s0b, s0x, ia, ib},
                             stream);
}
