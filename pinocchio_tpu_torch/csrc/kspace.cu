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
// The c2r transforms that follow stay torch.fft (cuFFT), as the JAX package
// leaves them to XLA's FFT.
//
// What bounds it on the H100: device memory bytes.  The Hessian mode reads
// one complex64 mode and writes six (56 B per mode, 0.48 GB at 256^3); the
// gradient mode reads one and writes three (32 B).  The arithmetic (one
// expf, a dozen multiplies) is far below the memory line.  Design: one
// thread per mode reads delta(k) once and writes every output from
// registers; k_x, k_y, k_z come from the thread's own mode indices (no
// tables), with consecutive threads on consecutive kz so that loads and
// each of the output planes are coalesced.  The float operations keep the
// JAX order: base = delta * (smooth * inv_k2), then base * (k_a * k_b).
// The tabulated-growth mode adds a log10f and a two-entry table read per
// mode (still far below the memory line); its table (512 floats) is copied
// to shared memory by each block.  K10 works on one batch of B kz planes
// ([B, N, N], a few MB) and is bound the same way: 8 B (16 B in pair mode)
// read and 48, 24 or 16 B written per mode.  Its source is read through
// strides, so a batch of a resident [N, N, Nh] spectrum needs no copy: there
// consecutive threads read 8 B apart by Nh (one sector each), which makes
// the gradient and pair modes on a spectrum slower than the hessian mode on
// K9's contiguous planes.  K14 is the gradient mode with K8's lookup, every
// float operation K8's, so its rows are the dense engine's; it is bound as
// K10's gradient mode, by bytes.  It has one form per source layout: on a
// spectrum's window (kz fastest) a block reads a tile of (ix, 64 iy) x 16 kz
// with lanes on consecutive kz, so each (ix, iy)'s run is one read, and
// writes it through shared memory with lanes on consecutive iy; on
// contiguous planes a block takes a (kz, ix) row.  Its table is read
// through the read-only path (no per-block copy or barrier).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct KMode {
  float kx, ky, kz, k2, inv_k2;
};

// k in grid units: 2*pi/N * m computed in double and rounded once, which is
// what the JAX package's float64 numpy table cast to float32 holds
__device__ __forceinline__ float kunit(int N, int m) {
  return (float)(6.283185307179586 / (double)N * (double)m);
}

__device__ __forceinline__ KMode kmode_at(int N, int ix, int iy, int iz) {
  const int half = N / 2;
  KMode k;
  k.kx = kunit(N, ix <= half ? ix : ix - N);
  k.ky = kunit(N, iy <= half ? iy : iy - N);
  k.kz = fabsf(kunit(N, iz));
  k.k2 = __fadd_rn(__fadd_rn(__fmul_rn(k.kx, k.kx), __fmul_rn(k.ky, k.ky)),
                   __fmul_rn(k.kz, k.kz));
  k.inv_k2 = k.k2 > 0.0f ? __fdiv_rn(1.0f, k.k2) : 0.0f;
  return k;
}

// a window [N, y0:y0+ny, z0:z0+nz] of the k layout; the full grid is
// (0, N, 0, Nh)
struct Window {
  int N, y0, ny, z0, nz;
};

// the mode of the window's flat index idx; false on a padded plane iz >= Nh
__device__ __forceinline__ bool kmode(const Window& w, int64_t idx,
                                      KMode& k) {
  const int iz = w.z0 + (int)(idx % w.nz);
  const int64_t rest = idx / w.nz;
  if (iz > w.N / 2) return false;
  k = kmode_at(w.N, (int)(rest / w.ny), w.y0 + (int)(rest % w.ny), iz);
  return true;
}

__device__ __forceinline__ void zero_out(float2* __restrict__ out, int ncomp,
                                         int64_t nmodes, int64_t idx) {
  for (int c = 0; c < ncomp; ++c)
    out[c * nmodes + idx] = make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(__fmul_rn(a.x, s), __fmul_rn(a.y, s));
}

__global__ void hessian_kernel(const float2* __restrict__ delta,
                               float2* __restrict__ out, Window w,
                               int64_t nmodes, float R) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nmodes) return;
  KMode k;
  if (!kmode(w, idx, k)) return zero_out(out, 6, nmodes, idx);
  // exp(-0.5 * k2 * R * R), evaluated left to right like the JAX expression
  const float arg = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, k.k2), R), R);
  const float s = __fmul_rn(expf(arg), k.inv_k2);
  const float2 base = cscale(__ldg(delta + idx), s);
  out[idx] = cscale(base, __fmul_rn(k.kx, k.kx));
  out[nmodes + idx] = cscale(base, __fmul_rn(k.ky, k.ky));
  out[2 * nmodes + idx] = cscale(base, __fmul_rn(k.kz, k.kz));
  out[3 * nmodes + idx] = cscale(base, __fmul_rn(k.kx, k.ky));
  out[4 * nmodes + idx] = cscale(base, __fmul_rn(k.kx, k.kz));
  out[5 * nmodes + idx] = cscale(base, __fmul_rn(k.ky, k.kz));
}

__global__ void gradient_kernel(const float2* __restrict__ src,
                                float2* __restrict__ out, Window w,
                                int64_t nmodes, float growth) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nmodes) return;
  KMode k;
  if (!kmode(w, idx, k)) return zero_out(out, 3, nmodes, idx);
  const float2 d = __ldg(src + idx);
  // (a + ib) * (i g) = (-b g, a g), then * inv_k2, then * k_a
  float2 base = make_float2(-__fmul_rn(d.y, growth), __fmul_rn(d.x, growth));
  base = cscale(base, k.inv_k2);
  out[idx] = cscale(base, k.kx);
  out[nmodes + idx] = cscale(base, k.ky);
  out[2 * nmodes + idx] = cscale(base, k.kz);
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

__global__ void gradient_tab_kernel(const float2* __restrict__ src,
                                    float2* __restrict__ out, Window w,
                                    int64_t nmodes,
                                    const float* __restrict__ gtab, int ntab,
                                    float glo, float gdx, float tmax) {
  extern __shared__ float s_tab[];
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = gtab[i];
  __syncthreads();
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nmodes) return;
  KMode k;
  if (!kmode(w, idx, k)) return zero_out(out, 3, nmodes, idx);
  const float* tab = s_tab;
  const float growth = growth_at(tab, k.k2, glo, gdx, tmax);
  const float2 d = __ldg(src + idx);
  float2 base = make_float2(-__fmul_rn(d.y, growth), __fmul_rn(d.x, growth));
  base = cscale(base, k.inv_k2);
  out[idx] = cscale(base, k.kx);
  out[nmodes + idx] = cscale(base, k.ky);
  out[2 * nmodes + idx] = cscale(base, k.kz);
}

// ---- K10: the out-of-core engine's factors on one batch of kz planes ----
// A source batch is [B, N, N] in (kz, x, y) order: K9's planes, or the
// planes kz0..kz0+B-1 of a resident [N, N, Nh] spectrum, read through its
// strides (element (b, ix, iy) at src[b * sb + ix * sx + iy * sy]).  The
// output is the contiguous [ncomp, B, N, N] input of one batched ifft2.
// Each mode's factor is computed as in K2, K5 and the R=0 Hessian, op for
// op, so a half transform holds the dense engine's values.

struct Batch {
  const float2* p;
  int64_t sb, sx, sy;
};

__device__ __forceinline__ float2 batch_at(const Batch& s, int b, int ix,
                                           int iy) {
  return __ldg(s.p + b * s.sb + ix * s.sx + iy * s.sy);
}

__device__ __forceinline__ void batch_mode(int64_t idx, int N, int kz0,
                                           int& b, int& ix, int& iy,
                                           KMode& k) {
  iy = (int)(idx % N);
  const int64_t rest = idx / N;
  ix = (int)(rest % N);
  b = (int)(rest / N);
  k = kmode_at(N, ix, iy, kz0 + b);
}

__global__ void ooc_hessian_kernel(Batch src, float2* __restrict__ out,
                                   int N, int kz0, int64_t n, float R) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int b, ix, iy;
  KMode k;
  batch_mode(idx, N, kz0, b, ix, iy, k);
  const float arg = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, k.k2), R), R);
  const float s = __fmul_rn(expf(arg), k.inv_k2);
  const float2 base = cscale(batch_at(src, b, ix, iy), s);
  out[idx] = cscale(base, __fmul_rn(k.kx, k.kx));
  out[n + idx] = cscale(base, __fmul_rn(k.ky, k.ky));
  out[2 * n + idx] = cscale(base, __fmul_rn(k.kz, k.kz));
  out[3 * n + idx] = cscale(base, __fmul_rn(k.kx, k.ky));
  out[4 * n + idx] = cscale(base, __fmul_rn(k.kx, k.kz));
  out[5 * n + idx] = cscale(base, __fmul_rn(k.ky, k.kz));
}

__global__ void ooc_gradient_kernel(Batch src, float2* __restrict__ out,
                                    int N, int kz0, int64_t n,
                                    float growth) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int b, ix, iy;
  KMode k;
  batch_mode(idx, N, kz0, b, ix, iy, k);
  const float2 d = batch_at(src, b, ix, iy);
  float2 base = make_float2(-__fmul_rn(d.y, growth), __fmul_rn(d.x, growth));
  base = cscale(base, k.inv_k2);
  out[idx] = cscale(base, k.kx);
  out[n + idx] = cscale(base, k.ky);
  out[2 * n + idx] = cscale(base, k.kz);
}

// K14: the gradient mode with the per-mode growth of a table, as K8, every
// float operation K8's; out[c][b][ix][iy] for b < B from the source mode
// (b, ix, iy).  Two forms, by the source's layout.
__device__ __forceinline__ void gradient_tab_mode(
    float2 d, int N, int kz, int ix, int iy, const LdgTable& tab, float glo,
    float gdx, float tmax, float2* __restrict__ out, int64_t n, int64_t o) {
  const KMode k = kmode_at(N, ix, iy, kz);
  const float growth = growth_at(tab, k.k2, glo, gdx, tmax);
  float2 base = make_float2(-__fmul_rn(d.y, growth), __fmul_rn(d.x, growth));
  base = cscale(base, k.inv_k2);
  out[o] = cscale(base, k.kx);
  out[n + o] = cscale(base, k.ky);
  out[2 * n + o] = cscale(base, k.kz);
}

// The kz-fastest form: a resident spectrum's window, element (b, ix, iy) at
// src[b + ix * sx + iy * sy].  A block takes one ix, kTabTY iy and up to
// kTabBZ kz: lanes read consecutive kz, so each (ix, iy)'s run of 8 B a kz
// is one coalesced read, into a tile padded against bank conflicts; then
// lanes take consecutive iy of one kz and write each component's row.
constexpr int kTabTY = 64;
constexpr int kTabBZ = 16;

__global__ void __launch_bounds__(kThreads)
ooc_gradient_tab_kz_kernel(const float2* __restrict__ src, int64_t sx,
                           int64_t sy, float2* __restrict__ out, int N,
                           int kz0, int B, LdgTable tab, float glo,
                           float gdx, float tmax) {
  __shared__ float2 tile[kTabBZ][kTabTY + 1];
  const int iy0 = blockIdx.x * kTabTY, ix = blockIdx.y;
  const int b0 = blockIdx.z * kTabBZ;
  const int nb = min(kTabBZ, B - b0), ny = min(kTabTY, N - iy0);
  const float2* s = src + (int64_t)ix * sx + (int64_t)iy0 * sy + b0;
  for (int e = threadIdx.x; e < ny * nb; e += kThreads) {
    const int y = e / nb, b = e - y * nb;
    tile[b][y] = __ldg(s + (int64_t)y * sy + b);
  }
  __syncthreads();
  const int64_t n = (int64_t)B * N * N;
  for (int e = threadIdx.x; e < nb * kTabTY; e += kThreads) {
    const int b = e / kTabTY, y = e % kTabTY;
    if (y >= ny) continue;
    gradient_tab_mode(tile[b][y], N, kz0 + b0 + b, ix, iy0 + y, tab, glo,
                      gdx, tmax, out, n,
                      ((int64_t)(b0 + b) * N + ix) * N + iy0 + y);
  }
}

// The contiguous form: iy contiguous, element (b, ix, iy) at src[b * sb +
// ix * sx + iy] (K9's planes, K19's widened batches).  A block takes one
// (b, ix) row, its lanes consecutive iy: reads and writes are rows.
__global__ void __launch_bounds__(kThreads)
ooc_gradient_tab_rows_kernel(const float2* __restrict__ src, int64_t sb,
                             int64_t sx, float2* __restrict__ out, int N,
                             int kz0, int B, LdgTable tab, float glo,
                             float gdx, float tmax) {
  const int row = blockIdx.x;
  const int b = row / N, ix = row - b * N;
  const float2* s = src + (int64_t)b * sb + (int64_t)ix * sx;
  const int64_t n = (int64_t)B * N * N, o = (int64_t)row * N;
  for (int iy = threadIdx.x; iy < N; iy += kThreads)
    gradient_tab_mode(__ldg(s + iy), N, kz0 + b, ix, iy, tab, glo, gdx,
                      tmax, out, n, o + iy);
}

// the 3LPT-b fold operands of one Hessian component (a, b): k_a k_b / k^2
// on two sources (the density and the 2LPT source spectrum)
__global__ void ooc_pair_kernel(Batch src0, Batch src1,
                                float2* __restrict__ out, int N, int kz0,
                                int64_t n, int ia, int ib) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  int b, ix, iy;
  KMode k;
  batch_mode(idx, N, kz0, b, ix, iy, k);
  const float kv[3] = {k.kx, k.ky, k.kz};
  const float f = __fmul_rn(kv[ia], kv[ib]);
  out[idx] = cscale(cscale(batch_at(src0, b, ix, iy), k.inv_k2), f);
  out[n + idx] = cscale(cscale(batch_at(src1, b, ix, iy), k.inv_k2), f);
}

// the window's mode count, or -1 for a window outside the k layout
int64_t window_modes(const Window& w) {
  if (w.y0 < 0 || w.ny < 0 || w.y0 + w.ny > w.N || w.z0 < 0 || w.nz < 0)
    return -1;
  return (int64_t)w.N * w.ny * w.nz;
}

int launch_hessian(const void* delta, void* out, Window w, float R_grid,
                   void* stream) {
  const int64_t nmodes = window_modes(w);
  if (nmodes < 0) return (int)cudaErrorInvalidValue;
  if (nmodes == 0) return 0;
  const int64_t blocks = (nmodes + kThreads - 1) / kThreads;
  hessian_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)delta, (float2*)out, w, nmodes, R_grid);
  return (int)cudaGetLastError();
}

int launch_gradient(const void* src, void* out, Window w, float growth,
                    void* stream) {
  const int64_t nmodes = window_modes(w);
  if (nmodes < 0) return (int)cudaErrorInvalidValue;
  if (nmodes == 0) return 0;
  const int64_t blocks = (nmodes + kThreads - 1) / kThreads;
  gradient_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)src, (float2*)out, w, nmodes, growth);
  return (int)cudaGetLastError();
}

int launch_gradient_tab(const void* src, void* out, Window w,
                        const void* gtab, int ntab, float glo, float gdx,
                        float tmax, void* stream) {
  const int64_t nmodes = window_modes(w);
  if (nmodes < 0) return (int)cudaErrorInvalidValue;
  if (nmodes == 0) return 0;
  const int64_t blocks = (nmodes + kThreads - 1) / kThreads;
  gradient_tab_kernel<<<(unsigned)blocks, kThreads, ntab * sizeof(float),
                        (cudaStream_t)stream>>>(
      (const float2*)src, (float2*)out, w, nmodes, (const float*)gtab, ntab,
      glo, gdx, tmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kspace_hessian(const void* delta, void* out, int N,
                              float R_grid, void* stream) {
  return launch_hessian(delta, out, Window{N, 0, N, 0, N / 2 + 1}, R_grid,
                        stream);
}

extern "C" int kspace_gradient(const void* src, void* out, int N,
                               float growth, void* stream) {
  return launch_gradient(src, out, Window{N, 0, N, 0, N / 2 + 1}, growth,
                         stream);
}

// gtab: [ntab] growth over log10 |k| from glo in steps of gdx; tmax: the
// float32 clip of the table coordinate, ntab - 1.001
extern "C" int kspace_gradient_tab(const void* src, void* out, int N,
                                   const void* gtab, int ntab, float glo,
                                   float gdx, float tmax, void* stream) {
  return launch_gradient_tab(src, out, Window{N, 0, N, 0, N / 2 + 1}, gtab,
                             ntab, glo, gdx, tmax, stream);
}

// K2s, K5s, K8s: src [N, ny, nz], the window at (y0, z0) of a mesh's k
// layout; out [ncomp, N, ny, nz]
extern "C" int kspace_hessian_shard(const void* delta, void* out, int N,
                                    int y0, int ny, int z0, int nz,
                                    float R_grid, void* stream) {
  return launch_hessian(delta, out, Window{N, y0, ny, z0, nz}, R_grid,
                        stream);
}

extern "C" int kspace_gradient_shard(const void* src, void* out, int N,
                                     int y0, int ny, int z0, int nz,
                                     float growth, void* stream) {
  return launch_gradient(src, out, Window{N, y0, ny, z0, nz}, growth,
                         stream);
}

extern "C" int kspace_gradient_tab_shard(const void* src, void* out, int N,
                                         int y0, int ny, int z0, int nz,
                                         const void* gtab, int ntab,
                                         float glo, float gdx, float tmax,
                                         void* stream) {
  return launch_gradient_tab(src, out, Window{N, y0, ny, z0, nz}, gtab, ntab,
                             glo, gdx, tmax, stream);
}

// K10 entry points: src* and its strides s*b, s*x, s*y (in complex
// elements); out [ncomp, B, N, N]
extern "C" int ooc_factors_hessian(const void* src, int64_t sb, int64_t sx,
                                   int64_t sy, void* out, int N, int kz0,
                                   int B, float R_grid, void* stream) {
  const int64_t n = (int64_t)B * N * N;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  ooc_hessian_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Batch{(const float2*)src, sb, sx, sy}, (float2*)out, N, kz0, n, R_grid);
  return (int)cudaGetLastError();
}

extern "C" int ooc_factors_gradient(const void* src, int64_t sb, int64_t sx,
                                    int64_t sy, void* out, int N, int kz0,
                                    int B, float growth, void* stream) {
  const int64_t n = (int64_t)B * N * N;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  ooc_gradient_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      Batch{(const float2*)src, sb, sx, sy}, (float2*)out, N, kz0, n, growth);
  return (int)cudaGetLastError();
}

// K14: gtab [ntab] growth over log10 |k| (see kspace_gradient_tab); out
// [3, B, N, N].  The kz-fastest form (the source's kz stride 1) takes the
// source's x and y strides, the contiguous form (y stride 1) its kz and x
// strides, in complex elements.
extern "C" int ooc_gradient_tab_kz(const void* src, int64_t sx, int64_t sy,
                                   void* out, int N, int kz0, int B,
                                   const void* gtab, int ntab, float glo,
                                   float gdx, float tmax, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (ntab < 2 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTabTY - 1) / kTabTY, N, (B + kTabBZ - 1) / kTabBZ);
  ooc_gradient_tab_kz_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)src, sx, sy, (float2*)out, N, kz0, B,
      LdgTable{(const float*)gtab}, glo, gdx, tmax);
  return (int)cudaGetLastError();
}

extern "C" int ooc_gradient_tab_rows(const void* src, int64_t sb,
                                     int64_t sx, void* out, int N, int kz0,
                                     int B, const void* gtab, int ntab,
                                     float glo, float gdx, float tmax,
                                     void* stream) {
  if (B == 0 || N == 0) return 0;
  if (ntab < 2 || (int64_t)B * N > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  ooc_gradient_tab_rows_kernel<<<(unsigned)(B * N), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float2*)src, sb, sx, (float2*)out, N, kz0, B,
      LdgTable{(const float*)gtab}, glo, gdx, tmax);
  return (int)cudaGetLastError();
}

extern "C" int ooc_factors_pair(const void* src0, int64_t s0b, int64_t s0x,
                                int64_t s0y, const void* src1, int64_t s1b,
                                int64_t s1x, int64_t s1y, void* out, int N,
                                int kz0, int B, int ia, int ib,
                                void* stream) {
  const int64_t n = (int64_t)B * N * N;
  if (n == 0) return 0;
  if (ia < 0 || ia > 2 || ib < 0 || ib > 2) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  ooc_pair_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Batch{(const float2*)src0, s0b, s0x, s0y},
      Batch{(const float2*)src1, s1b, s1x, s1y}, (float2*)out, N, kz0, n, ia,
      ib);
  return (int)cudaGetLastError();
}
