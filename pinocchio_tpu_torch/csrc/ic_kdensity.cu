// Initial conditions: delta(k) on the rfftn grid [N, N, N/2+1] (K1) or on a
// shard's window of it (K1s), and a batch of kz planes of the out-of-core
// engine's realization (K9).
//
// K1 replaces pinocchio_tpu/ic.py:_kdensity_jit (lines 49-104), K1s
// pinocchio_tpu/parallel/driver.py:build_kdensity (lines 42-69, the same
// draws generated into a mesh's k layout), K9 kdensity_plane_fn.plane
// (lines 128-178).  JAX draws the
// phase and amplitude of every mode with the counter-based threefry2x32
// generator (jax_threefry_partitionable), so each thread derives its own
// bits from (key, flat mode index) and the field is bit-for-bit the same
// draws as the JAX package's:
//   bits(i)  = o0 ^ o1 with (o0, o1) = threefry2x32(key, hi32(i), lo32(i))
//   uniform  = bitcast((bits >> 9) | 0x3f800000) - 1, scaled to
//              [min, max) and clamped below at min (jax.random.uniform)
// A dependent mode of the kz=0 plane (ix > N/2, or ix == 0 and iy > N/2)
// draws from its mirrored mode's flat index and conjugates, so the kernel
// needs no gather.  P(k) is the host's log-log table, interpolated like
// jnp.interp (searchsorted right, clamped at both ends).
//
// K1s computes the window [N, y0:y0+ny, z0:z0+nz] of the [N, N, Nhp] k layout
// of a mesh (Nhp >= Nh pads the kz axis so that it splits evenly): each mode
// draws at its GLOBAL counter (ix * N + iy) * Nh + iz, and a dependent mode
// of the kz=0 plane at its mirror's global counter, so every shard holds the
// single-device field's values and a mirror partner in another shard needs
// no exchange; the padded planes iz >= Nh are written as exact zeros.  K1 is
// the window (0, N, 0, Nh) of the same kernel.
//
// What bounds it on the H100: arithmetic, not bytes (8 B written per mode):
// two 20-round threefry evaluations, a 12-step binary search in a 16 KB
// table that stays in L1, and powf, logf, sqrtf, sinf, cosf, log10f.  One
// thread per mode, consecutive threads on consecutive kz (K1) or iy (K9),
// so the complex64 stores are coalesced.  K9 reads its plane's four key
// words from a small table (computed on the host: fold_in, then split), so
// it does no more threefry work per mode than K1.  The scale-and-offset of
// the uniform is written with __fmul_rn/__fadd_rn so that it is not
// contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t counter) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(counter >> 32) + k0;
  uint32_t x1 = (uint32_t)(counter & 0xffffffffu) + k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

// jax.random.uniform at one counter: minval + [0, 1) * (maxval - minval),
// clamped below at minval; span = maxval - minval in float32
__device__ __forceinline__ float draw_uniform(uint32_t k0, uint32_t k1,
                                              uint64_t counter, float minval,
                                              float span) {
  const uint32_t bits = threefry_bits(k0, k1, counter);
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return fmaxf(minval, __fadd_rn(__fmul_rn(u, span), minval));
}

__device__ __forceinline__ float interp(float x, const float* __restrict__ xp,
                                        const float* __restrict__ fp, int n) {
  if (x < __ldg(xp)) return __ldg(fp);
  if (x > __ldg(xp + n - 1)) return __ldg(fp + n - 1);
  int lo = 0, hi = n;  // searchsorted(xp, x, side="right")
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(xp + mid) <= x) lo = mid + 1; else hi = mid;
  }
  const int i = min(max(lo, 1), n - 1);
  const float x0 = __ldg(xp + i - 1), f0 = __ldg(fp + i - 1);
  const float dx = __fsub_rn(__ldg(xp + i), x0);
  const float df = __fsub_rn(__ldg(fp + i), f0);
  return __fadd_rn(f0, __fmul_rn(__fdiv_rn(__fsub_rn(x, x0), dx), df));
}

// delta of one mode from its integer |m|^2, its draw counter, the sign of
// its imaginary part and the phase and amplitude keys (shared by K1 and K9)
__device__ __forceinline__ float2 mode_value(
    int m2, bool alive, uint64_t draw, float sign, uint32_t kp0, uint32_t kp1,
    uint32_t ka0, uint32_t ka1, const float* __restrict__ logk,
    const float* __restrict__ logpk, int ntab, float logkf, float fac,
    int fixed, int paired) {
  const float amin = 1.1754944e-38f;
  // phase in [0, float32(2 pi)), amplitude draw in [amin, 1)
  float phase = draw_uniform(kp0, kp1, draw, 0.0f, 6.2831855f);
  const float ampl = draw_uniform(ka0, ka1, draw, amin, 1.0f);

  const float logkm = __fadd_rn(
      logkf, __fmul_rn(0.5f, log10f((float)(m2 > 1 ? m2 : 1))));
  float pofk = powf(10.0f, interp(logkm, logk, logpk, ntab));
  if (!fixed) pofk = __fmul_rn(pofk, -logf(ampl));
  if (paired) phase = __fadd_rn(phase, 3.14159274f);  // float32(pi)
  const float amp = alive ? __fmul_rn(fac, sqrtf(pofk)) : 0.0f;
  return make_float2(__fmul_rn(amp, cosf(phase)),
                     __fmul_rn(__fmul_rn(sign, amp), sinf(phase)));
}

__global__ void kdensity_kernel(float2* __restrict__ out,
                                const float* __restrict__ logk,
                                const float* __restrict__ logpk, int ntab,
                                uint32_t kp0, uint32_t kp1, uint32_t ka0,
                                uint32_t ka1, float logkf, float fac, int N,
                                int y0, int ny, int z0, int nz,
                                int64_t nmodes, int fixed, int paired) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nmodes) return;
  const int Nh = N / 2 + 1;
  const int iz = z0 + (int)(idx % nz);
  const int64_t rest = idx / nz;
  const int iy = y0 + (int)(rest % ny);
  const int ix = (int)(rest / ny);
  if (iz >= Nh) {                        // a padded plane of a mesh layout
    out[idx] = make_float2(0.0f, 0.0f);
    return;
  }
  const int half = N / 2;
  const int mx = ix <= half ? ix : ix - N;
  const int my = iy <= half ? iy : iy - N;
  const int m2 = mx * mx + my * my + iz * iz;
  const bool alive = !(abs(mx) == half || abs(my) == half || iz == half) &&
                     m2 > 0 && m2 <= half * half;

  // the mode's global counter; on the kz=0 plane's dependent half, the
  // mirrored mode's (Hermitian mirror)
  int64_t draw = ((int64_t)ix * N + iy) * Nh + iz;
  float sign = 1.0f;
  if (iz == 0 && (ix > half || (ix == 0 && iy > half))) {
    const int mix = (N - ix) % N, miy = (N - iy) % N;
    draw = ((int64_t)mix * N + miy) * Nh;
    sign = -1.0f;
  }
  out[idx] = mode_value(m2, alive, (uint64_t)draw, sign, kp0, kp1, ka0, ka1,
                        logk, logpk, ntab, logkf, fac, fixed, paired);
}

// K9: the kz planes kz0..kz0+B-1, out [B, N, N] (x, y within a plane).  The
// draws of plane kz use its own keys (keys[kz] = phase key, amplitude key,
// from fold_in(seed key, kz) and a split) at the counter ix * N + iy, the
// mirrored mode's counter on the dependent half of the kz=0 plane.
__global__ void kdensity_planes_kernel(float2* __restrict__ out,
                                       const float* __restrict__ logk,
                                       const float* __restrict__ logpk,
                                       int ntab,
                                       const uint32_t* __restrict__ keys,
                                       int kz0, float logkf, float fac, int N,
                                       int64_t nmodes, int fixed,
                                       int paired) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nmodes) return;
  const int iy = (int)(idx % N);
  const int64_t rest = idx / N;
  const int ix = (int)(rest % N);
  const int kz = kz0 + (int)(rest / N);
  const int half = N / 2;
  const int mx = ix <= half ? ix : ix - N;
  const int my = iy <= half ? iy : iy - N;
  const int m2 = mx * mx + my * my + kz * kz;
  const bool alive = !(abs(mx) == half || abs(my) == half || kz == half) &&
                     m2 > 0 && m2 <= half * half;
  int64_t draw = (int64_t)ix * N + iy;
  float sign = 1.0f;
  if (kz == 0 && (ix > half || (ix == 0 && iy > half))) {
    draw = (int64_t)((N - ix) % N) * N + (N - iy) % N;
    sign = -1.0f;
  }
  const uint32_t* k = keys + 4 * kz;
  out[idx] = mode_value(m2, alive, (uint64_t)draw, sign, __ldg(k),
                        __ldg(k + 1), __ldg(k + 2), __ldg(k + 3), logk, logpk,
                        ntab, logkf, fac, fixed, paired);
}

}  // namespace

namespace {

int launch_kdensity(void* out, const void* logk, const void* logpk, int ntab,
                    uint32_t kp0, uint32_t kp1, uint32_t ka0, uint32_t ka1,
                    float logkf, float fac, int N, int y0, int ny, int z0,
                    int nz, int fixed, int paired, void* stream) {
  if (y0 < 0 || ny < 0 || y0 + ny > N || z0 < 0 || nz < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nmodes = (int64_t)N * ny * nz;
  if (nmodes == 0) return 0;
  const int64_t blocks = (nmodes + kThreads - 1) / kThreads;
  kdensity_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float2*)out, (const float*)logk, (const float*)logpk, ntab, kp0, kp1,
      ka0, ka1, logkf, fac, N, y0, ny, z0, nz, nmodes, fixed, paired);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ic_kdensity(void* out, const void* logk, const void* logpk,
                           int ntab, uint32_t kp0, uint32_t kp1,
                           uint32_t ka0, uint32_t ka1, float logkf, float fac,
                           int N, int fixed, int paired, void* stream) {
  return launch_kdensity(out, logk, logpk, ntab, kp0, kp1, ka0, ka1, logkf,
                         fac, N, 0, N, 0, N / 2 + 1, fixed, paired, stream);
}

// K1s: out [N, ny, nz], the window at (y0, z0) of a mesh's k layout
extern "C" int ic_kdensity_shard(void* out, const void* logk,
                                 const void* logpk, int ntab, uint32_t kp0,
                                 uint32_t kp1, uint32_t ka0, uint32_t ka1,
                                 float logkf, float fac, int N, int y0,
                                 int ny, int z0, int nz, int fixed,
                                 int paired, void* stream) {
  return launch_kdensity(out, logk, logpk, ntab, kp0, kp1, ka0, ka1, logkf,
                         fac, N, y0, ny, z0, nz, fixed, paired, stream);
}

extern "C" int ic_kdensity_planes(void* out, const void* logk,
                                  const void* logpk, int ntab,
                                  const void* keys, int kz0, int B,
                                  float logkf, float fac, int N, int fixed,
                                  int paired, void* stream) {
  const int64_t nmodes = (int64_t)B * N * N;
  if (nmodes == 0) return 0;
  const int64_t blocks = (nmodes + kThreads - 1) / kThreads;
  kdensity_planes_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (float2*)out, (const float*)logk, (const float*)logpk, ntab,
      (const uint32_t*)keys, kz0, logkf, fac, N, nmodes, fixed, paired);
  return (int)cudaGetLastError();
}
