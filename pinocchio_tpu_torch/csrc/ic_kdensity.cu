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
// What bounds it on the H100: instruction issue, not bytes (8 B written per
// mode).  The design takes out of the per-mode path all work that the
// mode's value does not need:
// - P(k) depends on the mode only through the integer m2 = |m|^2, and a
//   live mode has m2 <= (N/2)^2.  A small kernel on the same stream
//   (pk_table_kernel) writes P(k) of every such m2 with the per-mode code
//   the kernel had (log10f, the table search, the division, powf), so the
//   table holds the same bits; the mode kernel reads pk[m2].  K1 and K1s
//   build it in each call, K9 once per generator;
// - a dead mode (a Nyquist plane, m2 = 0 or m2 > (N/2)^2, about half of the
//   rfft grid) is (+0 * cos(phase), (sign * +0) * sin(phase)): a zero whose
//   signs are those of cos and sin of its phase.  It draws the phase alone
//   and takes both signs from the quarter turns at or below the phase
//   (dead_zero): phases lie in [0, 2 pi) and, when paired, [pi, 3 pi), and
//   the quarter turns are the least float32 above k pi / 2.
//   phase_check_kernel proves the rule on the card against the plain
//   version's sin and cos for every phase the generator can draw (2^23
//   uniforms, and the same shifted by float32(pi));
// - a live mode takes sin and cos in one sincosf (one range reduction),
//   which the same proof holds bit for bit to the plain version's; the
//   amplitude draw and logf only without FixedIC;
// - the launch is 2-D: blockIdx.y is the outer index (ix for K1, the plane
//   for K9) and the flat index within it (< 2^31) splits into the inner two
//   by a multiply with a precomputed reciprocal (Div), not a 64-bit
//   division.
// One thread per mode, consecutive threads on consecutive kz (K1) or iy
// (K9), so the complex64 stores are coalesced and the warps at the sphere's
// edge diverge only where a row crosses it.  K9 reads its plane's four key
// words from a small table (computed on the host: fold_in, then split), so
// it does no more threefry work per mode than K1.  The scale-and-offset of
// the uniform is written with __fmul_rn/__fadd_rn so that it is not
// contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.2831855f;          // float32(2 pi)
constexpr float kPi = 3.14159274f;            // float32(pi)
constexpr float kAmplMin = 1.1754944e-38f;
// the least float32 above k pi / 2 for k = 1..8: a float x lies beyond
// k pi / 2 exactly when x >= kQuarter[k - 1]
__constant__ float kQuarter[8] = {0x1.921fb6p+0f, 0x1.921fb6p+1f,
                                  0x1.2d97c8p+2f, 0x1.921fb6p+2f,
                                  0x1.f6a7a4p+2f, 0x1.2d97c8p+3f,
                                  0x1.5fdbcp+3f,  0x1.921fb6p+3f};

// n / d for 0 <= n < 2^31 as (n * m) >> sh, with s = ceil(log2 d),
// m = ceil(2^(31+s) / d) < 2^32 and sh = 31 + s: n * m / 2^sh exceeds n / d
// by less than n / 2^(31+s) < 1 / d, so the floor is the quotient
struct Div {
  uint32_t m;
  int sh;
};

Div make_div(uint32_t d) {
  int s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t p = 1ull << (31 + s);
  return Div{(uint32_t)((p + d - 1) / d), 31 + s};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, Div v) {
  return (uint32_t)(((uint64_t)n * v.m) >> v.sh);
}

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

// jax.random.uniform of the generator's bits: minval + [0, 1) * (maxval -
// minval), clamped below at minval; span = maxval - minval in float32
__device__ __forceinline__ float uniform(uint32_t bits, float minval,
                                         float span) {
  const float u = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return fmaxf(minval, __fadd_rn(__fmul_rn(u, span), minval));
}

__device__ __forceinline__ float draw_uniform(uint32_t k0, uint32_t k1,
                                              uint64_t counter, float minval,
                                              float span) {
  return uniform(threefry_bits(k0, k1, counter), minval, span);
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

// P(k) of every |m|^2 = 0..n-1 (the per-mode code of the plain version:
// log10 |k| from m2, the log-log interpolation, 10^)
__global__ void __launch_bounds__(kThreads)
pk_table_kernel(float* __restrict__ pk, int n, const float* __restrict__ logk,
                const float* __restrict__ logpk, int ntab, float logkf) {
  const int m2 = blockIdx.x * kThreads + threadIdx.x;
  if (m2 >= n) return;
  const float logkm = __fadd_rn(
      logkf, __fmul_rn(0.5f, log10f((float)(m2 > 1 ? m2 : 1))));
  pk[m2] = powf(10.0f, interp(logkm, logk, logpk, ntab));
}

// the zero of a dead mode: (+0 * cos(phase), (sign * +0) * sin(phase)).
// For phases in [0, 4 pi), cos is negative where an odd number of the odd
// quarter turns pi/2, 3 pi/2, 5 pi/2, 7 pi/2 lie at or below the phase, and
// sin where an odd number of the even ones pi, 2 pi, 3 pi, 4 pi do
__device__ __forceinline__ float2 dead_zero(float phase, float sign) {
  const bool cneg = (phase >= kQuarter[0]) != (phase >= kQuarter[2]) !=
                    (phase >= kQuarter[4]) != (phase >= kQuarter[6]);
  const bool sneg = (phase >= kQuarter[1]) != (phase >= kQuarter[3]) !=
                    (phase >= kQuarter[5]) != (phase >= kQuarter[7]);
  return make_float2(cneg ? -0.0f : 0.0f,
                     sneg != (sign < 0.0f) ? -0.0f : 0.0f);
}

struct Keys {
  uint32_t kp0, kp1, ka0, ka1;  // phase key, amplitude key
};

// delta of one mode from its integer |m|^2, whether it is alive, its draw
// counter and the sign of its imaginary part (shared by K1 and K9)
__device__ __forceinline__ float2 mode_value(int m2, bool alive,
                                             uint64_t draw, float sign,
                                             const Keys& k,
                                             const float* __restrict__ pk,
                                             float fac, int fixed,
                                             int paired) {
  // phase in [0, float32(2 pi))
  float phase = draw_uniform(k.kp0, k.kp1, draw, 0.0f, kTwoPi);
  if (paired) phase = __fadd_rn(phase, kPi);
  if (!alive) return dead_zero(phase, sign);
  float pofk = __ldg(pk + m2);
  if (!fixed)  // amplitude draw in [amin, 1)
    pofk = __fmul_rn(pofk,
                     -logf(draw_uniform(k.ka0, k.ka1, draw, kAmplMin, 1.0f)));
  const float amp = __fmul_rn(fac, sqrtf(pofk));
  float s, c;
  sincosf(phase, &s, &c);
  return make_float2(__fmul_rn(amp, c), __fmul_rn(__fmul_rn(sign, amp), s));
}

struct Window {
  int N, y0, ny, z0, nz;
  uint32_t plane;  // ny * nz, the modes of one ix
  Div by_nz;
};

// K1/K1s: blockIdx.y = ix, the flat index r < ny * nz within it
__global__ void __launch_bounds__(kThreads)
kdensity_kernel(float2* __restrict__ out, const float* __restrict__ pk,
                Keys keys, float fac, Window w, int fixed, int paired) {
  const uint32_t r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= w.plane) return;
  const int ix = blockIdx.y;
  const uint32_t q = divide(r, w.by_nz);
  const int iy = w.y0 + (int)q;
  const int iz = w.z0 + (int)(r - q * (uint32_t)w.nz);
  float2* o = out + (int64_t)ix * w.plane + r;
  const int N = w.N, half = N / 2, Nh = half + 1;
  if (iz >= Nh) {                        // a padded plane of a mesh layout
    *o = make_float2(0.0f, 0.0f);
    return;
  }
  const int mx = ix <= half ? ix : ix - N;
  const int my = iy <= half ? iy : iy - N;
  const int m2 = mx * mx + my * my + iz * iz;
  const bool alive = !(abs(mx) == half || abs(my) == half || iz == half) &&
                     m2 > 0 && m2 <= half * half;

  // the mode's global counter; on the kz=0 plane's dependent half, the
  // mirrored mode's (Hermitian mirror)
  uint64_t draw = (uint64_t)((uint32_t)ix * N + iy) * Nh + iz;
  float sign = 1.0f;
  if (iz == 0 && (ix > half || (ix == 0 && iy > half))) {
    const uint32_t mix = ix ? N - ix : 0, miy = iy ? N - iy : 0;
    draw = (uint64_t)(mix * N + miy) * Nh;
    sign = -1.0f;
  }
  *o = mode_value(m2, alive, draw, sign, keys, pk, fac, fixed, paired);
}

// K9: the kz planes kz0..kz0+B-1, out [B, N, N] (x, y within a plane);
// blockIdx.y = the plane, the flat index r = ix * N + iy within it.  The
// draws of plane kz use its own keys (keys[kz] = phase key, amplitude key,
// from fold_in(seed key, kz) and a split) at the counter ix * N + iy, the
// mirrored mode's counter on the dependent half of the kz=0 plane.
__global__ void __launch_bounds__(kThreads)
kdensity_planes_kernel(float2* __restrict__ out, const float* __restrict__ pk,
                       const uint32_t* __restrict__ keys, int kz0, float fac,
                       int N, Div by_n, int fixed, int paired) {
  const uint32_t plane = (uint32_t)N * N;
  const uint32_t r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= plane) return;
  const int ix = (int)divide(r, by_n);
  const int iy = (int)(r - (uint32_t)ix * N);
  const int kz = kz0 + blockIdx.y;
  const int half = N / 2;
  const int mx = ix <= half ? ix : ix - N;
  const int my = iy <= half ? iy : iy - N;
  const int m2 = mx * mx + my * my + kz * kz;
  const bool alive = !(abs(mx) == half || abs(my) == half || kz == half) &&
                     m2 > 0 && m2 <= half * half;
  uint32_t draw = r;
  float sign = 1.0f;
  if (kz == 0 && (ix > half || (ix == 0 && iy > half))) {
    draw = (uint32_t)(ix ? N - ix : 0) * N + (iy ? N - iy : 0);
    sign = -1.0f;
  }
  const uint32_t* k = keys + 4 * kz;
  const Keys kk{__ldg(k), __ldg(k + 1), __ldg(k + 2), __ldg(k + 3)};
  out[(int64_t)blockIdx.y * plane + r] =
      mode_value(m2, alive, draw, sign, kk, pk, fac, fixed, paired);
}

// the proof of dead_zero and sincosf: every phase the generator can draw,
// i < 2^24: the uniform of the bits (i mod 2^23) << 9 scaled to [0, 2 pi),
// shifted by float32(pi) for i >= 2^23 (paired).  Writes the phase, its
// sincosf and dead_zero's signs (bit 0: cos negative, bit 1: sin negative)
__global__ void __launch_bounds__(kThreads)
phase_check_kernel(float* __restrict__ phase, float* __restrict__ sinv,
                   float* __restrict__ cosv, uint8_t* __restrict__ rule) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= (1u << 24)) return;
  float ph = uniform((i & 0x7fffffu) << 9, 0.0f, kTwoPi);
  if (i >> 23) ph = __fadd_rn(ph, kPi);
  float s, c;
  sincosf(ph, &s, &c);
  const float2 z = dead_zero(ph, 1.0f);
  phase[i] = ph;
  sinv[i] = s;
  cosv[i] = c;
  rule[i] = (uint8_t)(signbit(z.x) ? 1 : 0) | (signbit(z.y) ? 2 : 0);
}

// the table of P(k) for m2 = 0..(N/2)^2 into pk
int launch_table(float* pk, const void* logk, const void* logpk, int ntab,
                 float logkf, int N, cudaStream_t s) {
  const int n = (N / 2) * (N / 2) + 1;
  pk_table_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      pk, n, (const float*)logk, (const float*)logpk, ntab, logkf);
  return (int)cudaGetLastError();
}

int launch_kdensity(void* out, void* pk, const void* logk, const void* logpk,
                    int ntab, uint32_t kp0, uint32_t kp1, uint32_t ka0,
                    uint32_t ka1, float logkf, float fac, int N, int y0,
                    int ny, int z0, int nz, int fixed, int paired,
                    void* stream) {
  if (N < 1 || N > 65535 || y0 < 0 || ny < 0 || y0 + ny > N || z0 < 0 ||
      nz < 0 || (int64_t)ny * nz >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const uint32_t plane = (uint32_t)ny * nz;
  if (plane == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_table((float*)pk, logk, logpk, ntab, logkf, N, s);
  if (err != 0) return err;
  const Window w{N, y0, ny, z0, nz, plane, make_div((uint32_t)nz)};
  const dim3 grid((plane + kThreads - 1) / kThreads, N);
  kdensity_kernel<<<grid, kThreads, 0, s>>>((float2*)out, (const float*)pk,
                                            Keys{kp0, kp1, ka0, ka1}, fac, w,
                                            fixed, paired);
  return (int)cudaGetLastError();
}

}  // namespace

// out [N, N, N/2+1] complex64; pk [(N/2)^2 + 1] float32 scratch (the P(k)
// table, written first)
extern "C" int ic_kdensity(void* out, void* pk, const void* logk,
                           const void* logpk, int ntab, uint32_t kp0,
                           uint32_t kp1, uint32_t ka0, uint32_t ka1,
                           float logkf, float fac, int N, int fixed,
                           int paired, void* stream) {
  return launch_kdensity(out, pk, logk, logpk, ntab, kp0, kp1, ka0, ka1,
                         logkf, fac, N, 0, N, 0, N / 2 + 1, fixed, paired,
                         stream);
}

// K1s: out [N, ny, nz], the window at (y0, z0) of a mesh's k layout
extern "C" int ic_kdensity_shard(void* out, void* pk, const void* logk,
                                 const void* logpk, int ntab, uint32_t kp0,
                                 uint32_t kp1, uint32_t ka0, uint32_t ka1,
                                 float logkf, float fac, int N, int y0,
                                 int ny, int z0, int nz, int fixed,
                                 int paired, void* stream) {
  return launch_kdensity(out, pk, logk, logpk, ntab, kp0, kp1, ka0, ka1,
                         logkf, fac, N, y0, ny, z0, nz, fixed, paired,
                         stream);
}

// K9: out [B, N, N]; pk the P(k) table, built first when build is non-zero
// (a generator builds it on its first batch and keeps it)
extern "C" int ic_kdensity_planes(void* out, void* pk, int build,
                                  const void* logk, const void* logpk,
                                  int ntab, const void* keys, int kz0, int B,
                                  float logkf, float fac, int N, int fixed,
                                  int paired, void* stream) {
  if (N < 1 || (int64_t)N * N >= (1ll << 31) || B < 0 || B > 65535 ||
      kz0 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (build) {
    const int err = launch_table((float*)pk, logk, logpk, ntab, logkf, N, s);
    if (err != 0) return err;
  }
  if (B == 0) return 0;
  const uint32_t plane = (uint32_t)N * N;
  const dim3 grid((plane + kThreads - 1) / kThreads, B);
  kdensity_planes_kernel<<<grid, kThreads, 0, s>>>(
      (float2*)out, (const float*)pk, (const uint32_t*)keys, kz0, fac, N,
      make_div((uint32_t)N), fixed, paired);
  return (int)cudaGetLastError();
}

// phase, sinv, cosv [2^24] float32, rule [2^24] uint8: see
// phase_check_kernel
extern "C" int ic_phase_check(void* phase, void* sinv, void* cosv,
                              void* rule, void* stream) {
  phase_check_kernel<<<(1 << 24) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (float*)phase, (float*)sinv, (float*)cosv, (uint8_t*)rule);
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes, static shared bytes and resident blocks
// per SM of kernel `which`: 0 the modes (K1, K1s), 1 the planes (K9), 2 the
// P(k) table; out[4]
extern "C" int ic_kernel_info(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)kdensity_kernel
                   : which == 1 ? (const void*)kdensity_planes_kernel
                                : (const void*)pk_table_kernel;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, fn,
                                                            kThreads, 0);
}
