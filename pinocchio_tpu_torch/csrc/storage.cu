// The out-of-core engine's 16-bit storage: K18 stores complex64 values as
// (re, im) pairs of bfloat16 or float16, K19 widens such pairs back to
// complex64.
//
// K18 (storage_store_kz, storage_store_rows) replaces the rounding stores
// of pinocchio_tpu/fmax_ooc.py: OocEngine._store_uc (389-398) and
// build_pair_batch (495-500), which write an ifft2 batch [B, N, N] into the
// half-transform stacks transposed to kz-minor and cast to the store dtype,
// and the spectrum stores of rfftz_batch (639), fft2_batch (652) and
// fft2_pair_batch (664).  In the port a stack is [ncomp, N, N, nkz, 2] and a
// spectrum [N, N, nkz, 2] (x, y, kz, then re and im); K18 writes either a
// kz batch [C, B, N, N] into the planes k..k+B-1 (transposing) or rows of
// a z-rfft slab [Bx, N, Nh] into an x window (straight).  Rounding is to
// nearest even (__float2bfloat16_rn, __float2half_rn), as XLA's
// convert and PyTorch's .to(dtype) round; float16 overflows to inf as
// theirs do.
//
// K19 (storage_load_kz, storage_load_rows) replaces the upcasts of
// _read_spec (410-418), fft2_batch (648-650) and the slab consumers' reads
// of a 16-bit stack: a window of planes back to a kz batch [C, B, N, N]
// (transposing), or an x-slab of a stack or of its gathered pieces to
// [C, Bx, N, W] (straight).  The conversion is exact.
//
// What bounds both on the H100: bytes.  They compute nothing beyond the
// conversion, and each complex value is read once and written once: 8 bytes
// read and 4 written (K18), or 4 read and 8 written (K19), over 3.35 TB/s.
//
// The straight forms are one run on each side (or rows of W words out of
// rows of Ws values): a thread converts two values, with one 16-byte load
// of complex64 and one 8-byte store of pairs (K18), or one 8-byte load and
// one 16-byte store (K19), so that each of a warp's loads and stores
// covers one contiguous run (four values a thread, two 16-byte accesses
// on the complex side, leave each access half of every sector it touches,
// and measured slower), on a grid of one pair a thread (a grid-stride grid
// of the SMs' resident blocks measured slower too), with 32-bit indices
// within a slice; only a word before the first 8-byte boundary (a window's
// start) and a last odd word go alone.
//
// The transposing forms cannot be vectorised on the stack's side: a
// stack's row is W = N/2 + 1 pairs (odd), so each (x, y) cell's run of a
// batch's 16 planes is 64 bytes at a stride of 4 W bytes and starts at any
// 4-byte offset.  That layout bounds them more than the bytes do: such runs
// stored plainly, a word a thread, move about an eighth of the card's rate
// (storage_runs_probe, chip_smoke.py), since every run's first and last
// 32-byte sectors are written in part and L2 must read them from device
// memory to write them back.  A block moves a tile of 128 cells by up to
// 16 planes through shared memory: on the kz batch's side each thread
// moves two cells of a plane with one 16-byte access, converting before
// the tile (K18) or after it (K19), so the tile holds the 4-byte pairs; on
// the stack's side K19 reads a word a lane, and K18 first asks L2 for the
// partly covered sectors (touch_runs), then stores with 8 lanes a run, 8
// bytes each where its words are 8-byte aligned (every other cell: its
// first and last words go alone), or a word a lane for fewer than 16
// planes.  The tile's rows are 130 words (2 mod 32 banks), so neither
// side's lanes share a bank.
// The last batch of a kz schedule has one plane (Nh = 8 x 16 + 1 at
// 256^3): it takes no tile, a value a thread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 128;       // cells of a transposing tile
constexpr int kPlanes = 16;       // planes of a transposing tile, at most
constexpr int kRow = kCells + 2;  // a tile row in words: 2 mod 32 banks

// kind 0: bfloat16 pairs, kind 1: float16 pairs, each pair one 32-bit word
// (re in the low half: the [..., 2] layout of a little-endian tensor)
template <int KIND>
struct Pair;

template <>
struct Pair<0> {
  static __device__ __forceinline__ uint32_t round(float2 v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16);
  }
  // a bfloat16 is the high half of a float32
  static __device__ __forceinline__ float2 widen(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
};

template <>
struct Pair<1> {
  static __device__ __forceinline__ uint32_t round(float2 v) {
    return (uint32_t)__half_as_ushort(__float2half_rn(v.x)) |
           ((uint32_t)__half_as_ushort(__float2half_rn(v.y)) << 16);
  }
  static __device__ __forceinline__ float2 widen(uint32_t w) {
    return make_float2(
        __half2float(__ushort_as_half((unsigned short)(w & 0xffffu))),
        __half2float(__ushort_as_half((unsigned short)(w >> 16))));
  }
};

__host__ __device__ __forceinline__ bool aligned(const void* p, unsigned a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// Store word(m, b) to d[m W + b] for the cells m < cells and planes b < B
// of a tile.  A full batch: 8 lanes a run, lane l storing words 2l, 2l + 1
// with one 8-byte store, or, where the run starts on an odd word, 2l - 1,
// 2l, lane 0 then storing words 0 and 15 alone; else 16 lanes a run, a word
// each.
template <typename Word>
__device__ __forceinline__ void put_runs(uint32_t* d, uint32_t W, uint32_t B,
                                         uint32_t cells, Word word) {
  if (B == kPlanes) {
    const uint32_t l = threadIdx.x & 7;
    const uint32_t odd0 = (uint32_t)(reinterpret_cast<uintptr_t>(d) >> 2);
#pragma unroll 4
    for (uint32_t m = threadIdx.x >> 3; m < cells; m += kThreads / 8) {
      uint32_t* r = d + m * W;
      if (((odd0 + m * W) & 1) == 0) {
        *reinterpret_cast<uint2*>(r + 2 * l) =
            make_uint2(word(m, 2 * l), word(m, 2 * l + 1));
      } else if (l == 0) {
        r[0] = word(m, 0);
        r[kPlanes - 1] = word(m, kPlanes - 1);
      } else {
        *reinterpret_cast<uint2*>(r + 2 * l - 1) =
            make_uint2(word(m, 2 * l - 1), word(m, 2 * l));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCells * kPlanes / kThreads; ++j) {
      const uint32_t m = (threadIdx.x + j * kThreads) / kPlanes;
      const uint32_t b = threadIdx.x % kPlanes;
      if (b < B && m < cells) d[m * W + b] = word(m, b);
    }
  }
}

// put(m, b, s[m W + b]) for the cells m < cells and planes b < B of a
// tile, 16 lanes a run, a word each (8-byte loads measured no faster).
template <typename Put>
__device__ __forceinline__ void get_runs(const uint32_t* __restrict__ s,
                                         uint32_t W, uint32_t B,
                                         uint32_t cells, Put put) {
#pragma unroll
  for (int j = 0; j < kCells * kPlanes / kThreads; ++j) {
    const uint32_t m = (threadIdx.x + j * kThreads) / kPlanes;
    const uint32_t b = threadIdx.x % kPlanes;
    if (b < B && m < cells) put(m, b, s[m * W + b]);
  }
}

// Ask L2 for the 32-byte sectors that a tile's runs d[m W .. m W + B - 1]
// only partly cover (a run's first and last, unless it starts or ends on a
// sector's edge), one a thread: stores into a sector L2 holds whole leave
// it whole, where a partly written sector costs a read-modify-write of
// device memory when L2 evicts it.
__device__ __forceinline__ void touch_runs(const uint32_t* d, uint32_t W,
                                           uint32_t B, uint32_t cells) {
  for (uint32_t i = threadIdx.x; i < 2 * cells; i += kThreads) {
    const uint32_t* p = d + (i >> 1) * W + ((i & 1) ? B - 1 : 0);
    const uint32_t word = (uint32_t)(reinterpret_cast<uintptr_t>(p) >> 2);
    if ((i & 1) ? ((word + 1) & 7) != 0 : (word & 7) != 0)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
  }
}

// K18, transposing: dst[c dc + m W + b] = round(src[c sc + b M + m]) for
// cells m < M and planes b < B <= 16, dst at plane k.  Block (x, c) takes
// the cells 128 x ... 128 x + 127; thread t rounds the cells 2 (t % 64)
// and + 1 of the planes t / 64 + 4 j from one 16-byte load (VEC: M even and
// src 16-byte aligned) into the tile; then the block fetches the sectors
// its runs partly cover (touch_runs) and the runs go out (put_runs).
template <int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
    store_kz_kernel(const float2* __restrict__ src, uint32_t* __restrict__ dst,
                    uint32_t M, uint32_t B, uint32_t W, int64_t sc,
                    int64_t dc) {
  __shared__ __align__(16) uint32_t tile[kPlanes][kRow];
  const uint32_t m0 = blockIdx.x * kCells;
  const uint32_t cells = min((uint32_t)kCells, M - m0);
  const float2* s = src + blockIdx.y * sc + m0;
  uint32_t* d = dst + blockIdx.y * dc + (int64_t)m0 * W;
  const uint32_t m = 2 * (threadIdx.x & 63);
#pragma unroll
  for (int j = 0; j < kPlanes / 4; ++j) {
    const uint32_t b = (threadIdx.x >> 6) + 4 * j;
    if (b < B && m < cells) {
      const float2* p = s + b * M + m;
      float2 v0, v1 = make_float2(0.f, 0.f);
      if (VEC && m + 1 < cells) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        v0 = make_float2(f.x, f.y);
        v1 = make_float2(f.z, f.w);
      } else {
        v0 = p[0];
        if (m + 1 < cells) v1 = p[1];
      }
      *reinterpret_cast<uint2*>(&tile[b][m]) =
          make_uint2(Pair<KIND>::round(v0), Pair<KIND>::round(v1));
    }
  }
  __syncthreads();
  touch_runs(d, W, B, cells);
  put_runs(d, W, B, cells,
           [&](uint32_t mm, uint32_t b) { return tile[b][mm]; });
}

// K19, transposing: dst[c dc + b M + m] = widen(src[c sc + m W + b]), src
// at plane k: the runs into the tile (get_runs), then thread t widens the
// cells 2 (t % 64) and + 1 of the planes t / 64 + 4 j with one 16-byte
// store (VEC: M even and dst 16-byte aligned).
template <int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
    load_kz_kernel(const uint32_t* __restrict__ src, float2* __restrict__ dst,
                   uint32_t M, uint32_t B, uint32_t W, int64_t sc,
                   int64_t dc) {
  __shared__ __align__(16) uint32_t tile[kPlanes][kRow];
  const uint32_t m0 = blockIdx.x * kCells;
  const uint32_t cells = min((uint32_t)kCells, M - m0);
  const uint32_t* s = src + blockIdx.y * sc + (int64_t)m0 * W;
  float2* d = dst + blockIdx.y * dc + m0;
  get_runs(s, W, B, cells, [&](uint32_t mm, uint32_t b, uint32_t w) {
    tile[b][mm] = w;
  });
  __syncthreads();
  const uint32_t m = 2 * (threadIdx.x & 63);
#pragma unroll
  for (int j = 0; j < kPlanes / 4; ++j) {
    const uint32_t b = (threadIdx.x >> 6) + 4 * j;
    if (b < B && m < cells) {
      const uint2 w = *reinterpret_cast<const uint2*>(&tile[b][m]);
      const float2 v0 = Pair<KIND>::widen(w.x), v1 = Pair<KIND>::widen(w.y);
      float2* p = d + b * M + m;
      if (VEC && m + 1 < cells) {
        *reinterpret_cast<float4*>(p) = make_float4(v0.x, v0.y, v1.x, v1.y);
      } else {
        p[0] = v0;
        if (m + 1 < cells) p[1] = v1;
      }
    }
  }
}

// The transposing forms with one plane (B = 1): f = c M + m < n = C M in
// the kz batch's order, a value a thread, no tile.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    store_plane_kernel(const float2* __restrict__ src,
                       uint32_t* __restrict__ dst, uint32_t M, uint32_t n,
                       uint32_t W, int64_t dc) {
  const uint32_t f = blockIdx.x * kThreads + threadIdx.x;
  if (f < n) {
    const uint32_t c = f / M, m = f - c * M;
    dst[c * dc + (int64_t)m * W] = Pair<KIND>::round(src[f]);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    load_plane_kernel(const uint32_t* __restrict__ src,
                      float2* __restrict__ dst, uint32_t M, uint32_t n,
                      uint32_t W, int64_t sc) {
  const uint32_t f = blockIdx.x * kThreads + threadIdx.x;
  if (f < n) {
    const uint32_t c = f / M, m = f - c * M;
    dst[f] = Pair<KIND>::widen(src[c * sc + (int64_t)m * W]);
  }
}

// K18, straight: dst[i] = round(src[(i / W) Ws + i % W]) for i < n, the
// destination's words in order (RUN: W == Ws, one run).  Thread t rounds
// the words i = head + 2 t and i + 1 (head 1 where dst is not 8-byte
// aligned) from one 16-byte load (VEC: src + head 16-byte aligned too;
// else two 8-byte ones) into one 8-byte store, so that a warp's loads and
// its stores each cover one contiguous run; the threads after the pairs
// take the head word and a last odd word.
template <int KIND, bool RUN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    store_rows_kernel(const float2* __restrict__ src,
                      uint32_t* __restrict__ dst, uint32_t n, uint32_t W,
                      uint32_t Ws, uint32_t head) {
  const uint32_t pairs = (n - head) >> 1;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t < pairs) {
    const uint32_t i = head + 2 * t;
    float2 v0, v1;
    if (RUN && VEC) {
      const float4 f = *reinterpret_cast<const float4*>(src + i);
      v0 = make_float2(f.x, f.y);
      v1 = make_float2(f.z, f.w);
    } else if (RUN) {
      v0 = src[i];
      v1 = src[i + 1];
    } else {
      const uint32_t a = i / W, j = i - a * W, s = a * Ws + j;
      v0 = src[s];
      v1 = src[j + 1 == W ? s + Ws - W + 1 : s + 1];
    }
    *reinterpret_cast<uint2*>(dst + i) =
        make_uint2(Pair<KIND>::round(v0), Pair<KIND>::round(v1));
  } else if (t < pairs + head + ((n - head) & 1)) {
    const uint32_t i = t - pairs < head ? 0 : n - 1;
    dst[i] = Pair<KIND>::round(src[RUN ? i : (i / W) * Ws + i % W]);
  }
}

// K19, straight: dst[c n + i] = widen(src[c sc + i]) for i < n, slice c =
// blockIdx.y.  Thread t widens the words i = head + 2 t and i + 1 (head 1
// where the slice's src is not 8-byte aligned) from one 8-byte load into
// one 16-byte store (dst + head 16-byte aligned, which holds for every
// slice or none unless n is odd; else two 8-byte stores), so that a warp's
// loads and its stores each cover one contiguous run; the threads after
// the pairs take the head word and a last odd word.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    load_rows_kernel(const uint32_t* __restrict__ src,
                     float2* __restrict__ dst, uint32_t n, int64_t sc) {
  const uint32_t* s = src + blockIdx.y * sc;
  float2* d = dst + (int64_t)blockIdx.y * n;
  const uint32_t head =
      min(n, (uint32_t)(reinterpret_cast<uintptr_t>(s) >> 2) & 1);
  const uint32_t pairs = (n - head) >> 1;
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t < pairs) {
    const uint32_t i = head + 2 * t;
    const uint2 w = *reinterpret_cast<const uint2*>(s + i);
    const float2 a = Pair<KIND>::widen(w.x), b = Pair<KIND>::widen(w.y);
    if (aligned(d + head, 16)) {
      *reinterpret_cast<float4*>(d + i) = make_float4(a.x, a.y, b.x, b.y);
    } else {
      d[i] = a;
      d[i + 1] = b;
    }
  } else if (t < pairs + head + ((n - head) & 1)) {
    const uint32_t i = t - pairs < head ? 0 : n - 1;
    d[i] = Pair<KIND>::widen(s[i]);
  }
}

// The layout's runs alone (measurement only, no kernel of the engine): the
// words of planes 0..B-1 of cells m < n of a stack d [n, W] (all C slices
// of a kz window as one), i = m B + b a thread in order, nothing else.
// LOAD false: zeros stored, the plainest store of the runs; LOAD true: the
// words read, each stored back only if it equals key (which keeps the
// loads; a buffer of zeros never does).
template <bool LOAD>
__global__ void __launch_bounds__(kThreads)
    plain_runs_kernel(uint32_t* __restrict__ d, int64_t words, uint32_t B,
                      uint32_t W, uint32_t key) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= words) return;
  uint32_t* p = d + (i / B) * W + i % B;
  if (LOAD) {
    const uint32_t w = *p;
    if (w == key) *p = w;
  } else {
    *p = 0u;
  }
}

// K18's transposing form's runs alone: its tile of cells, sector fetch
// (touch_runs) and lanes (put_runs), storing zeros.
__global__ void __launch_bounds__(kThreads)
    store_runs_kernel(uint32_t* __restrict__ dst, uint32_t M, uint32_t B,
                      uint32_t W, int64_t dc) {
  const uint32_t m0 = blockIdx.x * kCells;
  const uint32_t cells = min((uint32_t)kCells, M - m0);
  uint32_t* d = dst + blockIdx.y * dc + (int64_t)m0 * W;
  touch_runs(d, W, B, cells);
  put_runs(d, W, B, cells, [](uint32_t, uint32_t) { return 0u; });
}

// blocks of kThreads threads for one item a thread
unsigned blocks_of(int64_t items) {
  return (unsigned)((items + kThreads - 1) / kThreads);
}

template <int KIND>
int store_kz(const float2* s, uint32_t* d, int64_t C, int64_t M, int64_t B,
             int64_t W, cudaStream_t st) {
  if (B == 1) {
    store_plane_kernel<KIND><<<blocks_of(C * M), kThreads, 0, st>>>(
        s, d, (uint32_t)M, (uint32_t)(C * M), (uint32_t)W, M * W);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((M + kCells - 1) / kCells), (unsigned)C);
  if (M % 2 == 0 && aligned(s, 16))
    store_kz_kernel<KIND, true><<<grid, kThreads, 0, st>>>(
        s, d, (uint32_t)M, (uint32_t)B, (uint32_t)W, B * M, M * W);
  else
    store_kz_kernel<KIND, false><<<grid, kThreads, 0, st>>>(
        s, d, (uint32_t)M, (uint32_t)B, (uint32_t)W, B * M, M * W);
  return (int)cudaGetLastError();
}

template <int KIND>
int load_kz(const uint32_t* s, float2* d, int64_t C, int64_t M, int64_t B,
            int64_t W, cudaStream_t st) {
  if (B == 1) {
    load_plane_kernel<KIND><<<blocks_of(C * M), kThreads, 0, st>>>(
        s, d, (uint32_t)M, (uint32_t)(C * M), (uint32_t)W, M * W);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((M + kCells - 1) / kCells), (unsigned)C);
  if (M % 2 == 0 && aligned(d, 16))
    load_kz_kernel<KIND, true><<<grid, kThreads, 0, st>>>(
        s, d, (uint32_t)M, (uint32_t)B, (uint32_t)W, M * W, B * M);
  else
    load_kz_kernel<KIND, false><<<grid, kThreads, 0, st>>>(
        s, d, (uint32_t)M, (uint32_t)B, (uint32_t)W, M * W, B * M);
  return (int)cudaGetLastError();
}

template <int KIND>
int store_rows(const float2* s, uint32_t* d, int64_t A, int64_t W,
               int64_t Ws, cudaStream_t st) {
  const uint32_t n = (uint32_t)(A * W);
  const uint32_t head =
      std::min(n, (uint32_t)(reinterpret_cast<uintptr_t>(d) >> 2) & 1u);
  const unsigned blocks = blocks_of(n / 2 + 2);
  if (W != Ws)
    store_rows_kernel<KIND, false, false><<<blocks, kThreads, 0, st>>>(
        s, d, n, (uint32_t)W, (uint32_t)Ws, head);
  else if (aligned(s + head, 16))
    store_rows_kernel<KIND, true, true><<<blocks, kThreads, 0, st>>>(
        s, d, n, (uint32_t)W, (uint32_t)Ws, head);
  else
    store_rows_kernel<KIND, true, false><<<blocks, kThreads, 0, st>>>(
        s, d, n, (uint32_t)W, (uint32_t)Ws, head);
  return (int)cudaGetLastError();
}

template <int KIND>
int load_rows(const uint32_t* s, float2* d, int64_t C, int64_t n, int64_t sc,
              cudaStream_t st) {
  load_rows_kernel<KIND><<<dim3(blocks_of(n / 2 + 2), (unsigned)C), kThreads,
                           0, st>>>(s, d, (uint32_t)n, sc);
  return (int)cudaGetLastError();
}

// the limits of the transposing forms: C slices in y, 16 planes a tile, a
// tile's runs (128 W words) and a plane of the kz batch (B M values) in
// 32 bits, and the one-plane form's C M values
int kz_refused(int64_t C, int64_t M, int64_t B, int64_t W, int64_t k) {
  if (C > 65535 || B > kPlanes || k < 0 || k + B > W || W >= (1 << 24) ||
      B * M >= ((int64_t)1 << 31) || C * M >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K18, transposing: the complex64 kz batch src [C, B, M] rounded into the
// planes k..k+B-1 of the stack dst [C, M, W] of (re, im) pairs of kind 0
// (bfloat16) or 1 (float16).
extern "C" int storage_store_kz(const void* src, void* dst, int kind,
                                int64_t C, int64_t M, int64_t B, int64_t W,
                                int64_t k, void* stream) {
  if (C <= 0 || M <= 0 || B <= 0) return 0;
  if (int err = kz_refused(C, M, B, W, k)) return err;
  if (!aligned(src, 8) || !aligned(dst, 4))
    return (int)cudaErrorMisalignedAddress;
  const auto* s = (const float2*)src;
  auto* d = (uint32_t*)dst + k;
  const auto st = (cudaStream_t)stream;
  if (kind == 0) return store_kz<0>(s, d, C, M, B, W, st);
  if (kind == 1) return store_kz<1>(s, d, C, M, B, W, st);
  return (int)cudaErrorInvalidValue;
}

// K18, straight: the columns col0..col0+W-1 of the complex64 rows src
// [A, Ws] rounded into the pairs dst [A, W].
extern "C" int storage_store_rows(const void* src, void* dst, int kind,
                                  int64_t A, int64_t W, int64_t Ws,
                                  int64_t col0, void* stream) {
  if (A <= 0 || W <= 0) return 0;
  if (col0 < 0 || col0 + W > Ws || A * Ws >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (!aligned(src, 8) || !aligned(dst, 4))
    return (int)cudaErrorMisalignedAddress;
  const auto* s = (const float2*)src + col0;
  auto* d = (uint32_t*)dst;
  const auto st = (cudaStream_t)stream;
  if (kind == 0) return store_rows<0>(s, d, A, W, Ws, st);
  if (kind == 1) return store_rows<1>(s, d, A, W, Ws, st);
  return (int)cudaErrorInvalidValue;
}

// K19, transposing: the planes k..k+B-1 of the stack src [C, M, W] of
// pairs widened into the complex64 kz batch dst [C, B, M].
extern "C" int storage_load_kz(const void* src, void* dst, int kind,
                               int64_t C, int64_t M, int64_t B, int64_t W,
                               int64_t k, void* stream) {
  if (C <= 0 || M <= 0 || B <= 0) return 0;
  if (int err = kz_refused(C, M, B, W, k)) return err;
  if (!aligned(src, 4) || !aligned(dst, 8))
    return (int)cudaErrorMisalignedAddress;
  const auto* s = (const uint32_t*)src + k;
  auto* d = (float2*)dst;
  const auto st = (cudaStream_t)stream;
  if (kind == 0) return load_kz<0>(s, d, C, M, B, W, st);
  if (kind == 1) return load_kz<1>(s, d, C, M, B, W, st);
  return (int)cudaErrorInvalidValue;
}

// K19, straight: the pairs src [C, n] (slice c at c sc words) widened into
// the complex64 dst [C, n].
extern "C" int storage_load_rows(const void* src, void* dst, int kind,
                                 int64_t C, int64_t n, int64_t sc,
                                 void* stream) {
  if (C <= 0 || n <= 0) return 0;
  if (C > 65535 || n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (!aligned(src, 4) || !aligned(dst, 8))
    return (int)cudaErrorMisalignedAddress;
  const auto* s = (const uint32_t*)src;
  auto* d = (float2*)dst;
  const auto st = (cudaStream_t)stream;
  if (kind == 0) return load_rows<0>(s, d, C, n, sc, st);
  if (kind == 1) return load_rows<1>(s, d, C, n, sc, st);
  return (int)cudaErrorInvalidValue;
}

// The stack layout's runs alone: the planes k..k+B-1 of a stack buf
// [C, M, W] of pairs stored plainly, a word a thread (load 0, form 0),
// stored as K18's transposing form stores them (load 0, form 1), or read
// plainly (load 1, form 0).
extern "C" int storage_runs_probe(void* buf, int load, int form, int64_t C,
                                  int64_t M, int64_t B, int64_t W, int64_t k,
                                  void* stream) {
  if (C <= 0 || M <= 0 || B <= 0) return 0;
  if (int err = kz_refused(C, M, B, W, k)) return err;
  if (!aligned(buf, 4)) return (int)cudaErrorMisalignedAddress;
  auto* d = (uint32_t*)buf + k;
  const auto st = (cudaStream_t)stream;
  const int64_t words = C * M * B;
  if (load == 0 && form == 0)
    plain_runs_kernel<false><<<blocks_of(words), kThreads, 0, st>>>(
        d, words, (uint32_t)B, (uint32_t)W, 0u);
  else if (load == 0 && form == 1)
    store_runs_kernel<<<dim3((unsigned)((M + kCells - 1) / kCells),
                             (unsigned)C), kThreads, 0, st>>>(
        d, (uint32_t)M, (uint32_t)B, (uint32_t)W, M * W);
  else if (load == 1 && form == 0)
    plain_runs_kernel<true><<<blocks_of(words), kThreads, 0, st>>>(
        d, words, (uint32_t)B, (uint32_t)W, 0x7fc07fc1u);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
