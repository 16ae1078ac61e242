// The out-of-core engine's 16-bit storage: K18 stores complex64 values as
// (re, im) pairs of bfloat16 or float16, K19 widens such pairs back to
// complex64.
//
// K18 (storage_store) replaces the rounding stores of
// pinocchio_tpu/fmax_ooc.py: OocEngine._store_uc (389-398) and
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
// K19 (storage_load) replaces the upcasts of _read_spec (410-418),
// fft2_batch (648-650) and the slab consumers' reads of a 16-bit stack: a
// window of planes back to a kz batch [C, B, N, N] (transposing), or an
// x-slab of a stack or of its gathered pieces to [C, Bx, N, W] (straight).
// The conversion is exact.
//
// What bounds both on the H100: bytes.  They compute nothing beyond the
// conversion, and each complex value is read once and written once: 8 bytes
// read and 4 written (K18), or 4 read and 8 written (K19), over 3.35 TB/s.
// Design: the transposing form moves a TA x TB tile through shared memory,
// read along the source's contiguous axis and written along the
// destination's, so both sides coalesce (a kz batch's rows are 512-byte
// runs of complex64 along (x, y); the stack's are 64-byte runs of 16
// pairs along kz).  The tile is stored raw and converted on the way out.
// The straight form is one thread a value, in order on both sides (one run
// a slice where the rows are whole, as on one device).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 8192;

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

template <int KIND>
struct Store {
  using Src = float2;
  using Dst = uint32_t;
  static __device__ __forceinline__ Dst apply(Src v) {
    return Pair<KIND>::round(v);
  }
};

template <int KIND>
struct Load {
  using Src = uint32_t;
  using Dst = float2;
  static __device__ __forceinline__ Dst apply(Src v) {
    return Pair<KIND>::widen(v);
  }
};

// dst[c dc + a da + b] = cvt(src[c sc + b sa + a]) for a < A, b < B: the
// source runs along a, the destination along b.  Block (x, c) takes tile x
// of the (a, b) plane of slice c.
template <typename Op, int TA, int TB>
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const typename Op::Src* __restrict__ src,
                     typename Op::Dst* __restrict__ dst, int64_t A, int64_t B,
                     int64_t sc, int64_t sa, int64_t dc, int64_t da,
                     int64_t tiles_a) {
  __shared__ typename Op::Src tile[TB][TA + 1];
  const int64_t c = blockIdx.y;
  const int64_t a0 = (blockIdx.x % tiles_a) * TA;
  const int64_t b0 = (blockIdx.x / tiles_a) * TB;
  const typename Op::Src* s = src + c * sc;
  typename Op::Dst* d = dst + c * dc;
#pragma unroll
  for (int i = threadIdx.x; i < TA * TB; i += kThreads) {
    const int ia = i % TA, ib = i / TA;  // a fastest: the source's order
    const int64_t a = a0 + ia, b = b0 + ib;
    if (a < A && b < B) tile[ib][ia] = s[b * sa + a];
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < TA * TB; i += kThreads) {
    const int ib = i % TB, ia = i / TB;  // b fastest: the destination's
    const int64_t a = a0 + ia, b = b0 + ib;
    if (a < A && b < B) d[a * da + b] = Op::apply(tile[ib][ia]);
  }
}

// dst[c dc + a da + b] = cvt(src[c sc + a sa + b]) for a < A, b < B, with
// A * B < 2^31 (checked by the caller); blocks stride over the slice c.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const typename Op::Src* __restrict__ src,
                typename Op::Dst* __restrict__ dst, uint32_t A, uint32_t B,
                int64_t sc, int64_t sa, int64_t dc, int64_t da) {
  const int64_t c = blockIdx.y;
  const uint32_t n = A * B;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const uint32_t a = i / B, b = i - a * B;
    dst[c * dc + a * da + b] = Op::apply(src[c * sc + a * sa + b]);
  }
}

// dst[c dc + i] = cvt(src[c sc + i]) for i < n < 2^31: the straight form
// where both sides' rows are whole (sa = da = B), so a slice is one run
template <typename Op>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const typename Op::Src* __restrict__ src,
                typename Op::Dst* __restrict__ dst, uint32_t n, int64_t sc,
                int64_t dc) {
  const typename Op::Src* s = src + blockIdx.y * sc;
  typename Op::Dst* d = dst + blockIdx.y * dc;
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    d[i] = Op::apply(s[i]);
}

template <typename Op, int TA, int TB>
int launch(const void* src, void* dst, int transpose, int64_t C, int64_t A,
           int64_t B, int64_t sc, int64_t sa, int64_t dc, int64_t da,
           cudaStream_t stream) {
  if (C <= 0 || A <= 0 || B <= 0) return 0;
  if (C > 65535) return (int)cudaErrorInvalidConfiguration;
  const auto* s = (const typename Op::Src*)src;
  auto* d = (typename Op::Dst*)dst;
  if (transpose) {
    const int64_t tiles_a = (A + TA - 1) / TA;
    const int64_t tiles = tiles_a * ((B + TB - 1) / TB);
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    transpose_kernel<Op, TA, TB>
        <<<dim3((unsigned)tiles, (unsigned)C), kThreads, 0, stream>>>(
            s, d, A, B, sc, sa, dc, da, tiles_a);
  } else {
    if (A * B >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    int64_t blocks = (A * B + kThreads - 1) / kThreads;
    if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
    const dim3 grid((unsigned)blocks, (unsigned)C);
    if (sa == B && da == B)
      flat_kernel<Op><<<grid, kThreads, 0, stream>>>(s, d, (uint32_t)(A * B),
                                                     sc, dc);
    else
      rows_kernel<Op><<<grid, kThreads, 0, stream>>>(
          s, d, (uint32_t)A, (uint32_t)B, sc, sa, dc, da);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K18.  src complex64, dst (re, im) pairs of kind 0 (bfloat16) or 1
// (float16); offsets and strides in complex values.  transpose 1: the
// source runs along a (a kz batch's (x, y) cells), tiles of 64 cells by 16
// planes; transpose 0: both run along b.
extern "C" int storage_store(const void* src, void* dst, int kind,
                             int transpose, int64_t C, int64_t A, int64_t B,
                             int64_t sc, int64_t sa, int64_t dc, int64_t da,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return launch<Store<0>, 64, 16>(src, dst, transpose, C, A, B, sc, sa, dc,
                                    da, s);
  if (kind == 1)
    return launch<Store<1>, 64, 16>(src, dst, transpose, C, A, B, sc, sa, dc,
                                    da, s);
  return (int)cudaErrorInvalidValue;
}

// K19.  src pairs of kind 0 or 1, dst complex64; as K18, with the tile 16
// planes by 64 cells when transposing (the source runs along kz).
extern "C" int storage_load(const void* src, void* dst, int kind,
                            int transpose, int64_t C, int64_t A, int64_t B,
                            int64_t sc, int64_t sa, int64_t dc, int64_t da,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return launch<Load<0>, 16, 64>(src, dst, transpose, C, A, B, sc, sa, dc,
                                   da, s);
  if (kind == 1)
    return launch<Load<1>, 16, 64>(src, dst, transpose, C, A, B, sc, sa, dc,
                                   da, s);
  return (int)cudaErrorInvalidValue;
}
