// The LPT source passes (K4): the pointwise parts of
// pinocchio_tpu/ops/lpt.py:lpt_sources (34), in three forms.
//
// lpt_pointwise: from the R=0 Hessian stack sd [6, n] (xx yy zz xy xz yz)
// the 2LPT source, the first 3LPT source and the seed of the second,
//   src2  = sxx syy + sxx szz + syy szz - sxy^2 - sxz^2 - syz^2
//   src31 = 3 (sxx (syy szz - syz^2) - sxy (sxy szz - sxz syz)
//              + sxz (sxy syz - sxz syy))
//   src32 = 2 (sxx + syy + szz) src2
// into out [3, n]; on the dense stack [6, N, N, N], on each x-slab
// [6, Bx, N, N] of the out-of-core sources and on each shard of a mesh.
// lpt_accumulate: src32 -= 2 w_ij phi2_ij sd_ij over the six pairs (w = 1
// on the diagonal, 2 off it), phi2 and sd [6, n], src32 [n] in place.
// lpt_accumulate_one: one pair of the out-of-core fold on an x-slab,
// src32 -= w2 phi2 sd with w2 = 2 w handed over as a float.
//
// What bounds them on the H100: bytes.  They read each input once and
// write each output once, 36 B a cell (pointwise), 56 B (six pairs) and
// 16 B (one pair), with a few float operations a cell.  A one-pair slab at
// 256^3 is 1 M cells, 16 MB, about 5 us at 3.35 TB/s, so the host's enqueue
// of the launch matters as much as the kernel: the Triton kernels these
// replace spent 25-60 us a call in Triton's launcher.  Design: entry
// points of the ctypes library (the wrappers look them up once and pass
// plain ints and the stream), four cells a thread by 16-byte loads and
// stores, on a grid of every quad.  The fold's pair loads phi2 and sd
// evict-first (__ldcs); the stacks' forms load plainly: on the H100 a
// grid-stride loop over the SMs' resident blocks and evict-first loads
// each made the dense sources 6-7 % slower than this, and the two
// together 14 % (scripts/torch_kernel_variants.py), where the pair gained
// from evict-first at 512^3.  Where every stream sits at one offset from
// the 16-byte grid (the dense stacks, a slab view whose N^2 is a multiple
// of 4), the cells before the first boundary and after the last whole
// quad (at most 3 and 3) are taken one by one by block 0; where the
// streams sit at different offsets (n not a multiple of 4 puts the
// components of a stack apart) a kernel of one cell a thread takes them
// all.  Each form computes the plain version's expression in its order,
// an operation at a time (-fmad=false: no contraction), so it equals
// ops/lpt.py's plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void sources(float sxx, float syy, float szz,
                                        float sxy, float sxz, float syz,
                                        float& s2, float& s31, float& s32) {
  s2 = sxx * syy + sxx * szz + syy * szz - sxy * sxy - sxz * sxz -
       syz * syz;
  s31 = 3.0f * (sxx * (syy * szz - syz * syz) - sxy * (sxy * szz - sxz * syz) +
                sxz * (sxy * syz - sxz * syy));
  s32 = 2.0f * (sxx + syy + szz) * s2;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// evict-first: a stream read once
__device__ __forceinline__ float4 ld4_once(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// each form is an operation on one cell i or on the quad of cells i..i+3
// (16-byte aligned in every stream)
struct Pointwise {
  const float* __restrict__ sd;
  float* __restrict__ out;
  int64_t n;

  __device__ __forceinline__ void cell(int64_t i) const {
    float a, b, c;
    sources(sd[i], sd[n + i], sd[2 * n + i], sd[3 * n + i], sd[4 * n + i],
            sd[5 * n + i], a, b, c);
    out[i] = a;
    out[n + i] = b;
    out[2 * n + i] = c;
  }

  __device__ __forceinline__ void quad(int64_t i) const {
    const float4 xx = ld4(sd + i), yy = ld4(sd + n + i),
                 zz = ld4(sd + 2 * n + i), xy = ld4(sd + 3 * n + i),
                 xz = ld4(sd + 4 * n + i), yz = ld4(sd + 5 * n + i);
    float4 a, b, c;
    sources(xx.x, yy.x, zz.x, xy.x, xz.x, yz.x, a.x, b.x, c.x);
    sources(xx.y, yy.y, zz.y, xy.y, xz.y, yz.y, a.y, b.y, c.y);
    sources(xx.z, yy.z, zz.z, xy.z, xz.z, yz.z, a.z, b.z, c.z);
    sources(xx.w, yy.w, zz.w, xy.w, xz.w, yz.w, a.w, b.w, c.w);
    st4(out + i, a);
    st4(out + n + i, b);
    st4(out + 2 * n + i, c);
  }
};

// acc - w2 phi2 sd, as the plain version's (w2 * phi2) * sd
__device__ __forceinline__ float fold(float acc, float w2, float p, float s) {
  return acc - w2 * p * s;
}

__device__ __forceinline__ float4 fold4(float4 acc, float w2, float4 p,
                                        float4 s) {
  return make_float4(fold(acc.x, w2, p.x, s.x), fold(acc.y, w2, p.y, s.y),
                     fold(acc.z, w2, p.z, s.z), fold(acc.w, w2, p.w, s.w));
}

// the six pairs in ider order, 2 w = 2, 2, 2, 4, 4, 4
struct Accumulate {
  const float* __restrict__ phi2;
  const float* __restrict__ sd;
  float* __restrict__ src32;
  int64_t n;

  __device__ __forceinline__ void cell(int64_t i) const {
    float acc = src32[i];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      acc = fold(acc, k < 3 ? 2.0f : 4.0f, phi2[k * n + i], sd[k * n + i]);
    src32[i] = acc;
  }

  __device__ __forceinline__ void quad(int64_t i) const {
    float4 p[6], s[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      p[k] = ld4(phi2 + k * n + i);
      s[k] = ld4(sd + k * n + i);
    }
    float4 acc = *reinterpret_cast<const float4*>(src32 + i);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      acc = fold4(acc, k < 3 ? 2.0f : 4.0f, p[k], s[k]);
    st4(src32 + i, acc);
  }
};

// one pair of the out-of-core fold
struct AccumulateOne {
  const float* __restrict__ phi2;
  const float* __restrict__ sd;
  float* __restrict__ src32;
  float w2;

  __device__ __forceinline__ void cell(int64_t i) const {
    src32[i] = fold(src32[i], w2, __ldcs(phi2 + i), __ldcs(sd + i));
  }

  __device__ __forceinline__ void quad(int64_t i) const {
    const float4 p = ld4_once(phi2 + i), s = ld4_once(sd + i);
    const float4 acc = *reinterpret_cast<const float4*>(src32 + i);
    st4(src32 + i, fold4(acc, w2, p, s));
  }
};

// n cells: head cells before the streams' first 16-byte boundary, nquad
// quads from there, then the tail (fewer than 4 cells); block 0 takes the
// head and the tail, every thread a quad
template <class Op>
__global__ void __launch_bounds__(kThreads)
quad_kernel(Op op, int64_t n, int head, int64_t nquad) {
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const int64_t tail0 = head + 4 * nquad;
    if (t < head) op.cell(t);
    else if (t >= 4 && tail0 + (t - 4) < n) op.cell(tail0 + (t - 4));
  }
  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (q < nquad) op.quad(head + 4 * q);
}

// one cell a thread (the streams at different offsets from the 16-byte
// grid)
template <class Op>
__global__ void __launch_bounds__(kThreads) cell_kernel(Op op, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) op.cell(i);
}

// launch op over n cells of the streams ptrs[0..nptr): the quad kernel
// where every stream sits at one offset from the 16-byte grid, else the
// cell kernel
template <class Op>
int launch(const Op& op, int64_t n, const void* const* ptrs, int nptr,
           void* stream) {
  if (n == 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t off = (uintptr_t)ptrs[0] & 15;
  bool one = true;
  for (int k = 0; k < nptr; ++k) {
    if ((uintptr_t)ptrs[k] & 3) return (int)cudaErrorMisalignedAddress;
    one = one && ((uintptr_t)ptrs[k] & 15) == off;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (one) {
    const int head = (int)std::min<int64_t>(((16 - off) & 15) / 4, n);
    const int64_t nquad = (n - head) / 4;
    const int64_t blocks =
        std::max<int64_t>(1, (nquad + kThreads - 1) / kThreads);
    quad_kernel<Op><<<(unsigned)blocks, kThreads, 0, s>>>(op, n, head,
                                                         nquad);
  } else {
    cell_kernel<Op><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      s>>>(op, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sd [6, n] float32 (component k at sd + k n), out [3, n]: src2, src31 and
// the src32 seed
extern "C" int lpt_pointwise(const void* sd, void* out, int64_t n,
                             void* stream) {
  const float* s = (const float*)sd;
  float* o = (float*)out;
  const void* ptrs[] = {s,         s + n,     s + 2 * n, s + 3 * n,
                        s + 4 * n, s + 5 * n, o,         o + n,
                        o + 2 * n};
  return launch(Pointwise{s, o, n}, n, ptrs, 9, stream);
}

// phi2, sd [6, n] float32, src32 [n] updated in place: the six pairs
extern "C" int lpt_accumulate(const void* phi2, const void* sd, void* src32,
                              int64_t n, void* stream) {
  const float* p = (const float*)phi2;
  const float* s = (const float*)sd;
  const void* ptrs[13];
  for (int k = 0; k < 6; ++k) {
    ptrs[k] = p + k * n;
    ptrs[6 + k] = s + k * n;
  }
  ptrs[12] = src32;
  return launch(Accumulate{p, s, (float*)src32, n}, n, ptrs, 13, stream);
}

// phi2, sd, src32 [n] float32 (src32 updated in place), w2 = 2 w: one pair
extern "C" int lpt_accumulate_one(const void* phi2, const void* sd,
                                  void* src32, int64_t n, float w2,
                                  void* stream) {
  const void* ptrs[] = {phi2, sd, src32};
  return launch(AccumulateOne{(const float*)phi2, (const float*)sd,
                              (float*)src32, w2},
                n, ptrs, 3, stream);
}

// which: 0 the pointwise quad kernel, 1 the six-pair one, 2 the one-pair
// one; out[4] (host): registers, local bytes, shared bytes, resident
// blocks a SM
extern "C" int lpt_kernel_info(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)quad_kernel<Pointwise>
                   : which == 1 ? (const void*)quad_kernel<Accumulate>
                                : (const void*)quad_kernel<AccumulateOne>;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, fn,
                                                            kThreads, 0);
}
