// Needed-particle hand-off (K6): the row gather (K6a) and the FmaxPDF
// histogram (K6b); and the out-of-core engine's slab row scatter (K12).  The (-F, cell) ordering itself stays torch.sort, as the
// JAX package leaves it to XLA's sort.
//
// gather_rows replaces pinocchio_tpu/fmax.py:_gather_rows (152-161), its
// chunked form (172-174), the segment gathers of displacement_stage_fetch
// (598-612) and the Fmax gather of _compact_idx (127-141): from the sorted
// cell indices idx[count] it writes, into one packed host-bound buffer, the
// cell index (int32 bits) and F of every row when F is given, then the
// [count, 3] rows of each [3, N^3] displacement stack.  What bounds it on the
// H100: the scattered reads.  idx is in -F order, so consecutive rows read
// unrelated cells, and each 4-byte value costs a 32-byte sector; the writes
// are contiguous.  Design: one thread per row reads its index once and
// copies every stack's three components; the stack pointers are a kernel
// argument, so one launch serves all stacks of a displacement set.
//
// vrows_slab (K12) replaces pinocchio_tpu/fmax_ooc.py:OocEngine.vrows_slab
// (934-948): the needed rows of one x-slab of a displacement field.  rank[i]
// is the slab cell's position in the sweep's (-F, cell) order, or -1 when
// the cell is not needed; the kernel writes the cell's three components
// straight to that row of the field's [count, 3] rows buffer.  What bounds
// it: the slab's bytes (4 B of rank and 12 B of components read per cell,
// coalesced), then the scattered 12-byte row writes of the needed cells.
// Design: one thread per slab cell.
//
// pdf_hist replaces fmax.py:_pdf_bincount (110-112): counts of
// clamp(int(F * 10), 0, 209) over the grid.  What bounds it: atomic
// contention, since most cells fall in bin 0 (F = -10 or 0).  Design: per
// block bins in shared memory, with the lanes of a warp that share a bin
// adding once (__match_any_sync), then one global atomic add per bin and
// block.  Both results are exact: copies and integer counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStacks = 8;
constexpr int kBins = 210;

struct Stacks {
  const float* p[kMaxStacks];
};

__global__ void gather_kernel(const int64_t* __restrict__ idx, int64_t count,
                              const float* __restrict__ F, Stacks stacks,
                              int nstack, int64_t ncell,
                              float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int64_t j = idx[i];
  float* rows = out;
  if (F != nullptr) {
    out[i] = __int_as_float((int)j);
    out[count + i] = __ldg(F + j);
    rows = out + 2 * count;
  }
  for (int k = 0; k < nstack; ++k) {
    const float* v = stacks.p[k];
    float* r = rows + (int64_t)k * 3 * count + 3 * i;
    r[0] = __ldg(v + j);
    r[1] = __ldg(v + ncell + j);
    r[2] = __ldg(v + 2 * ncell + j);
  }
}

__global__ void vrows_kernel(const int* __restrict__ rank,
                             const float* __restrict__ comps, int64_t n,
                             float* __restrict__ rows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = __ldg(rank + i);
  if (r < 0) return;
  float* row = rows + 3 * (int64_t)r;
  row[0] = __ldg(comps + i);
  row[1] = __ldg(comps + n + i);
  row[2] = __ldg(comps + 2 * n + i);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ F, int64_t n,
            unsigned long long* __restrict__ counts) {
  __shared__ unsigned int bins[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // the block-uniform loop keeps every lane of a warp in each iteration,
  // so the match below always runs over the full warp
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int b = -1;
    if (i < n) {
      // clamp, then truncate toward zero; NaN gives bin 0
      b = (int)fminf(fmaxf(__ldg(F + i) * 10.0f, 0.0f), (float)(kBins - 1));
    }
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && (threadIdx.x & 31) == __ffs(same) - 1)
      atomicAdd(&bins[b], (unsigned)__popc(same));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    if (bins[b]) atomicAdd(counts + b, (unsigned long long)bins[b]);
}

}  // namespace

extern "C" int gather_rows(const void* idx, int64_t count, const void* F,
                           const void* stacks_host, int nstack, int64_t ncell,
                           void* out, void* stream) {
  if (nstack < 0 || nstack > kMaxStacks) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  Stacks stacks{};
  const uint64_t* src = (const uint64_t*)stacks_host;
  for (int k = 0; k < nstack; ++k) stacks.p[k] = (const float*)src[k];
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)idx, count, (const float*)F, stacks, nstack, ncell,
      (float*)out);
  return (int)cudaGetLastError();
}

// rank [n] int32, comps [3, n] float32 of one slab, rows [count, 3]
extern "C" int vrows_slab(const void* rank, const void* comps, int64_t n,
                          void* rows, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  vrows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rank, (const float*)comps, n, (float*)rows);
  return (int)cudaGetLastError();
}

// counts: [210] int64, zeroed by the caller
extern "C" int pdf_hist(const void* F, int64_t n, void* counts,
                        void* stream) {
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  hist_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)F, n, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

// Page-locked host memory for the out-of-core engine's device-to-host
// copies of the products (kernels.pinned_empty): PyTorch's pinned allocator
// rounds each buffer up to a power of two and keeps it cached after use.
// Returns null when the allocation fails.
extern "C" void* host_alloc(size_t nbytes) {
  void* p = nullptr;
  if (cudaHostAlloc(&p, nbytes, cudaHostAllocDefault) != cudaSuccess)
    return nullptr;
  return p;
}

extern "C" int host_free(void* p) { return (int)cudaFreeHost(p); }
