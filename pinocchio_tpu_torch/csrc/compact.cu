// Needed-particle hand-off (K6): the row rank, records and columns (K6a)
// and the FmaxPDF histogram (K6b); and the out-of-core engine's slab row
// scatter (K12).  The (-F, cell) ordering itself stays torch.sort, as the
// JAX package leaves it to XLA's sort.
//
// K6a replaces pinocchio_tpu/fmax.py:_gather_rows (153-161), its chunked
// form (173-174), the segment gathers of displacement_stage_fetch and the
// Fmax gather of _compact_idx (128-141): from the sorted cell indices
// idx[count] it writes, into one packed host-bound buffer, the cell index
// (int32 bits) and F of every row when F is given, then the [count, 3] rows
// of each [3, N^3] displacement stack.  What bounds it on the H100: idx is
// in -F order, so consecutive rows belong to unrelated cells, and a
// permutation pays in scattered accesses on one side.  Gathered in row
// order (the port's first design), each 4-byte value costs a 32-byte
// sector read, with up to 13 planes of 64 MiB (256^3) in flight at once.
// Scattered as 12-byte rows from the cells in order, most row writes leave
// a sector partly written, which the memory then reads back to merge.
// Design: three kernels, every scattered access a whole 32-byte sector.
// needed_rank writes rank[idx[i]] = i into an int32 field set to -1
// (coalesced reads of idx, one scattered 4-byte write a row).  Then, for
// each group of at most kRec packed columns (the cell index and F, then
// whole stacks of three), the record pass walks the cells in order with
// 16-byte loads of rank and of the group's planes, all coalesced and
// marked evict-first, and writes each needed cell's group as one 32-byte
// record at rec[rank]; the column pass reads the records in row order and
// writes the group's columns, coalesced (a stack's three components fill
// whole sectors together).  A quad of cells none of which is needed reads
// nothing past its ranks.  The rank is built once per hand-off and serves
// every displacement set (RECOMPUTE_DISPLACEMENTS) and the out-of-core
// engine's K12.  The output is byte for byte the row gather's.
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
constexpr int kRec = 8;         // floats of a row record: one 32-byte sector

__global__ void rank_kernel(const int64_t* __restrict__ idx, int64_t count,
                            int* __restrict__ rank) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) rank[__ldg(idx + i)] = (int)i;
}

__device__ __forceinline__ float lane(const float4& a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

// up to kRec columns of the packed buffer: column c of row r comes from
// src[c][cell] (the cell index itself when src[c] is null) and goes to
// dst[c][r * stride[c]]
struct Group {
  const float* src[kRec];
  float* dst[kRec];
  int stride[kRec];
  int ncol;
};

// one thread per quad of cells (16-byte loads; ncell a multiple of 4 and
// every plane 16-byte aligned): each needed cell's group columns as one
// 32-byte record at rec[r]
__global__ void __launch_bounds__(kThreads)
record_quad_kernel(const int* __restrict__ rank, int64_t ncell, Group g,
                   float* __restrict__ rec) {
  const int64_t i = 4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= ncell) return;
  const int4 r4 = __ldcs(reinterpret_cast<const int4*>(rank + i));
  if ((r4.x & r4.y & r4.z & r4.w) < 0) return;    // none of the four needed
  const int r[4] = {r4.x, r4.y, r4.z, r4.w};
  float4 v[kRec];
#pragma unroll
  for (int c = 0; c < kRec; ++c) {
    if (c >= g.ncol)
      v[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    else if (g.src[c] == nullptr)
      v[c] = make_float4(__int_as_float((int)i), __int_as_float((int)i + 1),
                         __int_as_float((int)i + 2),
                         __int_as_float((int)i + 3));
    else
      v[c] = __ldcs(reinterpret_cast<const float4*>(g.src[c] + i));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (r[e] >= 0) {
      float4* out = reinterpret_cast<float4*>(rec + (int64_t)kRec * r[e]);
#pragma unroll
      for (int q = 0; q < kRec / 4; ++q)
        out[q] = make_float4(lane(v[4 * q], e), lane(v[4 * q + 1], e),
                             lane(v[4 * q + 2], e), lane(v[4 * q + 3], e));
    }
}

// one thread per cell (any ncell and alignment)
__global__ void __launch_bounds__(kThreads)
record_cell_kernel(const int* __restrict__ rank, int64_t ncell, Group g,
                   float* __restrict__ rec) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ncell) return;
  const int r = __ldcs(rank + i);
  if (r < 0) return;
  float v[kRec];
#pragma unroll
  for (int c = 0; c < kRec; ++c)
    v[c] = c >= g.ncol ? 0.0f
           : g.src[c] == nullptr ? __int_as_float((int)i)
                                 : __ldcs(g.src[c] + i);
  float4* out = reinterpret_cast<float4*>(rec + (int64_t)kRec * r);
#pragma unroll
  for (int q = 0; q < kRec / 4; ++q)
    out[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// one thread per row: its record into the group's columns (a stack's three
// components are in one group, so the three stores of a warp fill whole
// sectors)
__global__ void __launch_bounds__(kThreads)
column_kernel(const float* __restrict__ rec, int64_t count, Group g) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  const float4* p = reinterpret_cast<const float4*>(rec + (int64_t)kRec * r);
  float v[kRec];
#pragma unroll
  for (int q = 0; q < kRec / 4; ++q) {
    const float4 a = __ldcs(p + q);
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int c = 0; c < kRec; ++c)
    if (c < g.ncol) g.dst[c][r * g.stride[c]] = v[c];
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

// rank [ncell] int32: -1, then rank[idx[i]] = i for idx [count] int64
extern "C" int needed_rank(const void* idx, int64_t count, int64_t ncell,
                           void* rank, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(rank, 0xFF, ncell * sizeof(int), s);
  if (err != cudaSuccess || count == 0) return (int)err;
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  rank_kernel<<<(unsigned)blocks, kThreads, 0, s>>>((const int64_t*)idx,
                                                    count, (int*)rank);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// rank [ncell] from needed_rank, count its rows, F [ncell] or null,
// stacks[nstack] (host array of device pointers to [3, ncell]), out the
// packed buffer, rec [count, kRec] float32 scratch.  The columns (the cell
// index and F, then three per stack) go in groups of whole units of at
// most kRec columns; each group is a record pass and a column pass.
extern "C" int scatter_rows(const void* rank_, int64_t ncell, int64_t count,
                            const void* F_, const void* stacks_host,
                            int nstack, void* out, void* rec_,
                            void* stream) {
  if (nstack < 0 || nstack > kMaxStacks) return (int)cudaErrorInvalidValue;
  if (count == 0 || ncell == 0) return 0;
  const int* rank = (const int*)rank_;
  const float* F = (const float*)F_;
  const uint64_t* src = (const uint64_t*)stacks_host;
  float* o = (float*)out;
  float* rec = (float*)rec_;
  cudaStream_t s = (cudaStream_t)stream;
  bool quad = ncell % 4 == 0 && aligned16(rank) && aligned16(F) &&
              aligned16(rec);
  for (int k = 0; k < nstack; ++k) quad = quad && aligned16((void*)src[k]);
  // the units: (cell index, F), then each stack's three components
  const int nunit = (F != nullptr ? 1 : 0) + nstack;
  int unit = 0;
  while (unit < nunit) {
    Group g{};
    for (; unit < nunit; ++unit) {
      const bool cf = F != nullptr && unit == 0;
      const int width = cf ? 2 : 3;
      if (g.ncol + width > kRec) break;
      if (cf) {
        g.src[g.ncol] = nullptr;
        g.dst[g.ncol] = o;
        g.stride[g.ncol++] = 1;
        g.src[g.ncol] = F;
        g.dst[g.ncol] = o + count;
        g.stride[g.ncol++] = 1;
      } else {
        const int k = unit - (F != nullptr ? 1 : 0);
        float* rows = o + (F != nullptr ? 2 * count : 0) + 3 * k * count;
        for (int c = 0; c < 3; ++c) {
          g.src[g.ncol] = (const float*)src[k] + c * ncell;
          g.dst[g.ncol] = rows + c;
          g.stride[g.ncol++] = 3;
        }
      }
    }
    const int64_t units = quad ? ncell / 4 : ncell;
    const unsigned blocks = (unsigned)((units + kThreads - 1) / kThreads);
    if (quad)
      record_quad_kernel<<<blocks, kThreads, 0, s>>>(rank, ncell, g, rec);
    else
      record_cell_kernel<<<blocks, kThreads, 0, s>>>(rank, ncell, g, rec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    column_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads,
                    0, s>>>(rec, count, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// registers, local (spill) bytes, static shared bytes and resident blocks
// per SM of kernel `which`: 0 needed_rank, 1 the record pass by quads, 2 by
// cells, 3 the column pass; out[4]
extern "C" int compact_kernel_info(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)rank_kernel
                   : which == 1 ? (const void*)record_quad_kernel
                   : which == 2 ? (const void*)record_cell_kernel
                                : (const void*)column_kernel;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, fn,
                                                            kThreads, 0);
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
