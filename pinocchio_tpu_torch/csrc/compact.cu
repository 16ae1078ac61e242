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
// pdf_hist (K6b) replaces fmax.py:_pdf_bincount (110-112): counts of
// clamp(int(F * 10), 0, 209) over the grid.  What bounds it: the bytes of F
// (4 B a cell, read once), and most cells fall in a few bins (F = -10 and 0
// in bin 0, the rest between bins 0 and 50), so a shared counter per bin
// and block serializes the lanes that meet on it.  Design: 16-byte loads
// marked evict-first, two sets of four in flight per thread (the next set
// is loaded while the current one is counted), and a private 16-bit counter
// per lane and bin in shared memory, laid out [warp][bin][lane] so that the
// 32 lanes of a warp always touch 32 banks: an increment is a plain load,
// add and store, with no atomic and no conflict whatever the data.  A
// thread counts at most 4 * kHistMaxQuads cells, so no counter wraps (the
// grid grows past the resident blocks where n needs it).  Then each warp
// sums its lanes per bin into the block's totals, and each block adds its
// non-zero totals to the int64 counts with one global atomic per bin.  The
// cells before the first 16-byte boundary of F and after the last whole
// quad (an unaligned view, n % 4 != 0) are counted one by one by block 0.
// The counts are zeroed in the same call.  Both results are exact: copies
// and integer counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStacks = 8;
constexpr int kBins = 210;
constexpr int kRec = 8;         // floats of a row record: one 32-byte sector
constexpr int kMaxDevices = 64;
// K6b: 8 warps a block, each with a 16-bit counter per lane and bin
// (107,520 B of shared memory, two blocks per SM), four 16-byte loads of a
// thread in flight per set, and at most kHistMaxQuads quads a thread
constexpr int kHistThreads = 256;
constexpr int kHistLoads = 4;
constexpr size_t kHistSmem =
    (size_t)(kHistThreads / 32) * kBins * 32 * sizeof(uint16_t);
constexpr int64_t kHistMaxQuads = 16383;

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

// the bin of one F: clamp, then truncate toward zero; NaN gives bin 0
__device__ __forceinline__ int pdf_bin(float x) {
  return (int)fminf(fmaxf(x * 10.0f, 0.0f), (float)(kBins - 1));
}

// one lane's counter of bin b is lanes[b * 32]
__device__ __forceinline__ void hist_count(uint16_t* lanes, const float4& v) {
  lanes[pdf_bin(v.x) * 32] += 1;
  lanes[pdf_bin(v.y) * 32] += 1;
  lanes[pdf_bin(v.z) * 32] += 1;
  lanes[pdf_bin(v.w) * 32] += 1;
}

// F [n]: head cells before the first 16-byte boundary, then nquad quads,
// then the tail (fewer than 4 cells); counts zeroed before the launch
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const float* __restrict__ F, int64_t n, int head, int64_t nquad,
            unsigned long long* __restrict__ counts) {
  extern __shared__ uint4 hist_smem[];
  __shared__ unsigned int total[kBins];
  uint16_t* hist = reinterpret_cast<uint16_t*>(hist_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < (int)(kHistSmem / sizeof(uint4));
       i += kHistThreads)
    hist_smem[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int b = threadIdx.x; b < kBins; b += kHistThreads) total[b] = 0;
  __syncthreads();

  // the cells outside the quads, one global atomic each
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    const int64_t tail0 = head + 4 * nquad;
    int64_t i = -1;
    if (t < head) i = t;
    else if (t >= 4 && tail0 + (t - 4) < n) i = tail0 + (t - 4);
    if (i >= 0) atomicAdd(counts + pdf_bin(__ldg(F + i)), 1ull);
  }

  uint16_t* lanes = hist + warp * (kBins * 32) + lane;
  const float4* q4 = reinterpret_cast<const float4*>(F + head);
  const int64_t stride = (int64_t)gridDim.x * kHistThreads;
  const int64_t step = kHistLoads * stride;
  int64_t q = (int64_t)blockIdx.x * kHistThreads + threadIdx.x;
  float4 cur[kHistLoads];
#pragma unroll
  for (int j = 0; j < kHistLoads; ++j)
    if (q + j * stride < nquad) cur[j] = __ldcs(q4 + q + j * stride);
  for (; q < nquad; q += step) {
    float4 next[kHistLoads];
#pragma unroll
    for (int j = 0; j < kHistLoads; ++j)
      if (q + step + j * stride < nquad)
        next[j] = __ldcs(q4 + q + step + j * stride);
#pragma unroll
    for (int j = 0; j < kHistLoads; ++j)
      if (q + j * stride < nquad) hist_count(lanes, cur[j]);
#pragma unroll
    for (int j = 0; j < kHistLoads; ++j) cur[j] = next[j];
  }
  __syncthreads();

  // warp w sums its lanes' counters of bins lane, lane + 32, ...: a bin's
  // 32 counters are 16 words, read from word (i + lane / 2) % 16 so that
  // the 32 lanes read 32 banks
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(hist + warp * (kBins * 32));
  for (int b = lane; b < kBins; b += 32) {
    unsigned int sum = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t w = words[b * 16 + ((i + (lane >> 1)) & 15)];
      sum += (w & 0xffffu) + (w >> 16);
    }
    if (sum) atomicAdd(&total[b], sum);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kHistThreads)
    if (total[b]) atomicAdd(counts + b, (unsigned long long)total[b]);
}

// resident hist_kernel blocks per SM and the SMs of device dev, queried
// once per device (0 when the query fails)
int hist_blocks(int dev, int* sms) {
  static int blocks[kMaxDevices] = {}, count[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (blocks[dev] == 0) {
    if (cudaFuncSetAttribute(hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kHistSmem) != cudaSuccess ||
        cudaFuncSetAttribute(hist_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 0;
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, hist_kernel, kHistThreads, kHistSmem) != cudaSuccess)
      return 0;
    blocks[dev] = b;
  }
  *sms = count[dev];
  return blocks[dev];
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
// cells, 3 the column pass, 4 K6b's histogram (its shared bytes: static
// and dynamic); out[4]
extern "C" int compact_kernel_info(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)rank_kernel
                   : which == 1 ? (const void*)record_quad_kernel
                   : which == 2 ? (const void*)record_cell_kernel
                   : which == 3 ? (const void*)column_kernel
                                : (const void*)hist_kernel;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  if (which == 4) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    out[2] += (int)kHistSmem;
    out[3] = hist_blocks(dev, &sms);
    return out[3] > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
  }
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

// counts: [210] int64, written (zeroed, then counted)
extern "C" int pdf_hist(const void* F, int64_t n, void* counts,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, kBins * sizeof(int64_t), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const uintptr_t p = (uintptr_t)F;
  if (p & 3) return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const int per_sm = hist_blocks(dev, &sms);
  if (per_sm <= 0 || sms <= 0) return (int)cudaErrorInvalidConfiguration;
  const int head = (int)std::min<int64_t>(((16 - (p & 15)) & 15) / 4, n);
  const int64_t nquad = (n - head) / 4;
  // every resident block, at most one a thread's quad, and enough that no
  // thread counts more than kHistMaxQuads quads
  const int64_t need = (nquad + kHistThreads * kHistMaxQuads - 1) /
                       (kHistThreads * kHistMaxQuads);
  const int64_t most = std::max<int64_t>(
      1, (nquad + kHistThreads - 1) / kHistThreads);
  const int64_t grid =
      std::max<int64_t>(need, std::min<int64_t>((int64_t)per_sm * sms, most));
  hist_kernel<<<(unsigned)grid, kHistThreads, kHistSmem, s>>>(
      (const float*)F, n, head, nquad, (unsigned long long*)counts);
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
