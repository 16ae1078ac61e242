// The cross-host product exchange (K15, K16, K17): on every source shard,
// which hosts need each of its needed rows, and the pack of those rows into
// one segment per destination device.  The route between devices is
// copies (parallel/exchange.py), as the JAX package leaves it to XLA's
// all_to_all.
//
// exchange_count (K15) replaces pinocchio_tpu/parallel/exchange.py's
// count_local (311) with _member (195) and _shard_coords (208): for each
// needed row of a shard (its local cell, in ascending cell order) it tests
// every host's wrapped boxes, or reads the host's turn-1 request map, and
// writes a bitmask of ceil(H/32) words per row and the member count per
// (thread block, host).  A box [x0, x0 + L) mod N holds g when
// ((g - x0) % N + N) % N < L (C's % of a negative is negative), so a box
// with L >= N covers its whole dimension.  What bounds it on the H100: the
// 8-byte cell read and the bitmask write per row, coalesced; the box tests
// are a few integer operations per box.  Design: one thread per row, and
// __syncthreads_count gives each block's count per host.
//
// exchange_pack (K16) replaces pack_local (339): the rank i of a row among
// the shard's members of host h is its block's offset (the exclusive scan
// of K15's counts over blocks, index arithmetic done with torch.cumsum)
// plus its rank within the block (a warp ballot, then the warps' totals in
// shared memory).  The row goes to host h's device devs[i % nd], slot
// i / nd of that destination's segment, so a segment holds its rows in
// ascending cell order, as the JAX package's rank order fills it.  Each
// segment has the hand-off's packed layout (cells as int32 bits, F, then
// 3 floats per row and channel), so the receiver unpacks it as a hand-off
// buffer.  What bounds it: the scattered reads of each row's payload from
// the hand-off buffer (it is in the sweep's -F order, the rows are visited
// in cell order) and the writes.  Design: one thread per row, the rows in
// K15's thread layout so that its counts give the block offsets.
//
// exchange_paint (K17) replaces build_turn1_maps (121) with _paint_block
// (86): host h's boundary spheres (cx, cy, cz, r in cells) painted into the
// shard's [H, nx, ny, nz] uint8 map over the offsets [-r, r) of each
// dimension with ox^2 + oy^2 + oz^2 <= r^2, wrapped periodically, clipped
// to h's padded boxes and excluding its turn-0 boxes.  What bounds it: the
// box tests of each cell of the sphere's cube that falls in the shard.
// Design: a row of blocks per sphere (grid y), sized by the largest cube so
// that one big sphere does not leave the card to a single block; in each,
// three threads list the offsets of each dimension that land in the shard
// (in shared memory), and the row's threads stride over the product of the
// three lists.  The write of 1 is idempotent, so overlapping spheres race
// harmlessly.  All three results are exact: bits, integer counts, copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int wrap(int d, int N) { return ((d % N) + N) % N; }

// whether (gx, gy, gz) lies in any box of boxes[lo:hi] ([nb, 6]: x0, Lx,
// y0, Ly, z0, Lz)
__device__ __forceinline__ bool member(const int* __restrict__ boxes, int lo,
                                       int hi, int gx, int gy, int gz,
                                       int N) {
  for (int k = lo; k < hi; ++k) {
    const int* b = boxes + 6 * k;
    if (wrap(gx - b[0], N) < b[1] && wrap(gy - b[2], N) < b[3] &&
        wrap(gz - b[4], N) < b[5])
      return true;
  }
  return false;
}

struct Block {
  int x0, nx, y0, ny, z0, nz, N;
};

__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ cells, int64_t n, Block blk,
             const int* __restrict__ boxes, const int* __restrict__ box_off,
             const uint8_t* __restrict__ map, int H, int W,
             uint32_t* __restrict__ bits, int* __restrict__ counts) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < n;
  const int64_t c = valid ? cells[t] : 0;
  const int lz = (int)(c % blk.nz);
  const int ly = (int)((c / blk.nz) % blk.ny);
  const int lx = (int)(c / ((int64_t)blk.nz * blk.ny));
  const int gx = blk.x0 + lx, gy = blk.y0 + ly, gz = blk.z0 + lz;
  const int64_t ncell = (int64_t)blk.nx * blk.ny * blk.nz;
  // every thread of the block runs every iteration: the counts below are
  // block-wide barriers
  for (int w = 0; w < W; ++w) {
    uint32_t word = 0;
    for (int b = 0; b < 32 && w * 32 + b < H; ++b) {
      const int h = w * 32 + b;
      bool m = false;
      if (valid) {
        m = map != nullptr
                ? map[(int64_t)h * ncell + c] != 0
                : member(boxes, box_off[h], box_off[h + 1], gx, gy, gz,
                         blk.N);
      }
      word |= (uint32_t)m << b;
      const int cnt = __syncthreads_count(m);
      if (threadIdx.x == 0) counts[(int64_t)blockIdx.x * H + h] = cnt;
    }
    if (valid) bits[t * W + w] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int64_t* __restrict__ perm, const float* __restrict__ buf,
            int64_t count, const uint32_t* __restrict__ bits, int W,
            const int64_t* __restrict__ block_off, int H,
            const int* __restrict__ host_nd,
            const int* __restrict__ host_devs, int ndmax,
            const int64_t* __restrict__ seg_base,
            const int64_t* __restrict__ seg_n, int nch,
            float* __restrict__ out) {
  __shared__ int warp_tot[kWarps];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < count;
  const int64_t row = valid ? perm[t] : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = 0; h < H; ++h) {
    const bool m = valid && ((bits[t * W + (h >> 5)] >> (h & 31)) & 1u);
    const unsigned ballot = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    if (m) {
      int before = __popc(ballot & ((1u << lane) - 1u));
      for (int k = 0; k < warp; ++k) before += warp_tot[k];
      const int64_t i = block_off[(int64_t)blockIdx.x * H + h] + before;
      const int nd = host_nd[h];
      const int p = host_devs[h * ndmax + (int)(i % nd)];
      const int64_t slot = i / nd, ns = seg_n[p];
      float* o = out + seg_base[p];
      o[slot] = buf[row];                       // the local cell's bits
      o[ns + slot] = buf[count + row];          // F
      const float* src = buf + 2 * count + 3 * row;
      float* dst = o + 2 * ns + 3 * slot;
      for (int ch = 0; ch < nch; ++ch) {
        dst[0] = src[0];
        dst[1] = src[1];
        dst[2] = src[2];
        src += 3 * count;
        dst += 3 * ns;
      }
    }
    __syncthreads();                            // warp_tot is reused
  }
}

__global__ void __launch_bounds__(kThreads)
paint_kernel(const float* __restrict__ spheres,
             const int* __restrict__ sphere_host, Block blk,
             const int* __restrict__ pad_boxes,
             const int* __restrict__ pad_off,
             const int* __restrict__ t0_boxes,
             const int* __restrict__ t0_off, int cap,
             uint8_t* __restrict__ map) {
  extern __shared__ int offs[];                 // [3][cap]
  __shared__ int cnt[3];
  const int si = blockIdx.x;
  const int r = (int)spheres[4 * si + 3];
  if (r <= 0) return;                           // uniform over the block
  const int h = sphere_host[si];
  const int org[3] = {blk.x0, blk.y0, blk.z0};
  const int ext[3] = {blk.nx, blk.ny, blk.nz};
  if (threadIdx.x < 3) {
    const int d = threadIdx.x;
    const int c = (int)spheres[4 * si + d];
    int k = 0;
    for (int o = -r; o < r; ++o) {
      const int l = wrap(c + o, blk.N) - org[d];
      if (l >= 0 && l < ext[d]) offs[d * cap + k++] = o;
    }
    cnt[d] = k;
  }
  __syncthreads();
  const int c0 = cnt[0], c1 = cnt[1], c2 = cnt[2];
  const int64_t total = (int64_t)c0 * c1 * c2;
  const int cx = (int)spheres[4 * si], cy = (int)spheres[4 * si + 1],
            cz = (int)spheres[4 * si + 2];
  const int64_t r2 = (int64_t)r * r;
  for (int64_t q = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; q < total;
       q += (int64_t)gridDim.y * blockDim.x) {
    const int ox = offs[(int)(q / ((int64_t)c1 * c2))];
    const int oy = offs[cap + (int)((q / c2) % c1)];
    const int oz = offs[2 * cap + (int)(q % c2)];
    if ((int64_t)ox * ox + (int64_t)oy * oy + (int64_t)oz * oz > r2)
      continue;
    const int gx = wrap(cx + ox, blk.N), gy = wrap(cy + oy, blk.N),
              gz = wrap(cz + oz, blk.N);
    if (!member(pad_boxes, pad_off[h], pad_off[h + 1], gx, gy, gz, blk.N))
      continue;
    if (member(t0_boxes, t0_off[h], t0_off[h + 1], gx, gy, gz, blk.N))
      continue;
    map[(((int64_t)h * blk.nx + (gx - blk.x0)) * blk.ny + (gy - blk.y0)) *
            blk.nz +
        (gz - blk.z0)] = 1;
  }
}

Block make_block(const int* b, int N) {
  return Block{b[0], b[1], b[2], b[3], b[4], b[5], N};
}

}  // namespace

// cells [n] int64 local cells (ascending), block (host) [6] = x0, nx, y0,
// ny, z0, nz; boxes [nb, 6] int32 and box_off [H + 1] int32, or map
// [H, nx*ny*nz] uint8 (boxes unused when map is set); bits [n, W] uint32,
// counts [ceil(n / 256), H] int32
extern "C" int exchange_count(const void* cells, int64_t n,
                              const void* block_host, int N,
                              const void* boxes, const void* box_off,
                              const void* map, int H, void* bits,
                              void* counts, void* stream) {
  if (n == 0) return 0;
  if (H < 1) return (int)cudaErrorInvalidValue;
  const int W = (H + 31) / 32;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  count_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)cells, n, make_block((const int*)block_host, N),
      (const int*)boxes, (const int*)box_off, (const uint8_t*)map, H, W,
      (uint32_t*)bits, (int*)counts);
  return (int)cudaGetLastError();
}

// perm [count] int64: the hand-off row of each cell-ordered row; buf the
// shard's packed hand-off buffer of count rows and nch row channels; bits
// and block_off ([nblocks, H] int64) from K15; host_nd [H], host_devs
// [H, ndmax] int32 (destination mesh positions); seg_base, seg_n [p] int64
// (each destination segment's float offset in out and its row count)
extern "C" int exchange_pack(const void* perm, const void* buf, int64_t count,
                             const void* bits, int W, const void* block_off,
                             int H, const void* host_nd,
                             const void* host_devs, int ndmax,
                             const void* seg_base, const void* seg_n,
                             int nch, void* out, void* stream) {
  if (count == 0) return 0;
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)perm, (const float*)buf, count, (const uint32_t*)bits,
      W, (const int64_t*)block_off, H, (const int*)host_nd,
      (const int*)host_devs, ndmax, (const int64_t*)seg_base,
      (const int64_t*)seg_n, nch, (float*)out);
  return (int)cudaGetLastError();
}

// spheres [ns, 4] float32 (cx, cy, cz, r), sphere_host [ns] int32; the
// padded and turn-0 boxes with their per-host offsets as K15's; rmax the
// largest radius (it sizes the offset lists); map [H, nx, ny, nz] uint8,
// zeroed by the caller
extern "C" int exchange_paint(const void* spheres, const void* sphere_host,
                              int ns, const void* block_host, int N,
                              const void* pad_boxes, const void* pad_off,
                              const void* t0_boxes, const void* t0_off,
                              int rmax, void* map, void* stream) {
  if (ns == 0 || rmax <= 0) return 0;
  const int cap = 2 * rmax;
  const size_t shared = 3 * (size_t)cap * sizeof(int);
  if (shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  // blocks per sphere: about 64 cells per thread of the largest cube
  const int64_t cube = 8 * (int64_t)rmax * rmax * rmax;
  const int64_t rows = (cube + 64 * kThreads - 1) / (64 * kThreads);
  const dim3 grid((unsigned)ns, (unsigned)(rows < 1024 ? rows : 1024));
  paint_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const float*)spheres, (const int*)sphere_host,
      make_block((const int*)block_host, N), (const int*)pad_boxes,
      (const int*)pad_off, (const int*)t0_boxes, (const int*)t0_off, cap,
      (uint8_t*)map);
  return (int)cudaGetLastError();
}
