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
// (run of 256 rows, host), the block offsets K16 scans.  A box [x0, x0 + L)
// mod N holds g when ((g - x0) % N + N) % N < L, so a box with L >= N
// covers its whole dimension.  What bounds it on the H100: the 8-byte cell
// read and the bitmask write per row, coalesced, 12 B a row; the first
// design (one row a thread) was issue-bound instead, on a row's 64-bit
// divisions, two 32-bit % per box test and a block-wide
// __syncthreads_count per host.  Design: a row's local cell splits into
// (lx, ly, lz) by 32-bit multiplies with magic numbers made on the host
// (Granlund-Montgomery: for x < 2^31 and 1 <= d < 2^31, x / d = (x m) >>
// (31 + l) with l = ceil(log2 d), m = ceil(2^(31 + l) / d) < 2^32), where
// the shard holds fewer than 2^31 cells (every grid the planner admits on
// one card); the wrapper picks a 64-bit form with divisions otherwise.
// Each block first builds its box tables in shared memory: where they fit,
// each host's boxes as masks over the shard's coordinates (for every x,
// y and z of the shard a word whose bit j says whether the host's box j
// holds it in that dimension; 32 boxes a word, more in further words), so
// a row's test for a host is three shared loads and two ANDs whatever its
// boxes; else the boxes themselves with their origins taken into [0, N),
// tested in turn, each dimension's wrap one compare and add (a shard's
// coordinates lie in [0, N): the wrapper holds its block inside the grid).
// A warp takes a run of 256 rows, eight a lane by four 16-byte loads of
// the cells, and counts the run's members of each host by ballots and
// __popc, lane h writing host h's count: no block barrier after the
// tables, so the warps of a block drift apart and their loads overlap the
// others' tests.  The blocks, as many as the card holds at once, walk the
// runs in a grid-stride loop, so a block builds its tables once.  Map mode
// reads map[h ncell + c], a byte of a sector per row and host, and needs
// no coordinates.
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
// in cell order, so a row of 2 + 3 nch floats touches about 2 + 1.25 nch
// sectors whatever the kernel does) and the writes: random 32-byte reads,
// which run well below the card's peak rate, so the kernel's aim is to
// keep them in flight.  Design: one thread a row, in K15's thread layout
// so that its counts give the block offsets.  Each thread loads its perm
// entry and host words, then its whole payload into registers before any
// barrier, so a row's payload is read once however many hosts take it and
// all its loads are in flight together; the warps ballot every host of a
// bitmask word into shared memory, one scan over the warps a host gives
// each warp's offset (two barriers a word, so two in all up to 32 hosts),
// and each membership is stored from the registers, its rank divided by
// its host's destinations in 32 bits.  More rows a thread, or a warp's
// stores gathered into runs through shared memory, gained nothing on the
// H100: the reads hold it.
//
// exchange_paint (K17) replaces build_turn1_maps (121) with _paint_block
// (86): host h's boundary spheres (cx, cy, cz, r in cells) painted into the
// shard's [H, nx, ny, nz] uint8 map over the offsets [-r, r) of each
// dimension with ox^2 + oy^2 + oz^2 <= r^2, wrapped periodically, clipped
// to h's padded boxes and excluding its turn-0 boxes.  What bounds it: the
// map's bytes (zeroed by the entry point, then the painted cells written)
// and a few integer operations per column of the balls in the shard.
// Design: the work is the ball, not the cube, sized per sphere.  The host's
// plan (ops/exchange.PaintSpheres, built once per exchange, cut to a
// PaintPlan per shard: work per sphere, none per cell) gives each sphere
// one row: the (gx, gy) columns of its bounding square [c - r, c + r) that
// fall in the shard, as at most two runs a dimension, with an exclusive
// scan of their counts; a block takes 32 consecutive columns
// and reads their rows (at most one more) into shared memory together, so
// no block does serial set-up and none waits on another sphere's size.  Its
// first warp sets the columns up, a lane each: the row by a binary search,
// the column's (gx, gy) from its rank in the rectangle, kept when it lies
// in the ball's disc (mx^2 + my^2 <= r^2, mx, my the periodic distances to
// the centre, about 3/4 of a square), the ball's z cells as the periodic
// interval [cz - zr, cz + min(zr, r - 1)] with zr the exact integer square
// root of r^2 - mx^2 - my^2, cut to the shard in at most two runs;
// the host's padded and turn-0 boxes that hold (gx, gy) as masks (a box's
// wrap by compare and add).  Where the padded boxes' z union is one
// interval (one box, or one spanning z) and at most one turn-0 box holds
// the column, the column's runs are cut to it exactly, with no test per
// cell; otherwise its runs are tested cell by cell.  The block's runs are
// listed in shared memory and its warps take them in turn, lanes on
// consecutive z, writing consecutive bytes of the map.  The write of 1 is
// idempotent, so
// overlapping spheres race harmlessly.  All three results are exact: bits,
// integer counts, copies.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int wrap(int d, int N) { return ((d % N) + N) % N; }

struct Block {
  int x0, nx, y0, ny, z0, nz, N;
};

// K15: x / d = (x m) >> s for every x < 2^31 (see above)
struct Magic {
  uint32_t m;
  int s;
};

__device__ __forceinline__ uint32_t divide(uint32_t x, Magic d) {
  return (uint32_t)(((uint64_t)x * d.m) >> d.s);
}

Magic magic(uint32_t d) {
  int l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint64_t p = uint64_t{1} << (31 + l);
  return Magic{(uint32_t)((p + d - 1) / d), 31 + l};
}

constexpr int kCountLoads = 4;                       // 16-byte loads a lane
constexpr int kCountRows = 2 * kCountLoads;          // rows a lane
constexpr int kCountRun = 32 * kCountRows;           // rows a warp, a count
static_assert(kCountRun == 256, "a warp's rows are one 256-row count");
// ints of the box tables a block keeps in shared memory
// (ops/exchange.COUNT_TABLE_INTS)
constexpr int kCountTableInts = 51200;
constexpr int kMaxDevices = 64;
// how a row's hosts are found: each host's boxes tested in turn, the
// boxes' masks per coordinate (a word of up to 32 boxes of one host, a
// chunk, per x, y and z of the shard), or the request maps
enum CountMode { kBoxLoop, kBoxMasks, kMaps };

// d = g - x0 in (-N, N) taken into [0, N)
__device__ __forceinline__ int near_wrap(int d, int N) {
  return d < 0 ? d + N : d;
}

// the local cell c's coordinates in the shard's block: 32-bit magic
// divisions (kWide false), or 64-bit divisions
template <bool kWide>
__device__ __forceinline__ void local_coords(int64_t c, const Block& blk,
                                             Magic dnz, Magic dny, int& lx,
                                             int& ly, int& lz) {
  if (kWide) {
    const int64_t q = c / blk.nz;
    lz = (int)(c - q * blk.nz);
    const int64_t x = q / blk.ny;
    ly = (int)(q - x * blk.ny);
    lx = (int)x;
  } else {
    const uint32_t c32 = (uint32_t)c;
    const uint32_t q = divide(c32, dnz);
    lz = (int)(c32 - q * (uint32_t)blk.nz);
    const uint32_t x = divide(q, dny);
    ly = (int)(q - x * (uint32_t)blk.ny);
    lx = (int)x;
  }
}

// whether (gx, gy, gz) lies in a box of s_box[lo:hi] (rows x0, Lx, y0,
// Ly, z0, Lz, the origins in [0, N))
__device__ __forceinline__ bool member(const int* s_box, int lo, int hi,
                                       int gx, int gy, int gz, int N) {
  for (int k = lo; k < hi; ++k) {
    const int* b = s_box + 6 * k;
    if (near_wrap(gx - b[0], N) < b[1] && near_wrap(gy - b[2], N) < b[3] &&
        near_wrap(gz - b[4], N) < b[5])
      return true;
  }
  return false;
}

// the ints of shared memory a mode's tables take, the masks' chunks at
// most H + nb / 32
int64_t count_table_ints(CountMode mode, int nb, int H, const Block& blk) {
  if (mode == kMaps) return 0;
  if (mode == kBoxLoop) return 6 * (int64_t)nb + H + 1;
  const int64_t chunks = H + nb / 32;
  return H + 1 + chunks * (2 + (int64_t)blk.nx + blk.ny + blk.nz);
}

// The block's tables.  kBoxLoop: the boxes [nb, 6] with their origins in
// [0, N), then off [H + 1].  kBoxMasks: each host's first chunk coff
// [H + 1], each chunk's boxes [cbox, cend), then each chunk's masks over
// the shard's x, y and z (nx + ny + nz words: bit j of the word of
// coordinate g set when box cbox + j holds g in that dimension).
template <int kMode>
__device__ void count_tables(int* s_table, const Block& blk,
                             const int* __restrict__ boxes, int nb,
                             const int* __restrict__ box_off, int H,
                             int cmax) {
  const int N = blk.N;
  if (kMode == kBoxLoop) {
    int* s_off = s_table + 6 * nb;
    for (int i = threadIdx.x; i < 6 * nb; i += kThreads) {
      const int v = boxes[i];
      s_table[i] = (i & 1) ? v : wrap(v, N);
    }
    for (int i = threadIdx.x; i <= H; i += kThreads) s_off[i] = box_off[i];
  } else if (kMode == kBoxMasks) {
    int* s_coff = s_table;
    int* s_cbox = s_coff + H + 1;
    int* s_cend = s_cbox + cmax;
    uint32_t* s_mask = (uint32_t*)(s_cend + cmax);
    if (threadIdx.x == 0) {
      int c = 0;
      for (int h = 0; h < H; ++h) {
        s_coff[h] = c;
        const int hi = box_off[h + 1];
        for (int k = box_off[h]; k < hi; k += 32, ++c) {
          s_cbox[c] = k;
          s_cend[c] = min(k + 32, hi);
        }
      }
      s_coff[H] = c;
    }
    __syncthreads();
    const int S = blk.nx + blk.ny + blk.nz;
    const int chunks = s_coff[H];
    for (int e = threadIdx.x; e < chunks * S; e += kThreads) {
      const int c = e / S, i = e - c * S;
      const int d = i < blk.nx ? 0 : i < blk.nx + blk.ny ? 1 : 2;
      const int g = d == 0   ? blk.x0 + i
                    : d == 1 ? blk.y0 + i - blk.nx
                             : blk.z0 + i - blk.nx - blk.ny;
      uint32_t m = 0;
      for (int k = s_cbox[c]; k < s_cend[c]; ++k) {
        const int o = wrap(boxes[6 * k + 2 * d], N);
        m |= (uint32_t)(near_wrap(g - o, N) < boxes[6 * k + 2 * d + 1])
             << (k - s_cbox[c]);
      }
      s_mask[e] = m;
    }
  }
}

// the cells of a run's rows that lane l holds: c[2k], c[2k + 1] the rows
// 64 k + 2 l and 64 k + 2 l + 1 (0 past n), by 16-byte loads where vec
// (cells 16-byte aligned)
__device__ __forceinline__ void load_run(const int64_t* __restrict__ cells,
                                         int64_t n, bool vec, int64_t run,
                                         int lane, int64_t* c) {
#pragma unroll
  for (int k = 0; k < kCountLoads; ++k) {
    const int64_t r = run * kCountRun + 64 * k + 2 * lane;
    if (vec && r + 1 < n) {
      const longlong2 v =
          __ldcs(reinterpret_cast<const longlong2*>(cells + r));
      c[2 * k] = v.x;
      c[2 * k + 1] = v.y;
    } else {
      c[2 * k] = r < n ? __ldcs(cells + r) : 0;
      c[2 * k + 1] = r + 1 < n ? __ldcs(cells + r + 1) : 0;
    }
  }
}

// warp w of block b takes the runs b kWarps + w, then every gridDim.x
// kWarps runs on, of kCountRun rows (loading a warp's next run before it
// tests the current one measured slower for 2 hosts:
// scripts/torch_kernel_variants.py)
template <bool kWide, int kMode>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ cells, int64_t n, Block blk,
             Magic dnz, Magic dny, const int* __restrict__ boxes, int nb,
             const int* __restrict__ box_off,
             const uint8_t* __restrict__ map, int H, int W, int cmax,
             bool vec, uint32_t* __restrict__ bits,
             int* __restrict__ counts) {
  extern __shared__ int s_table[];
  const int lane = threadIdx.x & 31;
  const int N = blk.N;
  count_tables<kMode>(s_table, blk, boxes, nb, box_off, H, cmax);
  if (kMode != kMaps) __syncthreads();        // the tables are in
  const int* s_off = s_table + 6 * nb;                    // kBoxLoop
  const int* s_coff = s_table;                            // kBoxMasks
  const uint32_t* s_mask = (const uint32_t*)(s_table + H + 1 + 2 * cmax);
  const int S = blk.nx + blk.ny + blk.nz;
  const int64_t ncell = (int64_t)blk.nx * blk.ny * blk.nz;
  const int64_t nruns = (n + kCountRun - 1) / kCountRun;
  for (int64_t run = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       run < nruns; run += (int64_t)gridDim.x * kWarps) {
    int64_t c[kCountRows];
    load_run(cells, n, vec, run, lane, c);
    int64_t row[kCountRows];
#pragma unroll
    for (int k = 0; k < kCountLoads; ++k) {
      row[2 * k] = run * kCountRun + 64 * k + 2 * lane;
      row[2 * k + 1] = row[2 * k] + 1;
    }
    int l[kCountRows][3];
    if (kMode != kMaps) {
#pragma unroll
      for (int j = 0; j < kCountRows; ++j)
        local_coords<kWide>(c[j], blk, dnz, dny, l[j][0], l[j][1], l[j][2]);
    }
    for (int w = 0; w < W; ++w) {
      const int hw = min(32, H - 32 * w);     // hosts of this word
      uint32_t word[kCountRows] = {};
      int mine = 0;                           // lane h: host h's count
      for (int b = 0; b < hw; ++b) {
        const int h = 32 * w + b;
        const int q0 = kMode == kBoxMasks ? s_coff[h] : 0;
        const int q1 = kMode == kBoxMasks ? s_coff[h + 1] : 0;
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < kCountRows; ++j) {
          bool m = false;
          if (row[j] < n) {
            if (kMode == kMaps) {
              m = map[(int64_t)h * ncell + c[j]] != 0;
            } else if (kMode == kBoxMasks) {
              for (int q = q0; q < q1 && !m; ++q) {
                const uint32_t* t = s_mask + q * S;
                m = (t[l[j][0]] & t[blk.nx + l[j][1]] &
                     t[blk.nx + blk.ny + l[j][2]]) != 0;
              }
            } else {
              m = member(s_table, s_off[h], s_off[h + 1], blk.x0 + l[j][0],
                         blk.y0 + l[j][1], blk.z0 + l[j][2], N);
            }
          }
          word[j] |= (uint32_t)m << b;
          cnt += __popc(__ballot_sync(0xffffffffu, m));
        }
        if (lane == b) mine = cnt;
      }
      if (W == 1) {
#pragma unroll
        for (int k = 0; k < kCountLoads; ++k) {
          const int64_t r = row[2 * k];
          if (r + 1 < n)
            *reinterpret_cast<uint2*>(bits + r) =
                make_uint2(word[2 * k], word[2 * k + 1]);
          else if (r < n)
            bits[r] = word[2 * k];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCountRows; ++j)
          if (row[j] < n) bits[row[j] * W + w] = word[j];
      }
      if (lane < hw) counts[run * H + 32 * w + lane] = mine;
    }
  }
}

// K16: the payload of kRegCh row channels is held in registers, any
// further channel is copied straight from the hand-off buffer.  A rank is
// below count, which the wrapper holds under 2^32, so the ranks and their
// division by a host's destinations are 32-bit; the float offsets in buf
// and in a segment (up to count * (2 + 3 nch)) are 64-bit.
constexpr int kRegCh = 4;
constexpr int kPay = 2 + 3 * kRegCh;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int64_t* __restrict__ perm, const float* __restrict__ buf,
            int64_t count, const uint32_t* __restrict__ bits, int W,
            const int64_t* __restrict__ block_off, int H,
            const int* __restrict__ host_nd,
            const int* __restrict__ host_devs, int ndmax,
            const int64_t* __restrict__ seg_base,
            const int64_t* __restrict__ seg_n, int nch,
            float* __restrict__ out) {
  __shared__ uint32_t s_bal[32][kWarps];      // each warp's ballot a host
  __shared__ int s_off[32][kWarps];           // the warps before it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = t < count;
  const int64_t n = count;
  // ---- the row's perm entry and host word, then its whole payload: all
  // its loads in flight together, before any barrier; a row that no host
  // takes loads no payload ----
  const int64_t row = valid ? perm[t] : 0;
  const uint32_t word0 = valid ? bits[t * W] : 0u;
  uint32_t any = word0;
  for (int w = 1; w < W && valid; ++w) any |= bits[t * W + w];
  float pay[kPay] = {};
  if (any) {
    pay[0] = __ldg(buf + row);                       // the local cell's bits
    pay[1] = __ldg(buf + n + row);                   // F
    const float* src = buf + 2 * n + 3 * row;
#pragma unroll
    for (int ch = 0; ch < kRegCh; ++ch) {
      if (ch < nch) {
        pay[2 + 3 * ch] = __ldg(src);
        pay[3 + 3 * ch] = __ldg(src + 1);
        pay[4 + 3 * ch] = __ldg(src + 2);
      }
      src += 3 * n;
    }
  }
  // ---- 32 hosts at a time (one bitmask word): the warps' ballots of every
  // host, one scan over the warps a host, then each membership's rank and
  // its stores from the registers ----
  const int64_t* off = block_off + (int64_t)blockIdx.x * H;
  for (int w = 0; w < W; ++w) {
    const int h0 = 32 * w, nh = min(32, H - h0);
    const uint32_t wd = w == 0 ? word0 : (valid ? bits[t * W + w] : 0u);
    for (int hb = 0; hb < nh; ++hb) {
      const uint32_t bal = __ballot_sync(0xffffffffu, (wd >> hb) & 1u);
      if (lane == 0) s_bal[hb][warp] = bal;
    }
    __syncthreads();
    if (threadIdx.x < nh) {
      int before = 0;
      for (int k = 0; k < kWarps; ++k) {
        s_off[threadIdx.x][k] = before;
        before += __popc(s_bal[threadIdx.x][k]);
      }
    }
    __syncthreads();
    for (uint32_t m = wd; m; m &= m - 1u) {
      const int hb = __ffs(m) - 1, h = h0 + hb;
      const uint32_t i = (uint32_t)off[h] + (uint32_t)s_off[hb][warp] +
                         (uint32_t)__popc(s_bal[hb][warp] & below);
      const uint32_t nd = (uint32_t)host_nd[h];
      const int p = host_devs[h * ndmax + (int)(i % nd)];
      const int64_t slot = i / nd, ns = seg_n[p];
      float* o = out + seg_base[p];
      o[slot] = pay[0];
      o[ns + slot] = pay[1];
      float* dst = o + 2 * ns + 3 * slot;
#pragma unroll
      for (int ch = 0; ch < kRegCh; ++ch) {
        if (ch < nch) {
          dst[0] = pay[2 + 3 * ch];
          dst[1] = pay[3 + 3 * ch];
          dst[2] = pay[4 + 3 * ch];
        }
        dst += 3 * ns;
      }
      for (int ch = kRegCh; ch < nch; ++ch) {
        const float* src = buf + (2 + 3 * ch) * n + 3 * row;
        dst[0] = __ldg(src);
        dst[1] = __ldg(src + 1);
        dst[2] = __ldg(src + 2);
        dst += 3 * ns;
      }
    }
    if (w + 1 < W) __syncthreads();             // s_bal, s_off are reused
  }
}

// K17's columns per block, set up a lane each by its first warp
constexpr int kPaintCols = 32;
static_assert(kPaintCols == 32, "K17's set-up scans its columns in one warp");

// d mod N by compare and add when |d| < N (box origins in [0, N), as
// build_host_regions gives them), else by %
__device__ __forceinline__ int ring(int d, int N) {
  d += d < 0 ? N : 0;
  return (unsigned)d < (unsigned)N ? d : wrap(d, N);
}

// whether box b ([6] ints) holds the column (gx, gy)
__device__ __forceinline__ bool holds_xy(const int* __restrict__ b, int gx,
                                         int gy, int N) {
  return ring(gx - b[0], N) < b[1] && ring(gy - b[2], N) < b[3];
}

// whether gz (in [0, N)) lies in the z interval of box b
__device__ __forceinline__ bool holds_z(const int* __restrict__ b, int gz,
                                        int N) {
  int rel = gz - ring(b[4], N);
  rel += rel < 0 ? N : 0;
  return rel < b[5];
}

// one column of the block: its map (offset by the shard's z0), its z runs
// [a0, b0) and [a1, b1), the column (gx, gy), and the host's padded and
// turn-0 boxes (pad, t0: the host's first; pm, tm: masks of the first 32
// that hold the column; pn, tn: how many the host has)
struct PaintCol {
  uint8_t* col;
  int a0, b0, a1, b1, gx, gy;
  const int* pad;
  const int* t0;
  unsigned pm, tm;
  int pn, tn;
};

// whether z lies in a box of boxes[0..n) that holds the column: the masked
// ones among the first 32, then any beyond
__device__ __forceinline__ bool in_any(const int* __restrict__ boxes,
                                       unsigned m, int n, int gx, int gy,
                                       int z, int N) {
  bool in = false;
  for (; m; m &= m - 1) in |= holds_z(boxes + 6 * (__ffs(m) - 1), z, N);
  for (int t = 32; t < n; ++t)
    in |= holds_xy(boxes + 6 * t, gx, gy, N) && holds_z(boxes + 6 * t, z, N);
  return in;
}

// the lanes' cells z0 + lane, z0 + 32 + lane, ... of [z0, z1), painted
// where they lie in a padded box and in no turn-0 box of the column; the
// tests are skipped where the caller's run already ensures them
__device__ __forceinline__ void paint_run(const PaintCol& p, int z0, int z1,
                                          bool test_pad, bool test_t0, int N,
                                          int lane) {
  for (int z = z0 + lane; z < z1; z += 32) {
    bool paint = true;
    if (test_pad) paint = in_any(p.pad, p.pm, p.pn, p.gx, p.gy, z, N);
    if (test_t0) paint &= !in_any(p.t0, p.tm, p.tn, p.gx, p.gy, z, N);
    if (paint) p.col[z] = 1;
  }
}

// the z runs [s, e) and [0, f) of box b's interval in [0, N); [0, 0) when
// it is empty
__device__ __forceinline__ void box_z(const int* __restrict__ b, int N,
                                      int& s, int& e, int& f) {
  s = ring(b[4], N);
  const int l = max(min(b[5], N), 0);
  e = min(s + l, N);
  f = max(s + l - N, 0);
}

// the plan (ops/exchange.PaintPlan): rows [nrows][kPaintRow], one a
// sphere (x run 1 start and length, x run 2 start, the same of y, the
// columns a rectangle's x holds, its first column, cx, cy, cz, r, host,
// 0, 0, 0), first [nblocks] (the row of each block's first column)
constexpr int kPaintRow = 16;
// runs a column lists: its two z runs, each cut by the padded boxes' union
// where it is one interval (two runs), each cut by one turn-0 box
constexpr int kColRuns = 8;

__global__ void __launch_bounds__(kThreads)
paint_kernel(const int* __restrict__ rows, int nrows,
             const int* __restrict__ first, int nblocks, int ncols,
             Block blk, const int* __restrict__ pad_boxes,
             const int* __restrict__ pad_off,
             const int* __restrict__ t0_boxes,
             const int* __restrict__ t0_off, uint8_t* __restrict__ map) {
  // the block's columns lie in the rows r0..r1 (every row has one), read
  // once, together, into shared memory
  __shared__ int srows[(kPaintCols + 1) * kPaintRow];
  __shared__ PaintCol cols[kPaintCols];
  // column l's runs at slots l * kColRuns.., roff[l] of the block's before
  // them; a run's flags: bit 0 test the padded boxes, bit 1 the turn-0 ones
  __shared__ int run_s[kPaintCols * kColRuns], run_e[kPaintCols * kColRuns];
  __shared__ unsigned char run_f[kPaintCols * kColRuns];
  __shared__ int roff[kPaintCols + 1];
  const int N = blk.N, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = first[blockIdx.x];
  const int r1 =
      (int)blockIdx.x + 1 < nblocks ? first[blockIdx.x + 1] : nrows - 1;
  const int nr = r1 - r0 + 1;
  for (int i = threadIdx.x; i < nr * kPaintRow; i += kThreads)
    srows[i] = rows[(int64_t)r0 * kPaintRow + i];
  __syncthreads();

  // ---- set-up, the first warp, a lane a column: its row
  // (a binary search), its z runs (global z, cut to the shard), the host's
  // boxes that hold it, and its runs to paint, listed for the block ----
  if (threadIdx.x < kPaintCols) {
    const int c = blockIdx.x * kPaintCols + threadIdx.x;
    const int slot = threadIdx.x * kColRuns;
    int n = 0;
    if (c < ncols) {
      int lo = 0, hi = nr - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (srows[mid * kPaintRow + 7] <= c)
          lo = mid;
        else
          hi = mid - 1;
      }
      // the column's place in the sphere's rectangle, then in the shard
      const int* rw = srows + lo * kPaintRow;
      const int j = c - rw[7], ix = j / rw[6], iy = j - ix * rw[6];
      const int lx = ix < rw[1] ? rw[0] + ix : rw[2] + (ix - rw[1]);
      const int ly = iy < rw[4] ? rw[3] + iy : rw[5] + (iy - rw[4]);
      const int cz = rw[10], r = rw[11], h = rw[12];
      PaintCol p;
      p.gx = blk.x0 + lx;
      p.gy = blk.y0 + ly;
      int dx = p.gx - rw[8], dy = p.gy - rw[9];
      dx += dx < 0 ? N : 0;
      dy += dy < 0 ? N : 0;
      const int mx = min(dx, N - dx), my = min(dy, N - dy);
      const int q = r * r - mx * mx - my * my;
      if (q >= 0) {                               // in the ball's disc
        int zr = (int)sqrtf((float)q);
        if (zr * zr > q)
          --zr;
        else if ((zr + 1) * (zr + 1) <= q)
          ++zr;
        // the periodic interval [a, a + zlen): the runs [a, end) and
        // [0, end - N) of [0, N)
        const int zlen = zr + min(zr, r - 1) + 1;
        int a = cz - zr;
        a += a < 0 ? N : 0;
        const bool whole = zlen >= N;
        const int zend = blk.z0 + blk.nz;
        p.a0 = max(whole ? 0 : a, blk.z0);
        p.b0 = min(whole ? N : min(a + zlen, N), zend);
        p.a1 = blk.z0;
        p.b1 = min(whole ? 0 : max(a + zlen - N, 0), zend);
        p.pad = pad_boxes + 6 * pad_off[h];
        p.pn = pad_off[h + 1] - pad_off[h];
        p.t0 = t0_boxes + 6 * t0_off[h];
        p.tn = t0_off[h + 1] - t0_off[h];
        p.pm = p.tm = 0;
        bool pwhole = false;                       // a box holds all z
        for (int k = 0; k < min(p.pn, 32); ++k) {
          const int* b = p.pad + 6 * k;
          if (holds_xy(b, p.gx, p.gy, N)) {
            p.pm |= 1u << k;
            pwhole |= b[5] >= N;
          }
        }
        for (int k = 0; k < min(p.tn, 32); ++k)
          p.tm |= (unsigned)holds_xy(p.t0 + 6 * k, p.gx, p.gy, N) << k;
        p.col = map + ((((int64_t)h * blk.nx + lx) * blk.ny + ly) * blk.nz -
                       blk.z0);
        cols[threadIdx.x] = p;
        // the padded boxes' z union: all of [0, N), or the one box's runs,
        // or (several boxes, or more than 32) tested cell by cell
        const bool pad_one = p.pn <= 32 && (pwhole || __popc(p.pm) == 1);
        int ps = 0, pe = N, pf = 0;
        if (pad_one && !pwhole)
          box_z(p.pad + 6 * (__ffs(p.pm) - 1), N, ps, pe, pf);
        // one turn-0 box (or none) is cut out; several are tested
        const bool t0_one = p.tn <= 32 && (p.tm & (p.tm - 1)) == 0;
        int ts = N, te = N, tf = 0;
        if (t0_one && p.tm)
          box_z(p.t0 + 6 * (__ffs(p.tm) - 1), N, ts, te, tf);
        const bool any = p.pm != 0 || p.pn > 32;
        const int s4[4] = {max(p.a0, ps), p.a0, max(p.a1, ps), p.a1};
        const int e4[4] = {min(p.b0, pe), min(p.b0, pf), min(p.b1, pe),
                           min(p.b1, pf)};
        const unsigned char flags = (pad_one ? 0 : 1) | (t0_one ? 0 : 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // without one union the column's own two runs, tested (u = 0, 2)
          const int s0 = pad_one ? s4[u] : (u == 0 ? p.a0 : p.a1);
          const int e0 =
              pad_one ? e4[u] : (u == 0 ? p.b0 : u == 2 ? p.b1 : 0);
          if (!any || s0 >= e0) continue;
          if (!t0_one) {
            run_s[slot + n] = s0;
            run_e[slot + n] = e0;
            run_f[slot + n++] = flags;
            continue;
          }
          const int s1 = max(s0, tf);                // cut out [0, tf)
          if (s1 < min(e0, ts)) {                    // and [ts, te)
            run_s[slot + n] = s1;
            run_e[slot + n] = min(e0, ts);
            run_f[slot + n++] = flags;
          }
          if (max(s1, te) < e0) {
            run_s[slot + n] = max(s1, te);
            run_e[slot + n] = e0;
            run_f[slot + n++] = flags;
          }
        }
      }
    }
    int upto = n;                                   // inclusive scan
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += v;
    }
    roff[threadIdx.x + 1] = upto;
    if (threadIdx.x == 0) roff[0] = 0;
  }
  __syncthreads();

  // ---- cells: the warps take the block's runs in turn, lanes on
  // consecutive z ----
  for (int i = warp; i < roff[kPaintCols]; i += kWarps) {
    int l = 0;                                        // roff[l] <= i
    for (int step = kPaintCols / 2; step; step >>= 1)
      if (roff[l + step] <= i) l += step;
    const int k = l * kColRuns + i - roff[l];
    const unsigned f = run_f[k];
    paint_run(cols[l], run_s[k], run_e[k], f & 1, f & 2, N, lane);
  }
}

Block make_block(const int* b, int N) {
  return Block{b[0], b[1], b[2], b[3], b[4], b[5], N};
}

int sm_count(int dev) {
  static int count[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

// K15 on the blocks resident on the device at once (a warp for every run
// when fewer), each warp walking its runs; the residency is queried once
// per device and shared memory size (a run's shards share one)
template <bool kWide, int kMode>
int count_launch(size_t smem, cudaStream_t s, const int64_t* cells,
                 int64_t n, const Block& blk, const int* boxes, int nb,
                 const int* box_off, const uint8_t* map, int H, int W,
                 int cmax, bool vec, uint32_t* bits, int* counts) {
  static size_t seen_smem[kMaxDevices];
  static int64_t seen_most[kMaxDevices];
  auto fn = count_kernel<kWide, kMode>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (seen_most[dev] == 0 || seen_smem[dev] != smem) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    seen_smem[dev] = smem;
    seen_most[dev] = (int64_t)per_sm * sm_count(dev);
  }
  const int64_t most = seen_most[dev];
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t blocks = (n + kCountRun * kWarps - 1) / (kCountRun * kWarps);
  fn<<<(unsigned)std::min(blocks, most), kThreads, smem, s>>>(
      cells, n, blk, magic((uint32_t)blk.nz), magic((uint32_t)blk.ny), boxes,
      nb, box_off, map, H, W, cmax, vec, bits, counts);
  return (int)cudaGetLastError();
}

template <int kMode>
int count_launch(bool wide, size_t smem, cudaStream_t s,
                 const int64_t* cells, int64_t n, const Block& blk,
                 const int* boxes, int nb, const int* box_off,
                 const uint8_t* map, int H, int W, int cmax, bool vec,
                 uint32_t* bits, int* counts) {
  return wide ? count_launch<true, kMode>(smem, s, cells, n, blk, boxes, nb,
                                          box_off, map, H, W, cmax, vec,
                                          bits, counts)
              : count_launch<false, kMode>(smem, s, cells, n, blk, boxes, nb,
                                           box_off, map, H, W, cmax, vec,
                                           bits, counts);
}

}  // namespace

// cells [n] int64 local cells (ascending), block (host) [6] = x0, nx, y0,
// ny, z0, nz inside [0, N) each; boxes [nb, 6] int32 and box_off [H + 1]
// int32, or map [H, nx*ny*nz] uint8 (boxes unused when map is set); bits
// [n, W] uint32 (8-byte aligned), counts [ceil(n / 256), H] int32; wide: the
// 64-bit coordinate form, needed from 2^31 cells in the shard.  Boxes take
// the masks where their tables fit kCountTableInts, else the loop.
extern "C" int exchange_count(const void* cells, int64_t n,
                              const void* block_host, int N,
                              const void* boxes, int nb, const void* box_off,
                              const void* map, int H, void* bits,
                              void* counts, int wide, void* stream) {
  if (n == 0) return 0;
  const Block blk = make_block((const int*)block_host, N);
  const int64_t ncell = (int64_t)blk.nx * blk.ny * blk.nz;
  if (H < 1 || nb < 0 || blk.nx < 1 || blk.ny < 1 || blk.nz < 1 ||
      (!wide && ncell >= (int64_t{1} << 31)))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)bits & 7) return (int)cudaErrorMisalignedAddress;
  CountMode mode = map != nullptr ? kMaps : kBoxMasks;
  if (count_table_ints(mode, nb, H, blk) > kCountTableInts) mode = kBoxLoop;
  const int64_t ints = count_table_ints(mode, nb, H, blk);
  if (ints > kCountTableInts) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ints * sizeof(int);
  const int W = (H + 31) / 32, cmax = H + nb / 32;
  const bool vec = ((uintptr_t)cells & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* c = (const int64_t*)cells;
  const auto* bx = (const int*)boxes;
  const auto* off = (const int*)box_off;
  const auto* m = (const uint8_t*)map;
  auto* b = (uint32_t*)bits;
  auto* k = (int*)counts;
  if (mode == kMaps)
    return count_launch<kMaps>(wide, smem, s, c, n, blk, bx, nb, off, m, H,
                               W, cmax, vec, b, k);
  if (mode == kBoxMasks)
    return count_launch<kBoxMasks>(wide, smem, s, c, n, blk, bx, nb, off, m,
                                   H, W, cmax, vec, b, k);
  return count_launch<kBoxLoop>(wide, smem, s, c, n, blk, bx, nb, off, m, H,
                                W, cmax, vec, b, k);
}

// which: 0 the box masks, 1 the box loop, 2 the maps (32-bit coordinates);
// out[4] (host): registers, local bytes, shared bytes, resident blocks a SM
// (without dynamic shared memory)
extern "C" int exchange_kernel_info(int which, int* out) {
  cudaFuncAttributes a;
  const void* fn = which == 0   ? (const void*)count_kernel<false, kBoxMasks>
                   : which == 1 ? (const void*)count_kernel<false, kBoxLoop>
                                : (const void*)count_kernel<false, kMaps>;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, fn,
                                                            kThreads, 0);
}

// perm [count] int64: the hand-off row of each cell-ordered row; buf the
// shard's packed hand-off buffer of count rows and nch row channels; bits
// and block_off ([nblocks, H] int64) from K15; host_nd [H], host_devs
// [H, ndmax] int32 (destination mesh positions); seg_base, seg_n [p] int64
// (each destination segment's float offset in out and its row count);
// count < 2^32
extern "C" int exchange_pack(const void* perm, const void* buf, int64_t count,
                             const void* bits, int W, const void* block_off,
                             int H, const void* host_nd,
                             const void* host_devs, int ndmax,
                             const void* seg_base, const void* seg_n,
                             int nch, void* out, void* stream) {
  if (count == 0) return 0;
  if (H < 1 || W != (H + 31) / 32 || nch < 0 || count >= (int64_t{1} << 32))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  pack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)perm, (const float*)buf, count, (const uint32_t*)bits,
      W, (const int64_t*)block_off, H, (const int*)host_nd,
      (const int*)host_devs, ndmax, (const int64_t*)seg_base,
      (const int64_t*)seg_n, nch, (float*)out);
  return (int)cudaGetLastError();
}

// the plan's rows [nrows, kPaintRow] and first blocks (int32, see
// paint_kernel) for ncols columns in nblocks blocks of kPaintCols; the padded
// and turn-0 boxes with their per-host offsets as K15's; map [H, nx, ny, nz]
// uint8 of nmap bytes, zeroed here, then painted
extern "C" int exchange_paint(const void* rows, int nrows, const void* first,
                              int nblocks, int ncols, const void* block_host,
                              int N, const void* pad_boxes,
                              const void* pad_off, const void* t0_boxes,
                              const void* t0_off, void* map, int64_t nmap,
                              void* stream) {
  if (nblocks != (ncols + kPaintCols - 1) / kPaintCols || N > (1 << 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(map, 0, (size_t)nmap, (cudaStream_t)stream);
  if (e != cudaSuccess || ncols == 0) return (int)e;
  paint_kernel<<<(unsigned)nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, nrows, (const int*)first, nblocks, ncols,
      make_block((const int*)block_host, N), (const int*)pad_boxes,
      (const int*)pad_off, (const int*)t0_boxes, (const int*)t0_off,
      (uint8_t*)map);
  return (int)cudaGetLastError();
}
