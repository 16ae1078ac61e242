"""The device programs of the cross-host product exchange (counterpart of
count_local, pack_local and _paint_block in
pinocchio_tpu/parallel/exchange.py).

``count`` (K15), ``pack`` (K16) and ``paint`` (K17) are the wrappers of the
three kernels of ``csrc/exchange.cu``: on a CUDA tensor they launch the
kernel, on a CPU tensor they run the plain PyTorch version beside it.
Boxes are int32 rows (x0, Lx, y0, Ly, z0, Lz), a box holding the cells
[x0, x0 + L) mod N of each dimension, with the rows of host h at
box_off[h]:box_off[h + 1].  A shard's block is (x0, nx, y0, ny, z0, nz).
``paint`` takes its spheres as a ``PaintPlan``, cut for one shard from a
``PaintSpheres`` that the caller builds on the host, once per exchange,
from the numpy spheres it holds; it dispatches on the device of the box
tables.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

THREADS = 256         # the kernels' block size, and K15's rows a count


def words(nhosts: int) -> int:
    """uint32 words of a row's host bitmask."""
    return (nhosts + 31) // 32


def _block_coords(cells, block):
    x0, nx, y0, ny, z0, nz = block
    return (x0 + cells // (ny * nz), y0 + cells // nz % ny, z0 + cells % nz)


def _member_plain(boxes, lo, hi, gx, gy, gz, N):
    """Whether each cell (broadcast over gx, gy, gz) lies in a box of
    boxes[lo:hi]."""
    m = torch.zeros(torch.broadcast_shapes(gx.shape, gy.shape, gz.shape),
                    dtype=torch.bool, device=gx.device)
    for b in boxes[lo:hi]:
        m |= (((gx - b[0]) % N < b[1]) & ((gy - b[2]) % N < b[3])
              & ((gz - b[4]) % N < b[5]))
    return m


def _to_int32_bits(word):
    """int64 values in [0, 2^32) as the int32 of the same 32 bits."""
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def count_plain(cells, block, N, boxes, box_off, nhosts, hmap=None):
    """Plain version of K15: see count."""
    n = cells.numel()
    if hmap is not None:
        m = hmap.reshape(nhosts, -1)[:, cells].T != 0
    else:
        gx, gy, gz = _block_coords(cells, block)
        rows, off = boxes.tolist(), box_off.tolist()
        m = torch.stack([_member_plain(rows, off[h], off[h + 1], gx, gy, gz,
                                       N) for h in range(nhosts)], dim=1)
    W = words(nhosts)
    pad = torch.zeros((W * 32 - nhosts,), dtype=torch.int64)
    shifts = torch.cat([torch.arange(32, dtype=torch.int64)] * W)
    mm = torch.cat([m.to(torch.int64), pad.expand(n, -1).to(m.device)], 1)
    bits = _to_int32_bits((mm << shifts.to(m.device)).reshape(n, W, 32)
                          .sum(2))
    nblocks = -(-n // THREADS)
    full = torch.zeros((nblocks * THREADS, nhosts), dtype=torch.int32,
                       device=m.device)
    full[:n] = m.to(torch.int32)
    return bits, full.reshape(nblocks, THREADS, nhosts).sum(
        1, dtype=torch.int32)


def count(cells, block, N, boxes, box_off, nhosts, hmap=None):
    """Which hosts need each needed row of a shard: cells int64 [n], the
    shard's needed local cells in ascending order; the row is a member of
    host h when its global cell lies in one of h's boxes (boxes int32 [nb,
    6], box_off int32 [H + 1]), or, with hmap (uint8 [H, nx, ny, nz], the
    turn-1 request maps of the shard), when hmap[h] marks it.  Returns
    (bits int32 [n, ceil(H/32)], the uint32 bitmask of each row's hosts,
    bit h % 32 of word h // 32; counts int32 [ceil(n/256), H], the members
    of each host among each run of 256 rows)."""
    if not kernels.plain_or_kernel("exchange_count", cells):
        return count_plain(cells, block, N, boxes, box_off, nhosts, hmap)
    tensors = [cells, boxes, box_off] + ([hmap] if hmap is not None else [])
    kernels.require_cuda("exchange_count", *tensors)
    x0, nx, y0, ny, z0, nz = block
    if (cells.dtype != torch.int64 or boxes.dtype != torch.int32
            or box_off.dtype != torch.int32
            or box_off.numel() != nhosts + 1
            or (hmap is not None and (hmap.dtype != torch.uint8 or hmap.numel()
                                      != nhosts * nx * ny * nz))):
        raise ValueError("exchange_count: cells i64[n], boxes i32[nb, 6], "
                         "box_off i32[H + 1] and hmap u8[H, nx, ny, nz] "
                         "expected")
    n = cells.numel()
    bits = torch.empty((n, words(nhosts)), dtype=torch.int32,
                       device=cells.device)
    counts = torch.empty((-(-n // THREADS), nhosts), dtype=torch.int32,
                         device=cells.device)
    err = launch_count(cells, block, N, boxes, box_off, nhosts, hmap, bits,
                       counts, kernels.stream_ptr(cells.get_device()))
    if err:
        kernels.check("exchange_count", err)
    kernels.LAUNCHES["exchange_count"] += 1
    return bits, counts


# ints of K15's box tables a block holds in shared memory (kCountTableInts
# in csrc/exchange.cu)
COUNT_TABLE_INTS = 51200
_COUNT = None


def launch_count(cells, block, N, boxes, box_off, nhosts, hmap, bits,
                 counts, stream: int) -> int:
    """Hand K15's entry point (looked up in the kernel library once) its
    arguments: cells and n, the block, N, the box table, its rows nb and
    offsets, the map (None in boxes mode), H, bits, counts, the coordinate
    form and the stream; returns the cudaError_t.  The kernel splits a
    local cell into coordinates in 32 bits where the shard holds fewer than
    2^31 cells, else in 64 (wide); it wraps a box by one compare, so the
    block must lie inside the grid.  It holds its box tables in a block's
    shared memory, at most COUNT_TABLE_INTS ints: each host's boxes as
    masks over the shard's x, y and z (a word of up to 32 boxes, a chunk,
    per coordinate) where they fit, else the boxes themselves, tested in
    turn."""
    global _COUNT
    x0, nx, y0, ny, z0, nz = block
    if not all(0 <= o and e >= 1 and o + e <= N
               for o, e in ((x0, nx), (y0, ny), (z0, nz))):
        raise ValueError(f"exchange_count: block {tuple(block)} not inside "
                         f"the {N}^3 grid")
    nb = boxes.shape[0]
    masks = nhosts + 1 + (nhosts + nb // 32) * (2 + nx + ny + nz)
    if hmap is None and min(masks, 6 * nb + nhosts + 1) > COUNT_TABLE_INTS:
        raise ValueError(f"exchange_count: {nb} boxes and {nhosts} hosts, "
                         f"at most {COUNT_TABLE_INTS} ints of table")
    if _COUNT is None:
        _COUNT = kernels.lib().exchange_count
    return _COUNT(cells.data_ptr(), cells.numel(), (ctypes.c_int * 6)(*block),
                  N, boxes.data_ptr(), nb, box_off.data_ptr(),
                  hmap.data_ptr() if hmap is not None else None, nhosts,
                  bits.data_ptr(), counts.data_ptr(),
                  int(nx * ny * nz >= 2 ** 31), stream)


def kernel_info() -> dict:
    """{label: (registers, local bytes, shared bytes, resident 256-thread
    blocks per SM)} of K15's boxes and map forms on the current card."""
    out = {}
    for which, name in enumerate(("count box masks", "count box loop",
                                  "count maps")):
        info = (ctypes.c_int * 4)()
        kernels.check("exchange_kernel_info",
                      kernels.lib().exchange_kernel_info(which, info))
        out[name] = tuple(info)
    return out


def pack_plain(perm, buf, count, bits, block_off, host_nd, host_devs,
               seg_base, seg_n, nch, out):
    """Plain version of K16: see pack.  It ranks each host's members with a
    cumulative sum over the rows (block_off is K16's shortcut to the
    same ranks)."""
    nhosts = host_nd.numel()
    nd_l, devs_l = host_nd.tolist(), host_devs.tolist()
    for h in range(nhosts):
        m = (bits[:, h // 32] >> (h % 32)) & 1 == 1
        t = torch.nonzero(m).reshape(-1)
        if t.numel() == 0:
            continue
        i = torch.arange(t.numel(), device=buf.device)
        nd = nd_l[h]
        p = torch.tensor(devs_l[h][:nd], device=buf.device)[i % nd]
        slot = i // nd
        base, ns = seg_base[p], seg_n[p]
        r = perm[t]
        out[base + slot] = buf[r]
        out[base + ns + slot] = buf[count + r]
        src = (2 * count + 3 * r)[:, None] + torch.arange(
            3, device=buf.device)
        dst = (base + 2 * ns + 3 * slot)[:, None] + torch.arange(
            3, device=buf.device)
        for ch in range(nch):
            out[dst + ch * 3 * ns[:, None]] = buf[src + ch * 3 * count]
    return out


def pack(perm, buf, count, bits, block_off, host_nd, host_devs, seg_base,
         seg_n, nch, out):
    """Pack a shard's member rows into one segment per destination: perm
    int64 [count], the hand-off row (in buf, the shard's packed hand-off
    buffer of count rows and nch row channels, compact.gather_rows layout)
    of each row in ascending cell order; bits from count; block_off int64
    [ceil(count/256), H], the exclusive scan over blocks of count's
    counts.  The member of host h of rank i (in cell order) goes to the
    destination host_devs[h][i % host_nd[h]] (int32 tables [H], [H, ndmax]
    of mesh positions), slot i // host_nd[h]; destination p's segment
    starts at float seg_base[p] of out and holds seg_n[p] rows (int64
    [p]), laid out as a hand-off buffer of seg_n[p] rows.  Writes out
    (float32, 1-D) and returns it."""
    if not kernels.plain_or_kernel("exchange_pack", buf):
        return pack_plain(perm, buf, count, bits, block_off, host_nd,
                          host_devs, seg_base, seg_n, nch, out)
    kernels.require_cuda("exchange_pack", perm, buf, bits, block_off,
                         host_nd, host_devs, seg_base, seg_n, out)
    if (perm.dtype != torch.int64 or buf.dtype != torch.float32
            or bits.dtype != torch.int32 or block_off.dtype != torch.int64
            or host_nd.dtype != torch.int32 or host_devs.dtype != torch.int32
            or seg_base.dtype != torch.int64 or seg_n.dtype != torch.int64
            or out.dtype != torch.float32 or perm.numel() != count
            or buf.numel() != count * (2 + 3 * nch)):
        raise ValueError("exchange_pack: perm i64[count], buf f32[count * (2"
                         " + 3 nch)], bits i32, block_off i64, host tables "
                         "i32, segment tables i64 and out f32 expected")
    err = launch_pack(perm, buf, count, bits, block_off, host_nd, host_devs,
                      seg_base, seg_n, nch, out,
                      kernels.stream_ptr(buf.device))
    if err:
        kernels.check("exchange_pack", err)
    kernels.LAUNCHES["exchange_pack"] += 1
    return out


_PACK = None


def launch_pack(perm, buf, count, bits, block_off, host_nd, host_devs,
                seg_base, seg_n, nch, out, stream: int) -> int:
    """Hand K16's entry point (looked up in the kernel library once) its
    arguments: the tensors' pointers, count, the bitmask words W, H, ndmax,
    nch, then the stream; returns the cudaError_t.  The kernel ranks the
    rows in 32 bits, so count must be below 2^32."""
    global _PACK
    if count >= 2 ** 32:
        raise ValueError(f"exchange_pack: {count} rows, at most 2^32 - 1 "
                         "expected")
    if _PACK is None:
        _PACK = kernels.lib().exchange_pack
    return _PACK(perm.data_ptr(), buf.data_ptr(), count, bits.data_ptr(),
                 bits.shape[1], block_off.data_ptr(), host_nd.numel(),
                 host_nd.data_ptr(), host_devs.data_ptr(), host_devs.shape[1],
                 seg_base.data_ptr(), seg_n.data_ptr(), nch, out.data_ptr(),
                 stream)


PAINT_COLS = 32       # K17's columns per block (csrc/exchange.cu)
PAINT_ROW = 16        # ints per row of K17's plan
PAINT_MAX_N = 1 << 15  # r <= N keeps r * r in an int32


def _ring_runs(a, length, o, e, N):
    """The cells of the periodic interval [a, a + length) mod N (a in
    [0, N)) that fall in the window [o, o + e) of [0, N), as at most two
    runs in window coordinates: (s1, n1, s2, n2), each an array over the
    intervals."""
    full = length >= N
    end = a + length
    lo1 = np.where(full, 0, a)
    hi1 = np.where(full, N, np.minimum(end, N))
    hi2 = np.where(full, 0, np.maximum(end - N, 0))
    s1 = np.maximum(lo1, o)
    s2 = np.full_like(s1, o)
    return (s1 - o, np.maximum(np.minimum(hi1, o + e) - s1, 0),
            s2 - o, np.maximum(np.minimum(hi2, o + e) - s2, 0))


class PaintSpheres:
    """The part of K17's plan that every shard shares, built once per
    exchange on the host from the caller's numpy spheres (float32 [ns, 4]:
    cx, cy, cz, r in cells) and their hosts (int32 [ns]) on an N^3 grid;
    ``plan(block)`` cuts it to one shard.

    A sphere of radius r (truncated; r <= 0 paints nothing, r > N paints
    as r = N: every cell) covers the offsets [-r, r) of each dimension with
    ox^2 + oy^2 + oz^2 <= r^2, wrapped.  Offsets that wrap onto one cell
    (2r > N) leave it painted once, and the least |o| among them decides
    whether it is in the ball, so each dimension reduces to the periodic
    interval [c - r, c + r - 1] with the periodic distance to the centre.
    A column (gx, gy) of that square is in the ball when mx^2 + my^2 <=
    r^2; its cells are the interval [cz - zr, cz + min(zr, r - 1)] with
    zr = isqrt(r^2 - mx^2 - my^2).  Held here: the kept spheres' integer
    centres (mod N), radii and hosts."""

    def __init__(self, spheres, sphere_host, N: int):
        if N > PAINT_MAX_N:
            raise ValueError(f"exchange_paint: N {N} above {PAINT_MAX_N}")
        self.spheres = np.asarray(spheres, np.float32).reshape(-1, 4)
        self.host = np.asarray(sphere_host, np.int32).reshape(-1)
        if len(self.host) != len(self.spheres):
            raise ValueError("exchange_paint: one host per sphere expected")
        self.N = N
        r = np.trunc(self.spheres[:, 3].astype(np.float64)).astype(np.int64)
        keep = np.flatnonzero(r > 0)
        r = np.minimum(r[keep], N)
        c = np.trunc(self.spheres[keep, :3].astype(np.float64)).astype(
            np.int64) % N
        # the squares' corners and sides; cx, cy, cz, r, host as the rows
        # hold them
        self.x, self.y, self.side = (c[:, 0] - r) % N, (c[:, 1] - r) % N, 2 * r
        self.tail = np.column_stack([c, r, self.host[keep]]).astype(np.int32)
        h = self.host[keep]
        self.hosts = (int(h.min()), int(h.max())) if len(h) else (0, -1)

    def plan(self, block) -> "PaintPlan":
        """The plan of the shard ``block`` (x0, nx, y0, ny, z0, nz), a
        window of the grid that does not wrap."""
        return PaintPlan(self, block)


class PaintPlan:
    """K17's work list for one shard: a row of PAINT_ROW ints for each
    sphere whose square meets the block, with the square's x cells in the
    block as two runs (local start and length of the first, local start of
    the second), its y cells likewise, the number of y cells, the row's
    first column in the flat column order (x major), the sphere's cx, cy,
    cz, r and host; and per block of PAINT_COLS columns the row of its
    first column.  ``table(device)`` is that list as one int32 tensor on
    the device, uploaded once per device."""

    def __init__(self, sph: PaintSpheres, block):
        self.spheres, self.host, self.N = sph.spheres, sph.host, sph.N
        self.block = tuple(int(b) for b in block)
        x0, nx, y0, ny, z0, nz = self.block
        N = self.N
        if not (0 <= x0 and x0 + nx <= N and 0 <= y0 and y0 + ny <= N
                and 0 <= z0 and z0 + nz <= N):
            raise ValueError(f"exchange_paint: block {self.block} is not a "
                             f"window of the {N}^3 grid")
        xs, xn, xt, xm = _ring_runs(sph.x, sph.side, x0, nx, N)
        at = np.flatnonzero(xn + xm)
        ys, yn, yt, ym = _ring_runs(sph.y[at], sph.side[at], y0, ny, N)
        cols = (xn[at] + xm[at]) * (yn + ym)
        live = np.flatnonzero(cols)
        cols = cols[live]
        col0 = np.cumsum(cols) - cols
        self.ncols = int(cols.sum())
        if self.ncols >= 2 ** 31:
            raise ValueError("exchange_paint: over 2^31 columns")
        self.nrows = len(live)
        self.nblocks = -(-self.ncols // PAINT_COLS)
        # rows and first blocks in one int32 buffer, the upload's
        self.flat = np.empty(self.nrows * PAINT_ROW + self.nblocks, np.int32)
        self.rows = self.flat[:self.nrows * PAINT_ROW].reshape(-1, PAINT_ROW)
        xl = at[live]
        for k, v in enumerate((xs[xl], xn[xl], xt[xl], ys[live], yn[live],
                               yt[live], yn[live] + ym[live], col0)):
            self.rows[:, k] = v
        self.rows[:, 8:13] = sph.tail[xl]
        self.rows[:, 13:] = 0
        # the row of each block's first column: a row holds the starts of
        # the blocks from ceil(col0 / 32) to ceil((col0 + cols) / 32)
        starts = -(-(col0 + cols) // PAINT_COLS) + (col0 // -PAINT_COLS)
        self.first = self.flat[self.nrows * PAINT_ROW:]
        self.first[:] = np.repeat(np.arange(self.nrows), starts)
        self.hosts = sph.hosts
        self.c_block = (ctypes.c_int * 6)(*self.block)
        self._tables = {}

    def table(self, device):
        """The plan as one int32 tensor [rows | blocks] on
        ``device``: copied from page-locked memory, without a wait."""
        t = self._tables.get(device)
        if t is None:
            host = torch.from_numpy(self.flat)
            if device.type == "cuda":
                host = host.pin_memory()
            t = self._tables[device] = host.to(device, non_blocking=True)
        return t


def paint_plain(plan, pad_boxes, pad_off, t0_boxes, t0_off, nhosts):
    """Plain version of K17: see paint (the JAX package's _paint_block, on
    tensors: each sphere's cube of offsets, tested cell by cell)."""
    x0, nx, y0, ny, z0, nz = plan.block
    N = plan.N
    dev = pad_boxes.device
    out = torch.zeros((nhosts, nx, ny, nz), dtype=torch.uint8, device=dev)
    pad, poff = pad_boxes.tolist(), pad_off.tolist()
    t0, toff = t0_boxes.tolist(), t0_off.tolist()
    org, ext = (x0, y0, z0), (nx, ny, nz)
    for (cx, cy, cz, r), h in zip(plan.spheres.tolist(), plan.host.tolist()):
        s = int(r)
        if s <= 0:
            continue
        off = torch.arange(-s, s, device=dev)
        g, loc, keep = [], [], []
        for d, c in enumerate((cx, cy, cz)):
            gd = (int(c) + off) % N
            ld = gd - org[d]
            k = (ld >= 0) & (ld < ext[d])
            g.append(gd[k])
            loc.append(ld[k])
            keep.append(off[k])
        if not all(k.numel() for k in keep):
            continue
        ox, oy, oz = keep
        sel = (ox[:, None, None] ** 2 + oy[None, :, None] ** 2
               + oz[None, None, :] ** 2 <= s * s)
        gx, gy, gz = (g[0][:, None, None], g[1][None, :, None],
                      g[2][None, None, :])
        sel &= _member_plain(pad, poff[h], poff[h + 1], gx, gy, gz, N)
        sel &= ~_member_plain(t0, toff[h], toff[h + 1], gx, gy, gz, N)
        i, j, k = torch.nonzero(sel, as_tuple=True)
        out[h, loc[0][i], loc[1][j], loc[2][k]] = 1
    return out


def paint(plan, pad_boxes, pad_off, t0_boxes, t0_off, nhosts):
    """The turn-1 request maps of one shard: uint8 [H, nx, ny, nz] on the
    device of the box tables, 1 where a boundary sphere of host h (the
    plan's, see PaintSpheres) covers a cell at the offsets [-r, r) of each
    dimension with ox^2 + oy^2 + oz^2 <= r^2, wrapped periodically, that
    lies in one of h's padded boxes and in none of its turn-0 boxes (both
    as count's boxes; their origins in [0, N) keep the kernel's wrap to a
    compare).  The map is zeroed and painted in one call on the current
    stream; nothing waits for the card."""
    if not kernels.plain_or_kernel("exchange_paint", pad_boxes):
        return paint_plain(plan, pad_boxes, pad_off, t0_boxes, t0_off,
                           nhosts)
    kernels.require_cuda("exchange_paint", pad_boxes, pad_off, t0_boxes,
                         t0_off)
    if (any(t.dtype != torch.int32 for t in (pad_boxes, pad_off, t0_boxes,
                                              t0_off))
            or pad_boxes.dim() != 2 or pad_boxes.shape[1] != 6
            or t0_boxes.dim() != 2 or t0_boxes.shape[1] != 6
            or pad_off.numel() != nhosts + 1 or t0_off.numel() != nhosts + 1
            or plan.hosts[0] < 0 or plan.hosts[1] >= nhosts):
        raise ValueError("exchange_paint: boxes i32[nb, 6], box offsets "
                         "i32[H + 1] and sphere hosts in [0, H) expected")
    x0, nx, y0, ny, z0, nz = plan.block
    dev = pad_boxes.device
    out = pad_boxes.new_empty((nhosts, nx, ny, nz), dtype=torch.uint8)
    t = plan.table(dev).data_ptr() if plan.ncols else 0
    err = _paint_entry()(
        t, plan.nrows, t + 4 * PAINT_ROW * plan.nrows, plan.nblocks,
        plan.ncols, plan.c_block, plan.N, pad_boxes.data_ptr(),
        pad_off.data_ptr(), t0_boxes.data_ptr(), t0_off.data_ptr(),
        out.data_ptr(), out.numel(), kernels.stream_ptr(dev))
    kernels.check("exchange_paint", err)
    if plan.ncols:
        kernels.LAUNCHES["exchange_paint"] += 1
    return out


_PAINT = None


def _paint_entry():
    """K17's C entry point, looked up in the kernel library once."""
    global _PAINT
    if _PAINT is None:
        _PAINT = kernels.lib().exchange_paint
    return _PAINT
