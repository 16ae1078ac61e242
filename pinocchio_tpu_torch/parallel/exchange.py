"""Cross-host product exchange over a mesh of devices, in one process or
split over a process group (counterpart of
pinocchio_tpu/parallel/exchange.py).

The analog of the reference's hypercube exchange (distribute.c:58-175).
After the fmax phase each shard's needed rows sit in its deferred hand-off
buffer (parallel.driver.ShardedHandoff); the fragmentation sub-boxes are
owned by hosts (parallel/multihost.py), and a sub-box's padded volume
generally spans shards held by other hosts' devices.  One exchange:

  1. count (K15): on every source shard, which hosts' regions hold each
     needed row, visited in ascending cell order, and the members per
     (thread block, host); one small copy of the counts to the host sizes
     every segment exactly;
  2. pack (K16): each member row (its local cell, F and 3 floats per key
     and displacement set, RECOMPUTE sets included) goes round-robin over
     the destination host's devices, devs[i % nd] slot i // nd for the
     member of rank i, into one segment per destination device, laid out
     as a hand-off buffer;
  3. route: each (source shard, destination device) segment is copied with
     .to(device, non_blocking=True) and the destination concatenates them
     in source order (on one card, device-local copies);
  4. extract: each destination device's rows go to page-locked host memory
     and merge per host into the sweep's order, descending F with ties by
     ascending cell (parallel.driver.merge_order).

Over a mesh split over processes (one process per host) each process counts
and packs its own shards, the segment counts of every source come from one
sum over the group, the route sends each process's segments to each
destination process in one staged all_to_all, and each process extracts its
own devices' rows: its host's products.  In one process every mocked
host's products come back, as in the JAX package.  A cell needed by two
hosts goes to both; within one host it goes once, since membership is a
union over the host's boxes.  The wire is
float32, as the hand-off is.  Slab and pencil meshes only: on a volumes
mesh the JAX package's exchange fails (its _shard_coords and _route fall
through to the slab branch and ask for the mesh axis 'x'), and this one
raises NotImplementedError.

Regions: host h owns the sub-boxes geoms[h::H] and needs each one's whole
padded volume (single turn), or only its well-resolved region and a 1-cell
rim per non-periodic dimension (turn 0), or (turn 1) the cells of its
boundary spheres (K17's request maps) inside its padded volumes and outside
its turn-0 regions.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..fmax import SparseProducts, unpack_products
from ..handoff import to_host
from ..ops import exchange as ops
from . import pfft
from .driver import _sync, global_cells, group_sum, merge_parts

VOLUMES_GAP = ("the exchange over a volumes mesh is not supported: the JAX "
               "package's exchange handles slab and pencil meshes only "
               "(ROADMAP.md, item 13)")


def build_host_regions(geoms, nhosts: int, N: int,
                       turn0: bool = False) -> tuple:
    """Per host, the boxes ((x0, Lx), (y0, Ly), (z0, Lz)) of its sub-boxes
    geoms[h::nhosts]: each one's whole padded volume [stabl, stabl + L)
    wrapped mod N (initialization.c:1011-1057), or with turn0 the
    well-resolved region plus a 1-cell rim per non-periodic dimension
    (create_map, fragment.c:708-751; fragment.subbox.turn0_bounds)."""
    regions = []
    for h in range(nhosts):
        boxes = []
        for g in geoms[h::nhosts]:
            box = []
            for d in range(3):
                if turn0 and not g.pbc[d]:
                    lo = max(0, int(g.safe[d]) - 1)
                    hi = min(int(g.L[d]), int(g.L[d]) - int(g.safe[d]) + 1)
                    box.append(((int(g.stabl[d]) + lo) % N, hi - lo))
                else:
                    box.append((int(g.stabl[d]) % N, int(g.L[d])))
            boxes.append(tuple(box))
        regions.append(tuple(boxes))
    return tuple(regions)


def region_tables(regions, device):
    """The kernels' box tables of build_host_regions' output: (boxes int32
    [nb, 6] of rows x0, Lx, y0, Ly, z0, Lz; box_off int32 [H + 1]) on
    ``device``."""
    rows = [[c for dim in box for c in dim] for host in regions
            for box in host]
    off = np.cumsum([0] + [len(host) for host in regions])
    boxes = torch.tensor(rows, dtype=torch.int32).reshape(-1, 6)
    return (boxes.to(device),
            torch.tensor(off, dtype=torch.int32).to(device))


def host_of_device_default(mesh, nhosts: int) -> tuple:
    """Mesh position -> host: an H-host cluster as contiguous blocks of the
    flat device order (pfft.host_blocks; the block of each process of a
    mesh split over processes), of equal size when H divides the mesh (the
    exchange needs that; the snapshot chunks and dumps take any count)."""
    return pfft.host_blocks(mesh.size, nhosts)


def _check_decomp(decomp) -> None:
    if isinstance(decomp, pfft.VolumeDecomp):
        raise NotImplementedError(VOLUMES_GAP)


def build_turn1_maps(spheres: Dict[int, np.ndarray], geoms, nhosts: int,
                     N: int, decomp) -> list:
    """The turn-1 request maps, one uint8 [H, nx, ny, nz] tensor per real
    shard of ``decomp`` on its device (K17 per shard): host h's boundary
    spheres ({host: [ns, 4] float32 of global cx, cy, cz and the radius in
    cells}) painted over its padded volumes, outside its turn-0 regions
    (update_map, build_groups.c:2246-2318).  The maps never exist whole."""
    _check_decomp(decomp)
    pad = build_host_regions(geoms, nhosts, N)
    t0 = build_host_regions(geoms, nhosts, N, turn0=True)
    hosts = [h for h in range(nhosts)
             if spheres.get(h) is not None and len(spheres[h])]
    sph = (np.concatenate([np.asarray(spheres[h], np.float32)
                           for h in hosts]) if hosts
           else np.zeros((0, 4), np.float32))
    owner = np.concatenate([np.full(len(spheres[h]), h, np.int32)
                            for h in hosts] or [np.zeros(0, np.int32)])
    balls = ops.PaintSpheres(sph, owner, N)
    tables = {}

    def one(i, dev):
        if dev not in tables:
            tables[dev] = (*region_tables(pad, dev), *region_tables(t0, dev))
        return ops.paint(balls.plan(decomp.real_block(i)), *tables[dev],
                         nhosts)
    return decomp.map(one, decomp.devices)


def _segment_rows(total: int, nd: int) -> list:
    """Rows of each of a host's nd devices when its members are dealt
    round-robin: device j takes ranks j, j + nd, ..."""
    return [max(0, -(-(total - j) // nd)) for j in range(nd)]


def exchange_products(fmax_result, geoms, nhosts: int, turn: int = None,
                      spheres: Dict[int, np.ndarray] = None,
                      hosts=None, verbose: bool = False,
                      stats: dict = None) -> Dict[int, SparseProducts]:
    """Run the exchange over the mesh of the deferred hand-off of
    ``fmax_result`` (a mesh run with defer_handoff; its buffers stay for the
    next exchange), host h owning the sub-boxes geoms[h::nhosts] and the
    mesh positions host_of_device_default gives it, and return
    {host: SparseProducts} for every host of ``hosts`` (default: all), in
    the sweep's order, with one row set per displacement set (RECOMPUTE
    segments).  Every shard counts and packs for every host, as each source
    host does; only the devices of ``hosts`` receive and extract, as a host
    receives its own rows and not the others'.  Over a mesh split over
    processes every process of the group takes part, nhosts is the group's
    size, and each process receives its own host's products only (hosts
    None or its own rank).

    turn selects the V5 two-turn wire protocol (fragment.c:159-316): None
    ships the whole padded volumes; 0 only each host's well-resolved
    regions and 1-cell rim; 1 the cells of ``spheres`` ({host: [ns, 4]
    global cx, cy, cz, r}; every host's, across processes) inside the
    padded volumes and outside the turn-0 regions.  stats, when given,
    receives the phases' seconds (count, pack, route, extract), the routed
    wire bytes and rows, each destination device's rows (every host's), and
    the bytes and seconds of the exchange's collectives over the group
    (group_bytes, group_s; 0 in one process)."""
    handoff = fmax_result.handoff
    if handoff is None or handoff.bufs is None:
        raise ValueError("the exchange needs a mesh run's deferred hand-off "
                         "(run_fmax_distributed(defer_handoff=True))")
    decomp = handoff.decomp
    _check_decomp(decomp)
    mesh = decomp.mesh
    N, p = decomp.N, decomp.p
    host_of_device = host_of_device_default(mesh, nhosts)
    host_devs = [[i for i in range(p) if host_of_device[i] == h]
                 for h in range(nhosts)]
    want = range(nhosts) if hosts is None else sorted(set(hosts))
    if mesh.procs is not None:
        rank, nproc = mesh.procs
        if nhosts != nproc or set(want) - {rank}:
            raise ValueError(f"over a mesh split over {nproc} processes the "
                             f"exchange runs for {nproc} hosts and process "
                             f"{rank} receives its own rows, not hosts "
                             f"{list(want)} of {nhosts}")
        want = [rank]
    routed = sorted(q for h in want for q in host_devs[h])
    ndmax = max(len(d) for d in host_devs)
    nch = handoff.channels
    rowf = 2 + 3 * nch
    traffic = _traffic(mesh)
    t_start = time.perf_counter()

    # ---- 1. count (K15) on every shard, then one copy of the totals
    maps = None
    if turn == 1:
        maps = build_turn1_maps(spheres or {}, geoms, nhosts, N, decomp)
    regions = build_host_regions(geoms, nhosts, N, turn0=(turn == 0))
    tables = {}
    for dev in mesh.local_devices():
        nd_t = torch.tensor([len(d) for d in host_devs], dtype=torch.int32)
        devs_t = torch.tensor([d + [0] * (ndmax - len(d)) for d in host_devs],
                              dtype=torch.int32)
        tables[dev] = (*region_tables(regions, dev), nd_t.to(dev),
                       devs_t.to(dev))

    def count_one(i, dev):
        cells, _ = handoff.cell_order(i)
        boxes, box_off = tables[dev][:2]
        bits, counts = ops.count(cells, decomp.real_block(i), N, boxes,
                                 box_off, nhosts,
                                 hmap=maps[i] if maps is not None else None)
        block_off = torch.cumsum(counts, 0, dtype=torch.int64) - counts
        return bits, block_off, counts.sum(0, dtype=torch.int64)
    counted = decomp.map(count_one, decomp.devices)
    totals = np.zeros((p, nhosts), np.int64)              # [p, H]
    for i in decomp.local:
        totals[i] = counted[i][2].cpu().numpy()
    # the other processes' sources: one sum over the group
    totals = group_sum(decomp, "route", totals)
    del maps
    t_count = time.perf_counter() - t_start

    # ---- 2. pack (K16): exact segments, destination by destination
    t0 = time.perf_counter()
    seg_n = np.zeros((p, p), np.int64)             # [source, destination]
    for s in range(p):
        for h in range(nhosts):
            for j, n in enumerate(_segment_rows(int(totals[s, h]),
                                                len(host_devs[h]))):
                seg_n[s, host_devs[h][j]] = n
    seg_base = np.zeros((p, p), np.int64)
    seg_base[:, 1:] = np.cumsum(seg_n * rowf, axis=1)[:, :-1]

    def pack_one(i, dev):
        bits, block_off, _ = counted[i]
        _, perm = handoff.cell_order(i)
        _, _, nd_t, devs_t = tables[dev]
        out = torch.empty(int(seg_n[i].sum()) * rowf, dtype=torch.float32,
                          device=dev)
        ops.pack(perm, handoff.bufs[i], handoff.counts[i], bits, block_off,
                 nd_t, devs_t, torch.from_numpy(seg_base[i]).to(dev),
                 torch.from_numpy(seg_n[i]).to(dev), nch, out)
        return out
    packed = decomp.map(pack_one, decomp.devices)
    del counted
    _sync(decomp)
    t_pack = time.perf_counter() - t0

    # ---- 3. route: each wanted destination concatenates its segments in
    # source order on its own device; across processes the segments of
    # other processes' sources, and for other processes' destinations, go
    # in one staged all_to_all of the group
    t0 = time.perf_counter()

    def segment(s, q):
        return packed[s][seg_base[s, q]:seg_base[s, q] + seg_n[s, q] * rowf]
    got = {}
    if mesh.procs is not None:
        from .multihost import all_to_all_staged
        own = mesh.owner
        send, recv = {}, {}
        for q in range(p):
            for s in decomp.local:
                if own(q) != rank:
                    send.setdefault(own(q), []).append(segment(s, q))
        for q in routed:
            for s in range(p):
                if own(s) != rank:
                    recv.setdefault(own(s), []).append(
                        ((int(seg_n[s, q] * rowf),), decomp.devices[q]))
        got = {r: iter(v) for r, v in all_to_all_staged(
            "route", send, recv, torch.float32).items()}
    recv_rows = [None] * p
    for q in routed:
        dev = decomp.devices[q]
        pieces = [segment(s, q).to(dev, non_blocking=True)
                  if mesh.local(s) else next(got[mesh.owner(s)])
                  for s in range(p)]
        recv_rows[q] = torch.cat(pieces)
    del packed
    _sync(decomp)
    t_route = time.perf_counter() - t0

    # ---- 4. extract per host into the sweep's order
    t0 = time.perf_counter()
    out: Dict[int, SparseProducts] = {}
    for h in want:
        parts = []
        for q in host_devs[h]:
            host = to_host(recv_rows[q]).numpy()
            recv_rows[q] = None
            off = 0
            for s in range(p):
                n = int(seg_n[s, q])
                if n:
                    sp = unpack_products(host[off:off + n * rowf], N, n,
                                         handoff.keys, handoff.nsets)
                    sp.ci = global_cells(decomp.real_block(s), N, sp.ci)
                    parts.append(sp)
                off += n * rowf
        if not parts:
            parts = [unpack_products(np.zeros(0, np.float32), N, 0,
                                     handoff.keys, handoff.nsets)]
        out[h] = merge_parts(parts, N)
    t_extract = time.perf_counter() - t0
    rows = int(seg_n[:, routed].sum())
    group = traffic()
    if stats is not None:
        stats.update(count=t_count, pack=t_pack, route=t_route,
                     extract=t_extract, rows=rows,
                     wire_bytes=4 * rows * rowf,
                     device_rows=seg_n.sum(0).tolist(),
                     group_bytes=group[0], group_s=group[1])
    if verbose:
        lab = "" if turn is None else f" turn {turn}:"
        print(f"  exchange:{lab} {rows} particle-copies ({4 * rows * rowf} "
              f"wire bytes) to {len(routed)} of {p} devices of {nhosts} "
              f"hosts in "
              f"{time.perf_counter() - t_start:.3f} s (count {t_count:.3f}, "
              f"pack {t_pack:.3f}, route {t_route:.3f}, extract "
              f"{t_extract:.3f})"
              + (f"; {group[0]} bytes through the process group in "
                 f"{group[1]:.3f} s" if mesh.procs is not None else ""))
    return out


def _traffic(mesh):
    """A function returning the route's (bytes, seconds) through the
    process group since this call ((0, 0.0) in one process)."""
    if mesh.procs is None:
        return lambda: (0, 0.0)
    from .multihost import TRAFFIC
    b0, s0 = TRAFFIC["route"]["bytes"], TRAFFIC["route"]["seconds"]
    return lambda: (TRAFFIC["route"]["bytes"] - b0,
                    TRAFFIC["route"]["seconds"] - s0)


def merge_sparse(a: SparseProducts, b: SparseProducts) -> SparseProducts:
    """The union of two disjoint SparseProducts (turn 0 and turn 1) in the
    sweep's order."""
    if b is None or len(b.ci) == 0:
        return a
    if len(a.ci) == 0:
        return b
    return merge_parts([a, b], a.N)
