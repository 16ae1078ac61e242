"""The fmax phase over a mesh of devices, in one process or split over a
process group (counterpart of pinocchio_tpu/parallel/driver.py).

delta(k) is generated straight into the decomposition's k layout (K1s,
global draw counters: the single-device field for any mesh); each smoothing
radius is K2s on every shard, one distributed inverse transform and the
collapse update (K3, or K7 with the tabulated and ELL_SNG models) on every
real shard; the R=0 stack feeds the LPT sources (K4 per shard, distributed
transforms, K2s at R=0) and each displacement set is K5s (K8s with
scale-dependent growth) and a distributed inverse transform.  The hand-off
selects and gathers the needed rows on each shard (torch.sort, K6a), copies
each shard's rows to page-locked host memory and merges them on the host
into the sweep's (-F, ascending cell) order; the FmaxPDF histogram is the
sum of the shards' K6b counts.  No device ever holds a whole N^3 field.

Over a mesh split over processes (pfft.mesh_for(procs=)) each process runs
the kernels of its own shards only; the transposes cross processes
(pfft.all_to_all), the means of the collapse cycle, the FmaxPDF counts and
the needed count are sums over the group (multihost.all_sum), and the
hand-off is always deferred: each process keeps its own shards' rows for
the exchange, as the JAX package keeps a multi-process run's segments on
its devices (defer_segments).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..fmax import (FmaxResult, GROWTH_INDEX, DenseProducts, SparseProducts,
                    Smoothing, growth_k_tables,
                    inverse_growth_packs, load_jax_state,
                    prepare_ct_tables, unpack_products)
from ..grids import Grid
from ..handoff import to_host
from ..ic import kdensity_args, kdensity_shard
from ..ops import collapse, compact, lpt
from . import pfft


class RemoteShard:
    """Stands in a list of shards for one that another process of the group
    holds: any use of it raises, naming the collective that reads it."""

    def __init__(self, what: str, i: int, rank: int):
        self._what, self._i, self._rank = what, i, rank

    def __getattr__(self, name):
        raise RuntimeError(
            f"shard {self._i}'s {self._what} is held by process "
            f"{self._rank} of the group: read the whole grid with "
            "products.gather(), a collective that every process calls")

    def __repr__(self):
        return f"RemoteShard({self._what!r}, {self._i}, {self._rank})"


@dataclass
class ShardedProducts:
    """Fmax (float32) and Rmax (int32) as real shards of ``decomp`` (a
    pfft decomposition, or the out-of-core engine's fmax_ooc.OocMesh with
    its x-blocks and no Rmax, where another process's shard is a
    RemoteShard)."""
    decomp: object
    Fmax: list
    Rmax: list

    def gather(self):
        """(Fmax, Rmax) of the whole grid as host numpy arrays (Rmax None
        for the out-of-core engine, which keeps none); over a process group
        a collective, in every process."""
        return (self.decomp.gather(self.Fmax),
                None if self.Rmax is None else self.decomp.gather(self.Rmax))


def build_kdensity(decomp, grid: Grid, cosmo, seed: int,
                   fixed: bool = False, paired: bool = False) -> list:
    """delta(k) generated directly into the decomposition's k layout: one
    K1s launch per shard, each mode at its global draw counter, so the
    realized field is the single-device one for any mesh (the reference's
    seed-plane task-count invariance, GenIC.c:482-1143)."""
    logk, logpk, kp, ka, logkf, fac = kdensity_args(grid, cosmo, seed)
    tables = {}

    def one(i, _):
        dev = decomp.devices[i]
        if dev not in tables:
            tables[dev] = (torch.from_numpy(logk).to(dev),
                           torch.from_numpy(logpk).to(dev))
        return kdensity_shard(grid.N, *tables[dev], kp, ka, logkf, fac,
                              fixed, paired, *decomp.k_window(i))
    return decomp.map(one, decomp.devices)


def _combine(decomp, stats) -> np.ndarray:
    """The mesh's (mean delta, mean delta^2) from each shard's (each a
    float64 tensor [..., 2]), float64 on the host, weighted by the shards'
    cell counts and summed in mesh order: over a process group each
    process's terms cross in one sum over the group, where every other
    process adds zeros to them, so the result is the one-process sum."""
    n = [math.prod(decomp.real_block(i)[1::2]) for i in range(decomp.p)]
    terms = None
    for i in decomp.local:
        t = n[i] * stats[i].cpu().numpy()
        if terms is None:
            terms = np.zeros((decomp.p,) + t.shape, t.dtype)
        terms[i] = t
    terms = group_sum(decomp, "reduce", terms)
    return sum(terms[i] for i in range(decomp.p)) / float(decomp.N) ** 3


def group_sum(decomp, kind: str, arr: np.ndarray) -> np.ndarray:
    """arr summed over the process group of decomp's mesh (arr itself in
    one process)."""
    if decomp.mesh.procs is None:
        return arr
    from .multihost import all_sum
    return all_sum(kind, arr)


def build_fmax_step(decomp):
    """One smoothing radius over the mesh: step(kden, Fmax, Rmax, R_grid,
    ismooth, pack) updates the real shards Fmax and Rmax IN PLACE and
    returns the radius's (mean delta, mean delta^2)."""
    def step(kden, Fmax, Rmax, R_grid, ismooth, pack):
        sd = pfft.distributed_second_derivatives(decomp, kden, R_grid)
        return _combine(decomp, decomp.map(
            lambda i, s, F, R: collapse.collapse_update(s, F, R, ismooth,
                                                        pack),
            sd, Fmax, Rmax))
    return step


def build_displacement_step(decomp):
    """The Zel'dovich displacement shards [3, *block] of delta(k) shards at
    a scalar growth."""
    return lambda kden, growth: pfft.distributed_first_derivatives(
        decomp, kden, growth)


def _radius_cycle(decomp, kden, radii_grid, update):
    """The smoothing-radius cycle (fmax.c:66-150) over the mesh: each
    radius's Hessian shards, then update(i, sd_i, Fmax_i, Rmax_i, ism) on
    every shard under its device, returning the shard's statistics.
    Returns (Fmax, Rmax, stats [nsmooth, 2] float64 numpy, sd) with sd the
    R=0 Hessian shards."""
    Fmax = decomp.map(lambda i, dev: torch.full(
        decomp.real_block(i)[1::2], -10.0, dtype=torch.float32, device=dev),
        decomp.devices)
    Rmax = decomp.map(lambda i, dev: torch.full(
        decomp.real_block(i)[1::2], -1, dtype=torch.int32, device=dev),
        decomp.devices)
    stats = []
    sd = None
    for ism, R in enumerate(radii_grid):
        sd = None                      # free the previous stack first
        sd = pfft.distributed_second_derivatives(decomp, kden, float(R))
        stats.append(decomp.map(
            lambda i, s, F, Rm: update(i, s, F, Rm, ism), sd, Fmax, Rmax))
    # every radius's statistics [nsmooth, 2] of each shard, in one sum
    per_shard = decomp.map(lambda i, _: torch.stack([s[i] for s in stats]),
                           Fmax)
    return Fmax, Rmax, _combine(decomp, per_shard), sd


def build_fmax_loop(decomp, nsmooth: int):
    """The cycle with the classic ellipsoid (K3 per shard):
    loop(kden, radii_grid, packs [nsmooth, 23]) -> (Fmax, Rmax, stats,
    sd)."""
    def loop(kden, radii_grid, packs):
        return _radius_cycle(
            decomp, kden, radii_grid[:nsmooth],
            lambda i, sd, F, R, ism: collapse.collapse_update(
                sd, F, R, ism, packs[ism]))
    return loop


def build_fmax_loop_tab(decomp, nsmooth: int, interp: str = "trilinear"):
    """The cycle with collapse times looked up in the per-radius
    TABULATED_CT / ELL_SNG tables (K7 per shard; the tables are copied to
    each device once): loop(kden, radii_grid, ct) with ct the numpy tables
    of fmax.prepare_ct_tables."""
    def loop(kden, radii_grid, ct):
        on = {dev: load_jax_state({k: ct[k] for k in ("tables", "tables2",
                                                      "dv", "idx_map")},
                                  dev)
              for dev in decomp.mesh.local_devices()}

        def update(i, sd, F, R, ism):
            t = on[decomp.devices[i]]
            return collapse.collapse_update_table(
                sd, F, R, ism, t["tables"][ism], t["tables2"][ism], t["dv"],
                t["idx_map"], float(ct["ampl"][ism]), interp)
        return _radius_cycle(decomp, kden, radii_grid[:nsmooth], update)
    return loop


def distributed_lpt_sources(decomp, sd) -> tuple:
    """2LPT / 3LPT k-space sources from the R=0 Hessian shards: the
    pointwise products per shard (K4), the distributed transforms and the
    2LPT potential's Hessian through K2s at R=0 (LPT.c:32-172).  Returns
    the k shards (kvec2, kvec31, kvec32)."""
    pw = decomp.map(lambda i, s: lpt.sources_pointwise(s), sd)
    kvec2 = decomp.fwd(decomp.map(lambda i, t: t[0], pw))
    phi2 = pfft.distributed_second_derivatives(decomp, kvec2, 0.0)
    src32 = decomp.map(lambda i, ph, s, t: lpt.src32_accumulate(ph, s, t[2]),
                       phi2, sd, pw)
    del phi2
    kvec31 = decomp.fwd(decomp.map(lambda i, t: t[1], pw))
    del pw
    return kvec2, kvec31, decomp.fwd(src32)


def displacement_sources(decomp, kden, sd, order: int) -> dict:
    """The k shards of each displacement field's source, keyed like the
    fields: v2, v31, v32 from the R=0 Hessian shards, and v1 (delta)."""
    src = {}
    if order >= 2:
        kvec2, kvec31, kvec32 = distributed_lpt_sources(decomp, sd)
        src["v2"] = kvec2
        if order >= 3:
            src["v31"] = kvec31
            src["v32"] = kvec32
    src["v1"] = kden
    return src


def build_displacement_stage(decomp, scaledep: bool = False):
    """One displacement set over the mesh: stage(sources, growths) -> key ->
    real shards [3, *block]; growths as fmax.displacement_fields (scalars,
    or the growth_k_tables triple with scaledep: K8s)."""
    def stage(sources, growths):
        out = {}
        for key, kvec in sources.items():
            i = GROWTH_INDEX[key]
            if scaledep:
                gtabs, glo, gdx = growths
                out[key] = pfft.distributed_first_derivatives_tab(
                    decomp, kvec, gtabs[i], glo, gdx)
            else:
                out[key] = pfft.distributed_first_derivatives(
                    decomp, kvec, growths[i])
        return out
    return stage


class ShardedHandoff:
    """The needed particles of every shard (F >= Flast) in the sweep's
    order: ``add_set`` gathers one displacement set's rows on each shard
    (K6a, into one buffer per shard for every set); ``finish`` copies each
    shard's buffer to page-locked host memory and merges the shards on the
    host into the global (-F, ascending cell) order.  Deferred
    (run_fmax_distributed defer_handoff), the buffers stay on their devices
    for the exchange (parallel/exchange.py) and the local fetch
    (parallel/multihost.py) until ``release`` or ``finish``."""

    def __init__(self, decomp, Fmax: list, Flast: float, keys: list,
                 nsets: int):
        self.decomp, self.Fmax, self.keys = decomp, Fmax, list(keys)
        self.nsets = nsets
        # a block of the grid keeps the global C order of its cells, so the
        # stable sort of each shard is the global order restricted to it
        self.idx = decomp.map(lambda i, F: compact.needed_order(F, Flast),
                              Fmax)
        # each local cell's row, built once for every set (freed after the
        # last one)
        self.rank = decomp.map(
            lambda i, F: compact.needed_rank(self.idx[i], F.numel()), Fmax)
        self.counts = [0 if t is None else t.numel() for t in self.idx]
        sizes = [[compact.packed_size(c, len(self.keys), s == 0)
                  for s in range(nsets)] for c in self.counts]
        self.bufs = decomp.map(
            lambda i, F: torch.empty(sum(sizes[i]), dtype=torch.float32,
                                     device=F.device), Fmax)
        self.sizes, self.off, self.nadded = sizes, [0] * decomp.p, 0
        self._by_cell = [None] * decomp.p

    @property
    def channels(self) -> int:
        """Row channels of a buffer: 3 floats each, one per key and set."""
        return len(self.keys) * self.nsets

    def add_set(self, vel: dict) -> None:
        """Gather the needed rows of the next displacement set (key -> real
        shards [3, *block]); the first set also writes the cells and F."""
        s = self.nadded

        def one(i, F):
            a = self.off[i]
            compact.gather_rows(self.idx[i], [vel[k][i] for k in self.keys],
                                self.bufs[i][a:a + self.sizes[i][s]],
                                F=F if s == 0 else None, rank=self.rank[i])
            self.off[i] = a + self.sizes[i][s]
        self.decomp.map(one, self.Fmax)
        self.nadded += 1
        if self.nadded == self.nsets:
            self.rank = None

    def cell_order(self, i: int):
        """Shard i's needed local cells in ascending order and, for each,
        its row in the buffer: (cells int64, perm int64), one torch.sort,
        kept for the next exchange."""
        if self._by_cell[i] is None:
            with kernels.on_device(self.decomp.devices[i]):
                self._by_cell[i] = torch.sort(self.idx[i])
        return self._by_cell[i]

    def shard_products(self, i: int) -> SparseProducts:
        """Shard i's needed rows on the host (one page-locked copy), with
        global cell indices, in the sweep's order."""
        host = to_host(self.bufs[i]).numpy()
        sp = unpack_products(host, self.decomp.N, self.counts[i], self.keys,
                             self.nsets)
        sp.ci = global_cells(self.decomp.real_block(i), self.decomp.N, sp.ci)
        return sp

    def release(self) -> None:
        """Free the device buffers."""
        self.bufs = self.idx = self.rank = None
        self._by_cell = [None] * self.decomp.p

    def finish(self) -> SparseProducts:
        """The merged SparseProducts of every shard; frees the device
        buffers.  Over a mesh split over processes this process holds only
        its own shards' rows, which leave by the exchange: that raises."""
        if self.decomp.mesh.procs is not None:
            raise ValueError("the hand-off of a mesh split over processes "
                             "holds this process's shards only: their rows "
                             "leave by the exchange (parallel/exchange.py) "
                             "or the local fetch of this process's shards")
        parts = [self.shard_products(i) for i in range(self.decomp.p)]
        self.release()
        return merge_parts(parts, self.decomp.N)


def global_cells(block, N: int, loc) -> np.ndarray:
    """The global cell indices (int64 numpy) of the local cells ``loc`` of
    the real block (x0, nx, y0, ny, z0, nz)."""
    x0, _, y0, ny, z0, nz = block
    loc = torch.as_tensor(np.asarray(loc, np.int64))
    ix, iy, iz = loc // (ny * nz), loc // nz % ny, loc % nz
    return (((x0 + ix) * N + y0 + iy) * N + z0 + iz).numpy()


def merge_parts(parts: list, N: int) -> SparseProducts:
    """The union of disjoint SparseProducts (global cells, same keys and
    sets) in the sweep's order.  Each row lands at its merged position
    (one scatter per part and array); torch's host sort and scatters use
    every core."""
    ci = torch.cat([torch.as_tensor(np.asarray(p.ci, np.int64))
                    for p in parts])
    n = ci.numel()
    pos = torch.empty(n, dtype=torch.int64).index_copy_(
        0, merge_order(torch.cat([torch.as_tensor(np.asarray(p.F, np.float32))
                                  for p in parts]), ci, N ** 3),
        torch.arange(n))
    spans = np.cumsum([0] + [len(p.ci) for p in parts])
    nsets = len(parts[0].segments) if parts[0].segments else 1

    def merged(arrays):
        arrays = [torch.as_tensor(a) for a in arrays]
        out = arrays[0].new_empty((n,) + tuple(arrays[0].shape[1:]))
        for a, b, arr in zip(spans[:-1], spans[1:], arrays):
            out.index_copy_(0, pos[a:b], arr)
        return out.numpy()
    keys = sorted(parts[0].vel)
    sets = [{k: merged([(p.segments[s] if p.segments else p.vel)[k]
                        for p in parts]) for k in keys}
            for s in range(nsets)]
    return SparseProducts(N=N, ci=merged([p.ci for p in parts]),
                          F=merged([p.F for p in parts]), vel=sets[0],
                          sorted_by="F", segments=sets if nsets > 1 else None)


def merge_order(F, ci, ncell: int):
    """The permutation (int64 tensor) that puts needed cells (F float32 >=
    Flast >= 1, global cell indices ci int64, host tensors or arrays, of a
    grid of ncell cells) in the sweep's order, descending F with ties by
    ascending cell: one sort of an int64 key, F's bits inverted above the
    cell index, when the index fits in 33 bits (N <= 2048), else
    np.lexsort (about ten times slower at 256^3)."""
    F, ci = torch.as_tensor(F), torch.as_tensor(ci)
    if ncell <= 2 ** 33:
        return torch.sort(merge_key(F, ci)).indices
    return torch.from_numpy(np.lexsort((ci.numpy(), -F.numpy())))


def merge_key(F, ci):
    """The int64 key whose ascending order is the sweep's order of needed
    cells (F float32 > 0, global cell indices ci int64 below 2^33, tensors
    on one device): a positive float's bits order as the float, and
    0x3FFFFFFF - bits lies in [-2^30, 2^30), so the key stays inside
    int64."""
    return (0x3FFFFFFF - F.view(torch.int32).to(torch.int64)) * 2 ** 33 + ci


def sharded_products(decomp, Fmax: list, Flast: float, sets: list):
    """The SparseProducts of Fmax shards and displacement sets (each key ->
    real shards [3, *block]) through the sharded hand-off."""
    keys = sorted(sets[0])
    h = ShardedHandoff(decomp, Fmax, Flast, keys, len(sets))
    for vel in sets:
        h.add_set(vel)
    return h.finish()


def handoff_from_arrays(decomp, Fmax, sets: list,
                        Flast: float) -> ShardedHandoff:
    """A deferred hand-off over ``decomp``'s mesh from whole-grid arrays,
    such as the JAX package's products gathered with np.asarray: Fmax
    [N, N, N] and one dict per displacement set of key -> [3, N, N, N],
    turned into the port's tensors by fmax.load_jax_state and scattered."""
    Fs = decomp.scatter(load_jax_state({"Fmax": Fmax}, "cpu")["Fmax"])
    h = ShardedHandoff(decomp, Fs, Flast, sorted(sets[0]), len(sets))
    for vel in sets:
        h.add_set({k: decomp.scatter(load_jax_state({k: v}, "cpu")[k])
                   for k, v in vel.items()})
    return h


def pdf_hist(decomp, Fmax: list, extra: np.ndarray = None) -> np.ndarray:
    """The FmaxPDF counts: the sum of the shards' K6b histograms (over the
    process group of a split mesh).  extra: int64 counts of this process
    summed with them in the same reduction and returned after the bins."""
    local = [h.cpu().numpy() for h in decomp.map(
        lambda i, F: compact.pdf_hist(F), Fmax) if h is not None]
    hist = sum(local)
    if extra is not None:
        hist = np.concatenate([hist, np.asarray(extra, np.int64)])
    return group_sum(decomp, "reduce", hist)


def _sync(decomp) -> None:
    for dev in decomp.mesh.local_devices():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run_fmax_distributed(params, cosmo, mesh, scaledep_gm=None,
                         verbose: bool = False,
                         keep_dense_products: bool = False,
                         kdensity=None,
                         defer_handoff: bool = False) -> FmaxResult:
    """fmax.run_fmax over a mesh: IC, the smoothing cycle, the LPT stage
    and the hand-off sharded over ``mesh`` (classic or TABULATED_CT /
    ELL_SNG collapse, scale-dependent growth, RECOMPUTE_DISPLACEMENTS
    sets).  Returns the port's FmaxResult with ``products`` a
    ShardedProducts; keep_dense_products (or WriteTimelessSnapshot)
    assembles the whole grid's products on the host (FmaxResult.dense).
    kdensity: an optional complex64 [N, N, N//2+1] field (e.g. the JAX
    package's) scattered over the mesh instead of generating the initial
    conditions.  defer_handoff: keep each shard's needed rows (cells, F and
    the rows of every displacement set) on its device as
    FmaxResult.handoff, with host_products None until a consumer asks (the
    exchange, the local fetch, fmax.ensure_host_products).  The default
    merges at once, as the JAX package's default does (defer_segments):
    the device buffers are freed before the sweep, every caller may read
    host_products directly, and the merge stays inside the ``products``
    timing; deferring pays only where the rows leave by the exchange.  Over
    a mesh split over processes the hand-off is always deferred, and
    keep_dense_products gathers the whole grid into every process."""
    grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
    N = grid.N
    decomp = pfft.make_decomp(mesh, N)
    defer_handoff = defer_handoff or mesh.procs is not None
    sm = Smoothing.build(params, cosmo)
    timings = {}

    t0 = time.perf_counter()
    if kdensity is None:
        kden = build_kdensity(decomp, grid, cosmo, params.RandomSeed,
                              fixed=params.FixedIC, paired=params.PairedIC)
    else:
        kden = decomp.scatter(kdensity, kspace=True)
    _sync(decomp)
    timings["dens"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    radii_grid = (sm.radii / grid.CellSize).astype(np.float32)
    if params.ell_model != "classic":
        ct = prepare_ct_tables(params, cosmo, sm, verbose=verbose)
        timings["ct_tables"] = time.perf_counter() - t0
        loop = build_fmax_loop_tab(decomp, sm.n, interp=params.ct_interp)
        Fmax, Rmax, stats, sd = loop(kden, radii_grid, ct)
    else:
        packs = inverse_growth_packs(cosmo, sm, scaledep_gm)
        Fmax, Rmax, stats, sd = build_fmax_loop(decomp, sm.n)(
            kden, radii_grid, packs)
    sm.true_variance[:] = stats[:, 1]
    timings["fmax_loop"] = time.perf_counter() - t0
    if verbose:
        for ism in range(sm.n):
            print(f"  smoothing {ism + 1}/{sm.n}: R={sm.radii[ism]:9.5f} "
                  f"expected sigma {math.sqrt(sm.variance[ism]):7.4f} "
                  f"computed "
                  f"{math.sqrt(max(sm.true_variance[ism], 0.0)):7.4f}")

    # displacements at R=0: one set at zlast, or one per output redshift
    # under RECOMPUTE_DISPLACEMENTS (as fmax.run_fmax)
    t0 = time.perf_counter()
    zs = (list(params.output_z) if params.recompute_displacements
          else [params.zlast])
    scaledep = bool(getattr(cosmo, "scale_dep", False))

    def growths_at(z):
        if scaledep:
            return growth_k_tables(cosmo, z, N, "cpu")
        return (float(cosmo.GrowingMode(z)),
                float(cosmo.GrowingMode_2LPT(z)),
                float(cosmo.GrowingMode_3LPT_1(z)),
                float(cosmo.GrowingMode_3LPT_2(z)))

    keep_dense = keep_dense_products or params.WriteTimelessSnapshot
    sources = displacement_sources(decomp, kden, sd, params.lpt_order)
    del sd
    t_sources = time.perf_counter() - t0
    t0 = time.perf_counter()
    handoff = ShardedHandoff(decomp, Fmax, params.Flast, sorted(sources),
                             len(zs))
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage = build_displacement_stage(decomp, scaledep)
    dense_vel = {}
    for s, z in enumerate(zs):
        vel = stage(sources, growths_at(z))
        handoff.add_set(vel)
        if keep_dense and s == 0:
            dense_vel = {k: decomp.gather(v) for k, v in vel.items()}
        del vel
    del sources
    _sync(decomp)
    timings["lpt"] = t_sources + time.perf_counter() - t0

    t0 = time.perf_counter()
    sp = None if defer_handoff else handoff.finish()
    hist = pdf_hist(decomp, Fmax, extra=[sum(handoff.counts)])
    hist, count = hist[:-1], int(hist[-1])
    dense = None
    if keep_dense:
        dense = DenseProducts(Fmax=decomp.gather(Fmax),
                              Rmax=decomp.gather(Rmax), vel=dense_vel)
    timings["products"] = t_sort + time.perf_counter() - t0
    if verbose:
        print(f"  products: {count}/{N ** 3} needed particles "
              f"({100.0 * count / N ** 3:.1f}%) from {decomp.p} shards, "
              f"{len(zs)} displacement set(s)")
    return FmaxResult(products=ShardedProducts(decomp, Fmax, Rmax),
                      smoothing=sm, grid=grid, host_products=sp,
                      pdf_hist=hist, timings=timings, dense=dense,
                      handoff=handoff if defer_handoff else None)


def demo_step(mesh, N: int = 32, seed: int = 1):
    """One smoothing radius and one displacement field over ``mesh`` on a
    random field (numpy draws from ``seed``): (Fmax, Rmax, displacement)
    shards; the same step on any mesh gives the same physics."""
    decomp = pfft.make_decomp(mesh, N)
    Nh = N // 2 + 1
    rng = np.random.default_rng(seed)
    field = (rng.standard_normal((N, N, Nh))
             + 1j * rng.standard_normal((N, N, Nh))).astype(np.complex64)
    kden = decomp.scatter(field, kspace=True)
    Fmax = decomp.scatter(np.full((N, N, N), -10.0, np.float32))
    Rmax = decomp.scatter(np.full((N, N, N), -1, np.int32))
    la = np.linspace(-8.0, 1.0, 256)
    pack = collapse.fit_inverse_growth(la, la)
    build_fmax_step(decomp)(kden, Fmax, Rmax, 2.0, 0, pack)
    disp = build_displacement_step(decomp)(kden, 1.0)
    return Fmax, Rmax, disp


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The multi-device fmax phase (run_fmax_distributed: sharded IC, the
    smoothing cycle with its distributed transforms, the LPT stage and the
    hand-off) on a small in-code configuration (the HMF_Validation
    switches at the smallest grid from 32 that every mesh dimension
    divides) over an n-device mesh, pencil when n factors (n >= 4 and
    even), else slab, and over a volumes mesh too when n = 8, each held to
    the single-device run_fmax on the first device: at most max(30,
    N^3/10^4) cells with |dF| > 0.1, the cells with F >= 1 within max(5,
    1/1000), and the displacement rows of the needed cells both runs share
    within 1e-4 of the largest (the counterpart of the JAX package's
    __graft_entry__.dryrun_multichip; devices as pfft.make_mesh's, default
    cuda:0..n-1).  Raises AssertionError on a disagreement."""
    from ..config import Params
    from ..cosmology import Cosmology
    from ..fmax import run_fmax
    meshes = [pfft.make_pencil_mesh(n_devices, devices=devices)
              if n_devices >= 4 and n_devices % 2 == 0
              else pfft.make_mesh(n_devices, devices)]
    if n_devices == 8:
        meshes.append(pfft.make_volume_mesh(8, devices=devices))
    lcm = math.lcm(*(d for m in meshes for d in m.devices.shape))
    N = -(-32 // lcm) * lcm
    params = Params(GridSize=N, BoxSize=float(N),
                    output_z=[2.0, 1.0, 0.5, 0.0], norad=True,
                    plc_enabled=False)
    cosmo = Cosmology(params)
    one = run_fmax(params, cosmo, meshes[0].device_list()[0])
    one.pending_fetch.join()
    F1 = one.products.Fmax.cpu().numpy()
    sp1 = one.host_products
    for mesh in meshes:
        res = run_fmax_distributed(params, cosmo, mesh)
        F, _ = res.products.gather()
        nflip = int((np.abs(F - F1) > 0.1).sum())
        _agree(nflip < max(30, N ** 3 // 10000),
               f"{mesh.shape}: {nflip} collapse flips")
        c1, c = int((F1 >= 1.0).sum()), int((F >= 1.0).sum())
        _agree(abs(c - c1) <= max(5, c1 // 1000),
               f"{mesh.shape}: {c} cells with F >= 1 against {c1}")
        sp = res.host_products
        _, ia, ib = np.intersect1d(sp.ci, sp1.ci, return_indices=True)
        _agree(len(ia) > 0.999 * len(sp1.ci),
               f"{mesh.shape}: {len(ia)} of {len(sp1.ci)} needed cells")
        for key, rows in sp1.vel.items():
            a, b = np.asarray(sp.vel[key])[ia], np.asarray(rows)[ib]
            _agree(np.abs(a - b).max() < 1e-4 * max(np.abs(b).max(), 1e-3),
                   f"{mesh.shape}: {key} rows differ")


def _agree(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
