"""The fmax stage: collapse times and LPT displacements on the device
(counterpart of pinocchio_tpu/fmax.py, dense single-device engine).

For each radius of the variance ladder, the 6 smoothed second derivatives
(K2 + one batched c2r) feed the collapse update, which keeps each cell's
earliest collapse time in Fmax: the classic ellipsoid solve (K3), or, with
ell_model 'tabulated' or 'sng', a lookup in the radius's collapse-time table
(K7).  The last radius is R=0, and its Hessian stack feeds the LPT sources
(K4) and the four displacement fields (K5, or K8 with scale-dependent
growth, + c2r).  The needed particles (Fmax >= Flast) are sorted on the
device in the sweep's (-F, cell) order; their rows of every displacement
set (one set, or one per output redshift with RECOMPUTE_DISPLACEMENTS) are
gathered into one packed buffer (K6a) and handed to the host with the
FmaxPDF histogram (K6b).  The hand-off overlaps the device's work
(handoff.PendingFetch): the histogram is binned and the sort's int64 cell
indices cross before LPT, and each set's rows cross to page-locked memory
on a copy stream of their own, in N_CHUNKS prefix chunks per table, as
soon as K6a has gathered them; a waiter thread advances the rows_ready
watermark that the C sweep starts on (handoff.StreamState, StreamingVel).
With keep_dense_products (the timeless snapshot, special mode 3, a dense
dump) Fmax, Rmax and each [3, N, N, N] stack of the first displacement set
are also copied whole to the host.

The 3-D transforms go through the port's cuFFT plans on a card
(``grids``); ``timings["fft_direct"]`` and ``["fft_torch"]`` count this
call's by route.

Each layer of a call opens a span of torch.profiler.record_function, on
the profiler's clock: fmax.ic, fmax.cycle, fmax.sort, fmax.lpt,
handoff.alloc (each page-locked buffer of the hand-off) and
handoff.finish.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .config import Params
from .cosmology import Cosmology

from .grids import FFT_COUNTS, Grid
from .handoff import (N_CHUNKS, EventTimer, PendingFetch, chunk_bounds,
                      thread_alloc_seconds, to_host)
from .ic import generate_kdensity
from .ops import collapse, compact, derivatives, lpt, tabulated
from .ops.compact import PDF_BINS

NSIGMA = 6.0
STEP_VAR = 0.3          # spacing of the variance ladder (pinocchio.h:69)
# growth-factor index of each displacement field (D1, D2, D31, D32)
GROWTH_INDEX = {"v1": 0, "v2": 1, "v31": 2, "v32": 3}


@dataclass
class Smoothing:
    """The smoothing-radius ladder (set_smoothing, initialization.c:386-435).

    Radii in true Mpc; variances from the Gaussian-window linear variance.
    """
    radii: np.ndarray
    variance: np.ndarray
    true_variance: np.ndarray = None

    @property
    def n(self) -> int:
        return len(self.radii)

    @classmethod
    def build(cls, params: Params, cosmo: Cosmology) -> "Smoothing":
        D = float(cosmo.GrowingMode(params.zlast, params.k_for_GM))
        var_min = (1.686 / NSIGMA / D) ** 2
        rmin = params.InterPartDist / 6.0
        var_max = float(cosmo.var_gauss.MassVariance(rmin))
        nsmooth = int((math.log10(var_max) - math.log10(var_min))
                      / STEP_VAR + 2)
        if nsmooth <= 0:
            nsmooth = 1
        radii = np.zeros(nsmooth)
        variance = np.zeros(nsmooth)
        for i in range(nsmooth - 1):
            variance[i] = 10.0 ** (math.log10(var_min) + STEP_VAR * i)
            radii[i] = cosmo.var_gauss.Radius(variance[i])
        radii[-1] = 0.0
        variance[-1] = var_max
        return cls(radii=radii, variance=variance,
                   true_variance=np.zeros(nsmooth))


@dataclass
class Products:
    """Per-cell fmax outputs kept on the device, [N, N, N]; C-order
    flattening is the reference's particle index (z fastest)."""
    Fmax: torch.Tensor
    Rmax: torch.Tensor


@dataclass
class SparseProducts:
    """Host products of the needed particles only (Fmax >= Flast), rows in
    the sweep's order: descending F, ties by ascending cell index."""
    N: int
    ci: np.ndarray                     # global cell index, int64
    F: np.ndarray                      # float32 per needed particle
    vel: Dict[str, np.ndarray]         # key -> [n, 3] float32
    sorted_by: str = "F"
    # RECOMPUTE_DISPLACEMENTS: one displacement set per output redshift,
    # rows aligned with vel (segments[0] is vel itself); None otherwise
    segments: List[Dict[str, np.ndarray]] = None


@dataclass
class DenseProducts:
    """Host copies of the whole grid's products, C order (the timeless
    snapshot, special mode 3 and a dense dump read them): Fmax [N, N, N]
    float32, Rmax [N, N, N] int32 and the first displacement set's
    [3, N, N, N] float32 stacks."""
    Fmax: np.ndarray
    Rmax: np.ndarray
    vel: Dict[str, np.ndarray]


@dataclass
class FmaxResult:
    products: Products
    smoothing: Smoothing
    grid: Grid
    host_products: SparseProducts
    pdf_hist: np.ndarray               # FmaxPDF counts, PDF_BINS bins
    # seconds of each phase (dens, fmax_loop, lpt, products, ... and the
    # out-of-core engine's phases) and the hand-off's times
    # (handoff.PendingFetch: handoff_return and handoff_alloc_s at the
    # return, the rest after its join).  The dense engine's lpt on a card
    # is the device's time between two CUDA events, present after the
    # join; else a synced host time
    timings: Dict[str, float] = field(default_factory=dict)
    # peak device bytes per phase (the out-of-core engine's trace_memory)
    peaks: Dict[str, int] = field(default_factory=dict)
    # with keep_dense_products; None otherwise
    dense: DenseProducts = None
    # a mesh run's deferred hand-off (parallel.driver.ShardedHandoff, each
    # shard's needed rows still on its device): host_products stays None
    # until ensure_host_products, the exchange or the local fetch reads it
    handoff: object = None
    # either engine's hand-off in flight (handoff.PendingFetch): its rows
    # are still landing behind the watermark; join() it after
    # fragmentation
    pending_fetch: object = None

    @property
    def ooc_pending(self):
        """pending_fetch, under the name the benchmark harness reads."""
        return self.pending_fetch


def ensure_host_products(fmax_result: FmaxResult) -> SparseProducts:
    """fmax_result.host_products, merged from a deferred hand-off on first
    use (which then frees the hand-off's device buffers)."""
    if fmax_result.host_products is None and fmax_result.handoff is not None:
        fmax_result.host_products = fmax_result.handoff.finish()
        fmax_result.handoff = None
    return fmax_result.host_products


def inverse_growth_packs(cosmo: Cosmology, sm: Smoothing,
                         scaledep_gm=None) -> np.ndarray:
    """Per-radius inverse-growing-mode polynomial fits [nsmooth, 23]: one
    fit repeated, or with scale-dependent growth the inverse of each
    radius's smoothed-density growth (InverseGrowingMode,
    cosmo.c:1822-1832)."""
    if scaledep_gm is not None:
        return np.stack([collapse.fit_inverse_growth(
            scaledep_gm.invgrow_logD[i], scaledep_gm.loga_grid)
            for i in range(sm.n)])
    return np.tile(collapse.make_inverse_growth_fit(cosmo)[None, :],
                   (sm.n, 1))


_STATE_DTYPES = dict(
    kdensity=np.complex64, Fmax=np.float32, Rmax=np.int32, v1=np.float32,
    v2=np.float32, v31=np.float32, v32=np.float32, packs=np.float32,
    tables=np.float32, tables2=np.float32, dv=np.float32,
    idx_map=np.int32, ampl=np.float32, gtabs=np.float32, glo=np.float32,
    gdx=np.float32)


def load_jax_state(arrays: dict, device) -> dict:
    """The JAX package's arrays (numpy, as fetched with np.asarray from a
    JAX FmaxResult, ic.generate_kdensity, prepare_ct_tables or
    growth_k_tables), or the port's own numpy arrays of the same names, as
    the port's tensors on ``device``: kdensity complex64; Fmax float32;
    Rmax int32; v1/v2/v31/v32 float32 [3, N, N, N]; packs float32
    [nsmooth, 23]; the CT tables and tables2 float32 [nsmooth, NXY, NXY,
    ND], dv float32 [ND], idx_map int32 [AUX_N], ampl float32 [nsmooth];
    the growth tables gtabs float32 [4, ntab] with the float32 scalars glo
    and gdx."""
    out = {}
    for k, v in arrays.items():
        if k not in _STATE_DTYPES:
            raise KeyError(f"load_jax_state: unknown array {k!r}")
        arr = np.array(v, _STATE_DTYPES[k], order="C", copy=True)
        out[k] = torch.from_numpy(arr).to(device)
    return out


def _radius_cycle(kdensity, radii_grid: np.ndarray, N: int, update):
    """The smoothing-radius cycle (fmax.c:66-150) as a host loop over radii:
    the Hessian stack of each radius, then update(sd, Fmax, Rmax, ism),
    which updates Fmax and Rmax in place and returns the radius's
    statistics.  Returns (Fmax, Rmax, stats [nsmooth, 2] float64 device
    tensor of (mean delta, mean delta^2), sd) with sd the last radius's
    (R=0) Hessian stack."""
    dev = kdensity.device
    Fmax = torch.full((N, N, N), -10.0, dtype=torch.float32, device=dev)
    Rmax = torch.full((N, N, N), -1, dtype=torch.int32, device=dev)
    stats = []
    sd = None
    for ism, R in enumerate(radii_grid):
        sd = None                      # free the previous stack first
        sd = derivatives.second_derivatives(kdensity, float(R), N)
        stats.append(update(sd, Fmax, Rmax, ism))
    return Fmax, Rmax, torch.stack(stats), sd


def fmax_loop(kdensity, radii_grid: np.ndarray, packs: np.ndarray, N: int):
    """The cycle with the classic ellipsoid (K3); packs [nsmooth, 23] the
    per-radius inverse-growth fits.  Returns as _radius_cycle."""
    return _radius_cycle(
        kdensity, radii_grid, N, lambda sd, Fmax, Rmax, ism:
        collapse.collapse_update(sd, Fmax, Rmax, ism, packs[ism]))


def fmax_loop_tab(kdensity, radii_grid: np.ndarray, ct: dict, N: int,
                  interp: str = "trilinear"):
    """The cycle with collapse times looked up in the per-radius
    TABULATED_CT / ELL_SNG tables (interpolate_collapse_time,
    collapse_times.c:1139-1231; K7) in the variant ``interp``.  ct: tables
    [nsmooth, NXY, NXY, ND], tables2 (their delta-spline second
    derivatives; needed by the spline variants), dv and idx_map as tensors
    on kdensity's device (load_jax_state), ampl [nsmooth].  Returns as
    _radius_cycle."""
    tables2 = ct.get("tables2")
    if tables2 is None and interp != "trilinear":
        # zero second derivatives would silently degrade the delta splines
        # to piecewise-linear
        raise ValueError(f"interp={interp!r} needs the spline "
                         "second-derivative tables: pass ct['tables2'] "
                         "(prepare_ct_tables provides them)")
    return _radius_cycle(
        kdensity, radii_grid, N, lambda sd, Fmax, Rmax, ism:
        collapse.collapse_update_table(
            sd, Fmax, Rmax, ism, ct["tables"][ism],
            None if tables2 is None else tables2[ism], ct["dv"],
            ct["idx_map"], float(ct["ampl"][ism]), interp))


def prepare_ct_tables(params: Params, cosmo: Cosmology, sm: Smoothing,
                      verbose: bool = True) -> dict:
    """Per-radius TABULATED_CT / ELL_SNG collapse tables (numpy, see
    tabulated.build_ct_tables_all): read from CTtableFile when it is there
    and its header fits this run (collapse_times.c:1235-1345), else built
    and, with a CTtableFile set, written there."""
    model = "sng" if params.ell_model == "sng" else "classic"
    cached = params.CTtableFile not in ("none", "")
    if cached:
        try:
            tabs = tabulated.read_ct_table_file(params.CTtableFile, params,
                                                sm)
        except (OSError, ValueError):
            tabs = None
        if tabs is not None:
            dv64 = tabulated.delta_sampling()
            dv = dv64.astype(np.float32)
            if verbose:
                print(f"  collapse tables read from {params.CTtableFile}")
            return dict(tables=tabs, tables2=tabulated.spline_d2(tabs, dv64),
                        dv=dv, idx_map=tabulated.aux_index_map(dv),
                        ampl=np.sqrt(sm.variance).astype(np.float32))
    if verbose:
        print(f"  building {model} collapse tables for {sm.n} radii")
    ct = tabulated.build_ct_tables_all(cosmo, sm, model=model)
    if cached:
        tabulated.write_ct_table_file(params.CTtableFile, params, sm,
                                      ct["tables"])
    return ct


def growth_k_tables(cosmo: Cosmology, z0: float, N: int, device,
                    ntab: int = 512):
    """Per-order growth D_i(z0, k) tables [4, ntab] float32 on ``device``
    over a uniform log10 |k| grid in grid units (the reference's grid-unit
    k in the growth switch, fmax-pfft.c:340-364), with the grid's start glo
    and step gdx as float32 values."""
    lo = math.log10(2.0 * math.pi / N) - 2.0
    hi = math.log10(math.pi * math.sqrt(3.0)) + 0.1
    logk = np.linspace(lo, hi, ntab)
    k = 10.0 ** logk
    tabs = np.stack([
        np.asarray(cosmo.GrowingMode(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_2LPT(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_3LPT_1(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_3LPT_2(z0, k), np.float32)])
    return (torch.from_numpy(tabs).to(device), float(np.float32(lo)),
            float(np.float32(logk[1] - logk[0])))


def displacement_sources(kdensity, sd, N: int, order: int) -> dict:
    """The k-space sources of the displacement fields, keyed like them, in
    the order v2, v31, v32 (the LPT sources of the R=0 Hessian stack sd)
    and v1 (delta itself).  They do not depend on z, so a RECOMPUTE run
    makes them once for all its displacement sets."""
    src = {}
    if order >= 2:
        kvec2, kvec31, kvec32 = lpt.lpt_sources(sd, N)
        src["v2"] = kvec2
        if order >= 3:
            src["v31"] = kvec31
            src["v32"] = kvec32
        del kvec2, kvec31, kvec32
    src["v1"] = kdensity
    return src


def displacement_fields(sources: dict, growths, N: int,
                        scaledep: bool = False) -> dict:
    """One displacement set: a [3, N, N, N] stack per source.  growths:
    scalars (D1, D2, D31, D32) at the set's redshift, or with scaledep the
    growth_k_tables triple (gtabs [4, ntab], glo, gdx)."""
    out = {}
    for key, kvec in sources.items():
        i = GROWTH_INDEX[key]
        if scaledep:
            gtabs, glo, gdx = growths
            out[key] = derivatives.first_derivatives_tab(kvec, gtabs[i],
                                                         glo, gdx, N)
        else:
            out[key] = derivatives.first_derivatives(kvec, growths[i], N)
    return out


def unpack_products(host: np.ndarray, N: int, count: int, keys, nsets: int):
    """SparseProducts from the packed host copy: cell indices and F, then
    the rows of each displacement set (compact.gather_rows layout)."""
    ci = host[:count].view(np.int32).astype(np.int64)
    F = host[count:2 * count]
    off = 2 * count
    sets = []
    for _ in range(nsets):
        rows = {}
        for k in keys:
            rows[k] = host[off:off + 3 * count].reshape(count, 3)
            off += 3 * count
        sets.append(rows)
    return SparseProducts(N=N, ci=ci, F=F, vel=sets[0], sorted_by="F",
                          segments=sets if nsets > 1 else None)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stream_set(pending: PendingFetch, s: int, buf, off: int,
                block) -> None:
    """Set s's rows, just gathered into buf[off:] (packed layout), onto
    the copy stream: the first set's F after the cell indices in ``block``
    (K6a's packed int32 indices are not copied), then each table's rows in
    N_CHUNKS prefix chunks interleaved by (chunk, table), so the watermark
    advances evenly.  The tables' host buffers are allocated after the
    copy stream's wait, so that the device runs the set's work meanwhile:
    the CUDA driver serializes page-locked allocations with every other
    CUDA call of the process, so an allocation on a thread of its own
    would hold the launches back instead."""
    pending.buf = buf
    c = pending.count
    pending.after()
    if s == 0:
        # F after the cell indices; the note's name says both landed
        pending.note("ci_F", block[2 * c:], buf[off + c:off + 2 * c])
        off += 2 * c
    tables = []
    for j, k in enumerate(pending.keys):
        key, rows = pending.table(s, k)
        tables.append((key, rows.reshape(-1), off + 3 * c * j))
    b = chunk_bounds(c)
    for i in range(N_CHUNKS):
        lo, hi = 3 * b[i], 3 * b[i + 1]
        for key, rows, o in tables:
            pending.enqueue(key, b[i + 1], rows[lo:hi], buf[o + lo:o + hi])


def run_fmax(params: Params, cosmo: Cosmology, device,
             kdensity=None, scaledep_gm=None, verbose: bool = False,
             keep_dense_products: bool = False) -> FmaxResult:
    """Collapse times, displacements and the needed-particle products on
    ``device``.  kdensity: an optional complex64 [N, N, N//2+1] tensor
    (e.g. the JAX package's, through load_jax_state) used instead of
    generating the initial conditions.  scaledep_gm: the per-radius
    effective growth of a scale-dependent cosmology
    (scaledep.set_scaledep_gm).  keep_dense_products, or
    params.WriteTimelessSnapshot: also the whole grid's products on the
    host (FmaxResult.dense); each displacement stack is copied after its
    rows are gathered and before it is freed, so the device peak does not
    grow.  The FmaxPDF counts are binned and the sort's int64 cell indices
    copied before LPT, and each displacement set's rows stream to the host
    behind the device's work (module docstring); the call returns once the
    counts, the cell indices and F have landed, with the tables as
    StreamingVel views that fragmentation sweeps behind their watermark,
    and FmaxResult.pending_fetch to join() afterwards."""
    grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
    N = grid.N
    sm = Smoothing.build(params, cosmo)
    timings = {}
    ffts = dict(FFT_COUNTS)

    t0 = time.perf_counter()
    with record_function("fmax.ic"):
        if kdensity is None:
            kdensity = generate_kdensity(grid, cosmo, params.RandomSeed,
                                         device, fixed=params.FixedIC,
                                         paired=params.PairedIC)
        kdensity = kdensity.to(device)
        _sync(device)
    timings["dens"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    radii_grid = (sm.radii / grid.CellSize).astype(np.float32)
    with record_function("fmax.cycle"):
        if params.ell_model != "classic":
            ct = prepare_ct_tables(params, cosmo, sm, verbose=verbose)
            timings["ct_tables"] = time.perf_counter() - t0
            Fmax, Rmax, stats, sd = fmax_loop_tab(
                kdensity, radii_grid, load_jax_state(ct, device), N,
                interp=params.ct_interp)
        else:
            packs = inverse_growth_packs(cosmo, sm, scaledep_gm)
            Fmax, Rmax, stats, sd = fmax_loop(kdensity, radii_grid, packs, N)
        sm.true_variance[:] = stats[:, 1].cpu().numpy()      # device sync
    t_cycle = time.perf_counter()
    alloc0 = thread_alloc_seconds()
    timings["fmax_loop"] = t_cycle - t0
    if verbose:
        for ism in range(sm.n):
            print(f"  smoothing {ism + 1}/{sm.n}: R={sm.radii[ism]:9.5f} "
                  f"expected sigma {math.sqrt(sm.variance[ism]):7.4f} "
                  f"computed "
                  f"{math.sqrt(max(sm.true_variance[ism], 0.0)):7.4f}")

    # the needed particles in the sweep's order (one sort, used by every
    # displacement set)
    t0 = time.perf_counter()
    with record_function("fmax.sort"):
        idx = compact.needed_order(Fmax, params.Flast)
    t_sort = time.perf_counter() - t0

    # displacements at R=0 (fmax.c:152-169, LPT.c): stored at output_z[0]
    # under RECOMPUTE_DISPLACEMENTS, with one further set per output
    # redshift (compute_displacements per segment, fragment.c:398-429),
    # else at the last redshift
    t0 = time.perf_counter()
    zs = (list(params.output_z) if params.recompute_displacements
          else [params.zlast])
    scaledep = bool(getattr(cosmo, "scale_dep", False))

    def growths_at(z):
        if scaledep:
            return growth_k_tables(cosmo, z, N, device)
        return (float(cosmo.GrowingMode(z)),
                float(cosmo.GrowingMode_2LPT(z)),
                float(cosmo.GrowingMode_3LPT_1(z)),
                float(cosmo.GrowingMode_3LPT_2(z)))

    keep_dense = keep_dense_products or params.WriteTimelessSnapshot
    dense_vel = {}
    keys = sorted(GROWTH_INDEX)[:{1: 1, 2: 2, 3: 4}[params.lpt_order]]
    count = idx.numel()
    # on a card the LPT is timed by two events on the compute stream, read
    # once the last row has landed (join)
    lpt_events = EventTimer([device], "lpt")
    pending = PendingFetch(device, count, keys, len(zs), t_cycle, alloc0,
                           timings, resolve=lpt_events.timings)
    try:
        # the histogram and the cell indices before LPT, so that their
        # copies do not wait for it; the cell indices and F share one
        # block of 12 bytes a row, int64 then float32, a table's size
        counts = compact.pdf_hist(Fmax)
        hist = pending.host_empty((PDF_BINS,), torch.int64, align=4096)
        pending.after()
        pending.note("hist", hist, counts)
        block = pending.host_empty((3 * count,), torch.float32)
        pending.after()
        pending.note("ci", block[:2 * count].view(torch.int64), idx)
        lpt_events.record()
        with record_function("fmax.lpt"):
            sources = displacement_sources(kdensity, sd, N, params.lpt_order)
            del sd
            sizes = [compact.packed_size(count, len(keys), s == 0)
                     for s in range(len(zs))]
            buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
            # each cell's row, built once for every displacement set
            rank = compact.needed_rank(idx, N ** 3)
            off = 0
            for s, z in enumerate(zs):
                vel = displacement_fields(sources, growths_at(z), N,
                                          scaledep)
                # the needed rows of this set, then its stacks are freed
                compact.gather_rows(idx, [vel[k] for k in keys],
                                    buf[off:off + sizes[s]],
                                    F=Fmax if s == 0 else None, rank=rank)
                if s == len(zs) - 1:
                    lpt_events.record()
                _stream_set(pending, s, buf, off, block)
                off += sizes[s]
                if keep_dense and s == 0:
                    for k in keys:
                        dense_vel[k] = to_host(vel[k]).numpy()
                del vel
            del sources, rank
        if not lpt_events.devs:
            timings["lpt"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with record_function("handoff.finish"):
            host, vel, segments = pending.finish()
        del buf
    except BaseException as e:
        pending.abort(e)
        raise
    sp = SparseProducts(N=N, ci=host["ci"], F=host["ci_F"], vel=vel,
                        sorted_by="F", segments=segments)
    dense = None
    if keep_dense:
        dense = DenseProducts(Fmax=to_host(Fmax).numpy(),
                              Rmax=to_host(Rmax).numpy(), vel=dense_vel)
    timings["products"] = t_sort + time.perf_counter() - t0
    # this call's 3-D transforms by route (grids.FFT_COUNTS)
    for route in ("direct", "torch"):
        timings[f"fft_{route}"] = FFT_COUNTS[route] - ffts[route]
    pending.returned()
    if verbose:
        print(f"  products: {count}/{N ** 3} needed particles "
              f"({100.0 * count / N ** 3:.1f}%), {len(zs)} displacement "
              f"set(s), rows streaming behind the watermark")
    return FmaxResult(products=Products(Fmax=Fmax, Rmax=Rmax), smoothing=sm,
                      grid=grid, host_products=sp, pdf_hist=host["hist"],
                      timings=timings, dense=dense, pending_fetch=pending)


def fmax_pdf(hist: np.ndarray, fname: str = None) -> np.ndarray:
    """Write the Fmax histogram (Fmax_PDF, fmax.c:509-550): 210 bins of
    width 0.1 in F, in the reference file format."""
    npart = int(np.sum(hist))
    if fname:
        with open(fname, "w") as fd:
            fd.write(f"# Fmax PDF over {npart} particles\n")
            fd.write("# 1-2: F interval\n")
            fd.write("# 3: number of particles in that interval\n#\n")
            for i in range(PDF_BINS):
                hi = 999.0 if i == PDF_BINS - 1 else (i + 1) / 10.0
                fd.write(f" {i / 10.0:6.1f}   {hi:6.1f}  {hist[i]}\n")
    return hist
