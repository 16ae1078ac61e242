"""Fragmentation driver: from the needed-particle products to halos
(counterpart of pinocchio_tpu/fragment/driver.py).

The products arrive from the device already sorted in the sweep's order
(descending Fmax, ties by ascending cell index, fragment.c:484-520), so this
module selects the particles of one sub-box, builds the growth-weight tables
and the ctypes structs and runs the native group sweep (the port's copy of
the C sweep, native/groupsweep.c, loaded through ``native``).  The sub-box
is a SubboxGeometry: by default one periodic box spanning the grid
(set_subboxes with nbox=1: pbc on, safe=0); fragment/subbox.py sweeps
several padded sub-boxes and merges them.  A sub-box's particles are picked
from the shared products by one C pass (subbox_select), filtered in order by
an optional cell mask (the two-turn scheme's needed-particle map), and the
sweep reads the shared displacement rows through a row map, so threads
sweeping other sub-boxes share them.  Rows that still stream from the device
(handoff.StreamingVel, from either engine's hand-off) are read from
their host buffers while they fill: the sweep gets the stream's rows_ready
watermark and waits on it before it reads a row past the delivered prefix (the
products are in the sweep's order, so the prefix is all it needs); a failed
copy releases the watermark and raises after the sweep.  There is no
dense-product branch (so no count_peaks: the group arrays are sized from the
stored count and regrown on overflow).  Scale-dependent growth adds the sweep's
(log10 k, log10 F) weight tables, RECOMPUTE_DISPLACEMENTS its per-segment
displacement sets and weights, a past light cone (plc.build_plc_geometry) the
sweep's on-the-fly crossing solve and its output buffers.
"""

from __future__ import annotations

import ctypes
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from .. import native
from ..config import Params
from ..cosmology import DELTALOGK, LOGKMIN, NK_BINS, Cosmology

from ..fmax import FmaxResult, ensure_host_products
from ..handoff import StreamingVel

FILAMENT = 1
NCOUNTERS = 16
# initial group-array capacity per stored particle (the sweep reports -2
# when it overflows, and the driver retries with twice the capacity)
PEAKS_PER_STORED = 0.12

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


class _SweepInput(ctypes.Structure):
    # field layout of groupsweep.c's SweepInput (the scale-dependent and
    # segment blocks stay zero unless those features are on)
    _fields_ = [
        ("n", ctypes.c_int64),
        ("Fmax", _f32p), ("pos", _i32p),
        ("v1", _f32p), ("v2", _f32p), ("v31", _f32p), ("v32", _f32p),
        ("loc", _i32p), ("rowmap", _i32p),
        ("L", ctypes.c_int32 * 3), ("pbc", ctypes.c_int32 * 3),
        ("safe", ctypes.c_int32 * 3), ("stabl", ctypes.c_int32 * 3),
        ("G", ctypes.c_int32 * 3),
        ("f_m", ctypes.c_double), ("f_rm", ctypes.c_double),
        ("espo", ctypes.c_double), ("f_a", ctypes.c_double),
        ("f_ra", ctypes.c_double), ("f_200", ctypes.c_double),
        ("sigmaD0", ctypes.c_double), ("sigma_grid", ctypes.c_double),
        ("min_halo_mass", ctypes.c_int32), ("lpt_order", ctypes.c_int32),
        ("tab_n", ctypes.c_int32),
        ("tab_lo", ctypes.c_double), ("tab_dlog", ctypes.c_double),
        ("tab_w1", _f64p), ("tab_w2", _f64p),
        ("tab_w31", _f64p), ("tab_w32", _f64p),
        ("tab_dv1", _f64p), ("tab_dv2", _f64p),
        ("tab_dv31", _f64p), ("tab_dv32", _f64p),
        ("tab_D1", _f64p),
        ("nout", ctypes.c_int32), ("outF", _f64p),
        ("maxg", ctypes.c_int32),
        ("sd_nk", ctypes.c_int32),
        ("sd_logk_lo", ctypes.c_double), ("sd_dlogk", ctypes.c_double),
        ("sd_w1", _f64p), ("sd_w2", _f64p),
        ("sd_w31", _f64p), ("sd_w32", _f64p),
        ("sd_dv1", _f64p), ("sd_dv2", _f64p),
        ("sd_dv31", _f64p), ("sd_dv32", _f64p),
        ("sd_rad_gm0", ctypes.c_double),
        ("sd_nsmooth", ctypes.c_int32), ("sd_logk_displ", _f64p),
        ("sd_logk_part", ctypes.c_double), ("sd_ipd", ctypes.c_double),
        ("nseg", ctypes.c_int32), ("segF", _f64p),
        ("seg_v1", ctypes.POINTER(_f32p)), ("seg_v2", ctypes.POINTER(_f32p)),
        ("seg_v31", ctypes.POINTER(_f32p)),
        ("seg_v32", ctypes.POINTER(_f32p)),
        ("seg_w1", _f64p), ("seg_w2", _f64p),
        ("seg_w31", _f64p), ("seg_w32", _f64p),
        ("rows_ready", _i64p), ("rows_wait_ns", _i64p),
    ]


class _CaptureBuffers(ctypes.Structure):
    _fields_ = [("name", _u64p), ("mass", _i32p),
                ("q", _f32p), ("x", _f32p), ("v", _f32p),
                ("count", _i32p)]


class _PlcInput(ctypes.Structure):
    # field layout of groupsweep.c's plc_input
    _fields_ = [
        ("enabled", ctypes.c_int32),
        ("Fstart", ctypes.c_double), ("Fstop", ctypes.c_double),
        ("center", ctypes.c_double * 3), ("zvers", ctypes.c_double * 3),
        ("ipd", ctypes.c_double), ("aperture", ctypes.c_double),
        ("brent_err", ctypes.c_double),
        ("nrepl", ctypes.c_int32),
        ("repl_ijk", _i32p), ("repl_F1", _f64p), ("repl_F2", _f64p),
        ("tab_rF", _f64p),
        ("nzbins", ctypes.c_int32),
        ("delta_z", ctypes.c_double), ("z_last", ctypes.c_double),
        ("cap", ctypes.c_int64),
    ]


class _PlcOutput(ctypes.Structure):
    _fields_ = [("name", _u64p), ("zred", _f32p), ("mass", _i32p),
                ("x", _f32p), ("v", _f32p), ("nz", _f64p),
                ("count", _i64p), ("overflow", _i32p)]


class _SweepOutput(ctypes.Structure):
    _fields_ = [("mass", _i32p), ("name", _u64p),
                ("halo_app", _i32p), ("ll", _i32p),
                ("merged_with", _i32p), ("mass_at_merger", _i32p),
                ("t_appear", _f32p), ("t_peak", _f32p), ("t_merge", _f32p),
                ("good", _u8p), ("alive", _u8p),
                ("ngroups", _i32p), ("counters", _u64p),
                ("group_of_particle", _i32p), ("zacc", _f32p),
                ("gq", _f32p)]


def fragment_parameters(order: int, use_sim_params: bool = False):
    """Calibrated fragmentation parameters per LPT order
    (set_fragment_parameters, fragment.c:48-116)."""
    f_200 = 0.171
    table = {
        # order: (f_m=f_a, f_rm, espo, f_ra, sigmaD0)
        1: ((0.495, -0.075, 0.852, 0.500, 1.7) if use_sim_params else
            (0.505, 0.000, 0.820, 0.300, 1.7)),
        2: ((0.475, -0.020, 0.780, 0.650, 1.5) if use_sim_params else
            (0.501, 0.052, 0.745, 0.334, 1.5)),
        3: ((0.455, 0.000, 0.755, 0.700, 1.2) if use_sim_params else
            (0.5024, 0.1475, 0.6852, 0.4584, 1.2)),
    }
    f_m, f_rm, espo, f_ra, sigmaD0 = table[min(order, 3)]
    return dict(f_m=f_m, f_a=f_m, f_rm=f_rm, espo=espo, f_ra=f_ra,
                f_200=f_200, sigmaD0=sigmaD0)


def _logF_grid(params: Params, n: int, Fhi: float):
    lo = math.log10(params.Flast) - 1e-4
    logF = np.linspace(lo, math.log10(Fhi), n)
    return lo, logF, 10.0 ** logF - 1.0


def growth_tables(params: Params, cosmo: Cosmology, n: int = 8192,
                  Fhi: float = 1500.0, k_dens: float = None):
    """Uniform-log10(F) tables of the displacement weights, velocity growth
    factors and D(z) used inside the sweep (set_weight / set_obj_vel,
    build_groups.c:1411-1460), and the comoving distance in grid units of
    the PLC crossing condition.  k_dens: the wavenumber of D(z) (with
    scale-dependent growth, the smoothed density's effective scale at the
    last radius); the Nyquist k_for_GM when None."""
    lo, logF, z = _logF_grid(params, n, Fhi)
    zl = params.zlast
    k = params.k_for_GM
    fac = cosmo.Hubble(z) / (1.0 + z) * params.InterPartDist
    arrs = dict(
        w1=cosmo.GrowingMode(z, k) / cosmo.GrowingMode(zl, k),
        w2=cosmo.GrowingMode_2LPT(z, k) / cosmo.GrowingMode_2LPT(zl, k),
        w31=cosmo.GrowingMode_3LPT_1(z, k) / cosmo.GrowingMode_3LPT_1(zl, k),
        w32=cosmo.GrowingMode_3LPT_2(z, k) / cosmo.GrowingMode_3LPT_2(zl, k),
        dv1=fac * cosmo.fomega(z, k), dv2=fac * cosmo.fomega_2LPT(z, k),
        dv31=fac * cosmo.fomega_3LPT_1(z, k),
        dv32=fac * cosmo.fomega_3LPT_2(z, k),
        D1=cosmo.GrowingMode(z, k_dens if k_dens is not None else k),
        rF=cosmo.ComovingDistance(z) / params.InterPartDist)
    return lo, logF[1] - logF[0], {
        k_: np.ascontiguousarray(v, np.float64) for k_, v in arrs.items()}


def growth_tables_2d(params: Params, cosmo: Cosmology, n: int = 8192,
                     Fhi: float = 1500.0):
    """Scale-dependent variant: [NK_BINS, n] tables of the weights and
    velocity factors over the (log10 k, log10 F) grid, which the sweep
    interpolates bilinearly (set_weight + InterpolateGrowth,
    build_groups.c:1411-1444, cosmo.c:1728-1755)."""
    _, _, z = _logF_grid(params, n, Fhi)
    zl = params.zlast
    fac = cosmo.Hubble(z) / (1.0 + z) * params.InterPartDist
    out = {nm: np.zeros((NK_BINS, n)) for nm in
           ("w1", "w2", "w31", "w32", "dv1", "dv2", "dv31", "dv32")}
    ks = 10.0 ** (LOGKMIN + DELTALOGK * np.arange(NK_BINS))
    for j, k in enumerate(ks):
        for nm, grow, fom in (
                ("1", cosmo.GrowingMode, cosmo.fomega),
                ("2", cosmo.GrowingMode_2LPT, cosmo.fomega_2LPT),
                ("31", cosmo.GrowingMode_3LPT_1, cosmo.fomega_3LPT_1),
                ("32", cosmo.GrowingMode_3LPT_2, cosmo.fomega_3LPT_2)):
            out["w" + nm][j] = grow(z, k) / grow(zl, k)
            out["dv" + nm][j] = fac * fom(z, k)
    return {k_: np.ascontiguousarray(v, np.float64) for k_, v in out.items()}


def _segment_weight_tables(params: Params, cosmo: Cosmology, scaledep_gm,
                           n: int = 8192, Fhi: float = 1500.0):
    """Per-segment displacement weights over log10 F (and the NK_BINS
    log10 k grid when scale-dependent), set_weight's two branches
    (build_groups.c:1414-1442): segment 0 is D(z)/D(z_0), segment s
    (D(z) - D(z_{s-1})) / (D(z_s) - D(z_{s-1}))."""
    _, _, z = _logF_grid(params, n, Fhi)
    zs = params.output_z
    nseg = len(zs)
    if scaledep_gm is not None:
        ks = 10.0 ** (LOGKMIN + DELTALOGK * np.arange(NK_BINS))
    else:
        ks = [params.k_for_GM]
    out = {nm: np.zeros((nseg, len(ks), n))
           for nm in ("w1", "w2", "w31", "w32")}
    fns = dict(w1=cosmo.GrowingMode, w2=cosmo.GrowingMode_2LPT,
               w31=cosmo.GrowingMode_3LPT_1, w32=cosmo.GrowingMode_3LPT_2)
    for j, k in enumerate(ks):
        for nm, fn in fns.items():
            D = fn(z, k)
            out[nm][0, j] = D / fn(zs[0], k)
            for s in range(1, nseg):
                D0 = fn(zs[s - 1], k)
                out[nm][s, j] = (D - D0) / (fn(zs[s], k) - D0)
    if scaledep_gm is None:
        out = {k_: v[:, 0, :] for k_, v in out.items()}
    return {k_: np.ascontiguousarray(v, np.float64) for k_, v in out.items()}


@dataclass
class SubboxGeometry:
    """One fragmentation sub-domain (subbox_data, pinocchio.h:352-366)."""
    L: tuple            # local grid-with-boundary dims (Lgwbl)
    pbc: tuple
    safe: tuple
    stabl: tuple        # offset of the local grid in the global grid
    G: tuple            # global grid dims

    @classmethod
    def full(cls, N: int) -> "SubboxGeometry":
        """The whole periodic grid as one sub-box."""
        return cls(L=(N, N, N), pbc=(1, 1, 1), safe=(0, 0, 0),
                   stabl=(0, 0, 0), G=(N, N, N))


@dataclass
class CatalogSnapshot:
    z: float
    name: np.ndarray           # u64
    mass: np.ndarray           # particles, i32
    q: np.ndarray              # [n,3] Lagrangian CM, global grid units
    x: np.ndarray              # [n,3] Eulerian, global grid units
    v: np.ndarray              # [n,3] km/s


@dataclass
class GroupState:
    ngroups: int
    mass: np.ndarray
    name: np.ndarray
    halo_app: np.ndarray
    ll: np.ndarray
    merged_with: np.ndarray
    mass_at_merger: np.ndarray
    t_appear: np.ndarray
    t_peak: np.ndarray
    t_merge: np.ndarray
    good: np.ndarray
    alive: np.ndarray


@dataclass
class PlcResult:
    """The halos' crossings of the past light cone, in the sweep's order."""
    name: np.ndarray
    z: np.ndarray
    mass: np.ndarray
    x: np.ndarray            # [n,3] true Mpc from the cone vertex
    v: np.ndarray            # [n,3] km/s
    nz: np.ndarray           # crossings per redshift bin
    overflow: bool


@dataclass
class FragmentResult:
    catalogs: List[CatalogSnapshot]
    # one GroupState, or after a multibox merge a list of them (one per
    # sub-box)
    groups: Union[GroupState, List[GroupState]]
    counters: np.ndarray
    npeaks: int
    nstored: int
    plc: Optional[PlcResult] = None
    # per stored particle, in the sweep's order: the cell index (the local
    # linear index of the sub-box, z fastest; the global one after the
    # multibox merge) and the accretion redshift (-1 where none)
    particle_pos: np.ndarray = None
    particle_zacc: np.ndarray = None
    # the name of each stored particle's group (its peak particle's ID),
    # with 0 outside any group and FILAMENT for a filament
    # (build_groups.c:968-973); only with WriteTimelessSnapshot
    particle_grup: np.ndarray = None
    timings: Dict[str, float] = field(default_factory=dict)
    # the PredPeakFactor that would have been enough (fragment.c:477)
    best_pred_peak_factor: float = 0.0
    # final Lagrangian CM per group [ngroups+1, 3] in local sub-box
    # coordinates (the two-turn boundary-sphere map_update reads them)
    groups_q: np.ndarray = None


def _subsel_lib():
    """groupsweep.so with the sub-box selection helpers' signatures (the
    displacement rows are read through rowmap, so the row gathers of the
    JAX package's dense-segment branch, gather_rows3 and gather_i64, are
    not needed)."""
    lib = native.load("groupsweep")
    if not getattr(lib, "_subsel_sig", False):
        lib.subbox_select.restype = ctypes.c_int64
        lib.subbox_select.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int32, _i32p, _i32p, _i32p,
            _i32p, _i32p]
        lib.gather_f32.restype = None
        lib.gather_f32.argtypes = [_f32p, _i32p, ctypes.c_int64, _f32p]
        lib.fill_loc.restype = None
        lib.fill_loc.argtypes = [_i32p, ctypes.c_int64, _i32p]
        lib._subsel_sig = True
    return lib


def _select(sp, geom: SubboxGeometry, cell_mask):
    """The stored particles of the sub-box ``geom``: (rows, lin) with rows
    the particles' rows in the shared products (None for all of them, in
    order) and lin their local linear cells, z fastest, in the products'
    (sweep) order; cell_mask (uint8 over the padded box, ravelled) keeps
    the cells it marks, order-preserving."""
    N = sp.N
    rows = None
    lin = sp.ci
    if tuple(geom.L) != (N, N, N) or tuple(geom.stabl) != (0, 0, 0):
        # one streaming C pass: the wrapped-membership test and the local
        # linear index (distribute.c:280-367)
        ci = np.ascontiguousarray(sp.ci, np.int64)
        nsp = len(ci)
        rows = np.empty(nsp, np.int32)
        lin32 = np.empty(nsp, np.int32)

        def arr3(v):
            return np.ascontiguousarray(v, np.int32).ctypes.data_as(_i32p)
        m = _subsel_lib().subbox_select(
            ci.ctypes.data_as(_i64p), ctypes.c_int64(nsp), np.int32(N),
            arr3(geom.L), arr3(geom.stabl), arr3(geom.G),
            rows.ctypes.data_as(_i32p), lin32.ctypes.data_as(_i32p))
        # the buffers' unwritten tails are never touched, so they take no
        # host memory
        rows, lin = rows[:m], lin32[:m]
    if cell_mask is not None:
        keep = cell_mask[lin] != 0
        rows = (np.flatnonzero(keep).astype(np.int32) if rows is None
                else rows[keep])
        lin = lin[keep]
    return rows, lin


def _sweep_lib():
    lib = native.load("groupsweep")
    lib.sweep.restype = ctypes.c_int
    lib.sweep.argtypes = [ctypes.POINTER(_SweepInput),
                          ctypes.POINTER(_CaptureBuffers),
                          ctypes.POINTER(_SweepOutput),
                          ctypes.POINTER(_PlcInput),
                          ctypes.POINTER(_PlcOutput)]
    return lib


def run_fragmentation(params: Params, cosmo: Cosmology,
                      fmax_result: FmaxResult, plc_geom=None,
                      scaledep_gm=None, geom: SubboxGeometry = None,
                      cell_mask: np.ndarray = None, quick: bool = False,
                      verbose: bool = True,
                      _maxg_override: int = None) -> FragmentResult:
    """The group sweep over the needed particles of one sub-box.  plc_geom:
    the past light cone's geometry (plc.build_plc_geometry), None or
    disabled for no PLC.  scaledep_gm: the per-radius effective scales of a
    scale-dependent cosmology (scaledep.set_scaledep_gm), None otherwise.
    geom: the sub-box, the whole periodic grid when None.  cell_mask: an
    optional uint8 array over the padded box (ravelled, z fastest) that
    restricts the stored particles (the needed-particle map,
    distribute.c:670-698).  quick: the stripped first-turn sweep (quick_build_groups,
    build_groups.c:1882-2243): no catalogs, no PLC, no RECOMPUTE segments,
    only the group state and the groups' Lagrangian CMs (groups_q)."""
    t_all = time.perf_counter()
    timings = {}
    sp = ensure_host_products(fmax_result)
    if sp.sorted_by != "F":
        raise ValueError("run_fragmentation takes F-sorted products")
    if geom is None:
        geom = SubboxGeometry.full(sp.N)
    if quick:
        plc_geom = None
    ncells = int(np.prod(geom.L))

    t0 = time.perf_counter()
    # the products are F-sorted and the selection keeps their order, so the
    # selected particles are already in the sweep's order
    rowmap, lin = _select(sp, geom, cell_mask)
    n = len(lin)
    pos = np.ascontiguousarray(lin, np.int32)
    if rowmap is None:
        Fs = np.ascontiguousarray(sp.F, np.float32)
    else:
        Fs = np.empty(n, np.float32)
        _subsel_lib().gather_f32(
            np.ascontiguousarray(sp.F, np.float32).ctypes.data_as(_f32p),
            rowmap.ctypes.data_as(_i32p), ctypes.c_int64(n),
            Fs.ctypes.data_as(_f32p))
    keys = ("v1", "v2", "v31", "v32")
    # streamed tables (handoff.StreamingVel): the sweep reads their host
    # buffers while they fill, behind the rows_ready watermark
    stream = sp.vel.stream if isinstance(sp.vel, StreamingVel) else None

    def rows(vs):
        # the shared tables; a sub-box reads its rows through rowmap
        if stream is not None:
            return {k: (vs.buffer(k) if k in vs else None) for k in keys}
        return {k: (np.ascontiguousarray(vs[k], np.float32)
                    if k in vs else None) for k in keys}

    vel = rows(sp.vel)
    # RECOMPUTE_DISPLACEMENTS: one set per output redshift, rows aligned
    # with vel (the sweep reads them with the same row index)
    segments = ([rows(vs) for vs in sp.segments]
                if sp.segments is not None and not quick else None)
    loc = np.full(ncells, -1, np.int32)
    _subsel_lib().fill_loc(pos.ctypes.data_as(_i32p), ctypes.c_int64(n),
                           loc.ctypes.data_as(_i32p))
    timings["sort"] = time.perf_counter() - t0

    # ---- guard rails (fragment.c:258-283, build_groups.c:350-357) ----
    nfields = {1: 1, 2: 2, 3: 4}[params.lpt_order]
    nseg = len(sp.segments) if sp.segments is not None else 1
    bytes_per_stored = (8 + 4 + 3 * nfields * 4) \
        + (4 + 4 + 3 * nfields * 4 * nseg + 4 + 4)
    nalloc = int(ncells * max(0.0, params.MaxMemPerParticle - 8)
                 / bytes_per_stored)
    if n > nalloc:
        need = int((n - nalloc) * bytes_per_stored / ncells) + 1 \
            + int(params.MaxMemPerParticle)
        print(f"CRITICAL WARNING: budget allows {nalloc} stored particles "
              f"but {n} are needed (overhead {n / ncells:.3f}).\n"
              f"Please increase MaxMemPerParticle to at least {need}"
              + (" — aborting (ExitIfExtraParticles)"
                 if params.ExitIfExtraParticles else ""))
        if params.ExitIfExtraParticles:
            raise MemoryError(
                f"stored particles {n} exceed the MaxMemPerParticle "
                f"budget ({nalloc}); set MaxMemPerParticle >= {need}")

    maxg = _maxg_override or int(PEAKS_PER_STORED * n) + 8192
    if verbose:
        print(f"  fragmentation: {n} stored particles, "
              f"overhead {n / ncells:.3f}")

    # ---- tables and parameters ----
    fpar = fragment_parameters(min(2, params.lpt_order),
                               params.use_sim_params)
    tab_lo, tab_dlog, tabs = growth_tables(
        params, cosmo, k_dens=(scaledep_gm.k_GM_dens[-1]
                               if scaledep_gm is not None else None))
    # the grid's own delta variance at R=0, from the collapse kernel's
    # delta^2 statistic
    sigma_grid = math.sqrt(float(fmax_result.smoothing.true_variance[-1]))
    # the quick turn captures no catalogs (nout=0: the capture trigger never
    # fires, as quick_build_groups skips write_catalog)
    outF = np.ascontiguousarray([] if quick else params.output_F, np.float64)
    nout = len(outF)

    cap_name = np.zeros(nout * maxg, np.uint64)
    cap_mass = np.zeros(nout * maxg, np.int32)
    cap_q = np.zeros(nout * maxg * 3, np.float32)
    cap_x = np.zeros(nout * maxg * 3, np.float32)
    cap_v = np.zeros(nout * maxg * 3, np.float32)
    cap_count = np.zeros(nout, np.int32)

    g_mass = np.zeros(maxg, np.int32)
    g_name = np.zeros(maxg, np.uint64)
    g_halo_app = np.zeros(maxg, np.int32)
    g_ll = np.zeros(maxg, np.int32)
    g_mw = np.zeros(maxg, np.int32)
    g_mam = np.zeros(maxg, np.int32)
    g_tap = np.zeros(maxg, np.float32)
    g_tpk = np.zeros(maxg, np.float32)
    g_tmg = np.zeros(maxg, np.float32)
    g_good = np.zeros(maxg, np.uint8)
    g_alive = np.zeros(maxg, np.uint8)
    g_q = np.zeros(maxg * 3, np.float32)
    g_ngroups = np.zeros(1, np.int32)
    counters = np.zeros(NCOUNTERS, np.uint64)
    gop = np.zeros(n, np.int32)
    zacc = np.zeros(n, np.float32)

    def p(arr, typ):
        return arr.ctypes.data_as(typ) if arr is not None else typ()

    si = _SweepInput(
        n=n,
        Fmax=p(Fs, _f32p), pos=p(pos, _i32p),
        v1=p(vel["v1"], _f32p), v2=p(vel["v2"], _f32p),
        v31=p(vel["v31"], _f32p), v32=p(vel["v32"], _f32p),
        loc=p(loc, _i32p), rowmap=p(rowmap, _i32p),
        L=(ctypes.c_int32 * 3)(*geom.L),
        pbc=(ctypes.c_int32 * 3)(*geom.pbc),
        safe=(ctypes.c_int32 * 3)(*geom.safe),
        stabl=(ctypes.c_int32 * 3)(*geom.stabl),
        G=(ctypes.c_int32 * 3)(*geom.G),
        f_m=fpar["f_m"], f_rm=fpar["f_rm"], espo=fpar["espo"],
        f_a=fpar["f_a"], f_ra=fpar["f_ra"], f_200=fpar["f_200"],
        sigmaD0=fpar["sigmaD0"], sigma_grid=sigma_grid,
        min_halo_mass=params.MinHaloMass, lpt_order=params.lpt_order,
        tab_n=len(tabs["w1"]), tab_lo=tab_lo, tab_dlog=tab_dlog,
        tab_w1=p(tabs["w1"], _f64p), tab_w2=p(tabs["w2"], _f64p),
        tab_w31=p(tabs["w31"], _f64p), tab_w32=p(tabs["w32"], _f64p),
        tab_dv1=p(tabs["dv1"], _f64p), tab_dv2=p(tabs["dv2"], _f64p),
        tab_dv31=p(tabs["dv31"], _f64p), tab_dv32=p(tabs["dv32"], _f64p),
        tab_D1=p(tabs["D1"], _f64p),
        nout=nout, outF=p(outF, _f64p), maxg=maxg,
        rows_ready=(p(stream.ready, _i64p) if stream is not None
                    else _i64p()))
    waited = np.zeros(1, np.int64)
    if stream is not None:
        si.rows_wait_ns = p(waited, _i64p)
    # arrays the sweep reads through si's pointers, kept alive until it ends
    keepalive = []

    if scaledep_gm is not None:
        sd_tabs = growth_tables_2d(params, cosmo, n=len(tabs["w1"]))
        logk_displ = np.ascontiguousarray(
            np.log10(scaledep_gm.k_GM_displ), np.float64)
        keepalive += [sd_tabs, logk_displ]
        si.sd_nk = NK_BINS
        si.sd_logk_lo = LOGKMIN
        si.sd_dlogk = DELTALOGK
        for nm in ("w1", "w2", "w31", "w32", "dv1", "dv2", "dv31", "dv32"):
            setattr(si, "sd_" + nm, p(sd_tabs[nm], _f64p))
        si.sd_rad_gm0 = float(scaledep_gm.Rad_GM[0])
        si.sd_nsmooth = len(logk_displ)
        si.sd_logk_displ = p(logk_displ, _f64p)
        si.sd_logk_part = float(logk_displ[-1])
        si.sd_ipd = params.InterPartDist

    if segments is not None:
        # segment plumbing (build_groups.c:1578-1592); nseg == len(output_z)
        segF = np.ascontiguousarray(params.output_F, np.float64)
        if len(segments) != len(segF):
            raise ValueError(f"{len(segments)} displacement sets for "
                             f"{len(segF)} output redshifts")
        segw = _segment_weight_tables(params, cosmo, scaledep_gm,
                                      n=len(tabs["w1"]))
        keepalive += [segF, segw]
        si.nseg = len(segments)
        si.segF = p(segF, _f64p)
        for k in keys:
            arr_t = (_f32p * len(segments))(
                *[p(vs[k], _f32p) for vs in segments])
            keepalive.append(arr_t)
            setattr(si, "seg_" + k, arr_t)
            setattr(si, "seg_w" + k[1:], p(segw["w" + k[1:]], _f64p))

    cb = _CaptureBuffers(name=p(cap_name, _u64p), mass=p(cap_mass, _i32p),
                         q=p(cap_q, _f32p), x=p(cap_x, _f32p),
                         v=p(cap_v, _f32p), count=p(cap_count, _i32p))
    so = _SweepOutput(mass=p(g_mass, _i32p), name=p(g_name, _u64p),
                      halo_app=p(g_halo_app, _i32p), ll=p(g_ll, _i32p),
                      merged_with=p(g_mw, _i32p),
                      mass_at_merger=p(g_mam, _i32p),
                      t_appear=p(g_tap, _f32p), t_peak=p(g_tpk, _f32p),
                      t_merge=p(g_tmg, _f32p),
                      good=p(g_good, _u8p), alive=p(g_alive, _u8p),
                      ngroups=p(g_ngroups, _i32p),
                      counters=p(counters, _u64p),
                      group_of_particle=p(gop, _i32p),
                      zacc=p(zacc, _f32p), gq=p(g_q, _f32p))

    # the past light cone's inputs and output buffers (cap crossings)
    plc_on = plc_geom is not None and plc_geom.enabled
    pi = po = None
    if plc_on:
        plc_cap = 4 * plc_geom.Nmax
        plc_name = np.zeros(plc_cap, np.uint64)
        plc_z = np.zeros(plc_cap, np.float32)
        plc_mass = np.zeros(plc_cap, np.int32)
        plc_x = np.zeros(plc_cap * 3, np.float32)
        plc_v = np.zeros(plc_cap * 3, np.float32)
        plc_nz = np.zeros(max(plc_geom.nzbins, 1), np.float64)
        plc_count = np.zeros(1, np.int64)
        plc_over = np.zeros(1, np.int32)
        repl_ijk = np.ascontiguousarray(plc_geom.repls_ijk.ravel(), np.int32)
        repl_F1 = np.ascontiguousarray(plc_geom.repls_F1, np.float64)
        repl_F2 = np.ascontiguousarray(plc_geom.repls_F2, np.float64)
        keepalive += [repl_ijk, repl_F1, repl_F2]
        pi = _PlcInput(
            enabled=1, Fstart=plc_geom.Fstart, Fstop=plc_geom.Fstop,
            center=(ctypes.c_double * 3)(*plc_geom.center),
            zvers=(ctypes.c_double * 3)(*plc_geom.zvers),
            ipd=params.InterPartDist, aperture=params.PLCAperture,
            brent_err=1e-2 * params.InterPartDist, nrepl=len(repl_F1),
            repl_ijk=p(repl_ijk, _i32p), repl_F1=p(repl_F1, _f64p),
            repl_F2=p(repl_F2, _f64p), tab_rF=p(tabs["rF"], _f64p),
            nzbins=plc_geom.nzbins, delta_z=plc_geom.delta_z,
            z_last=min(params.StartingzForPLC, params.LastzForPLC),
            cap=plc_cap)
        po = _PlcOutput(name=p(plc_name, _u64p), zred=p(plc_z, _f32p),
                        mass=p(plc_mass, _i32p), x=p(plc_x, _f32p),
                        v=p(plc_v, _f32p), nz=p(plc_nz, _f64p),
                        count=p(plc_count, _i64p),
                        overflow=p(plc_over, _i32p))

    t0 = time.perf_counter()
    rc = _sweep_lib().sweep(ctypes.byref(si), ctypes.byref(cb),
                            ctypes.byref(so),
                            ctypes.byref(pi) if plc_on else None,
                            ctypes.byref(po) if plc_on else None)
    timings["sweep"] = time.perf_counter() - t0
    if stream is not None:
        # a failed copy released the watermark: raise, not halos
        stream.check()
        timings["stream_wait"] = float(waited[0]) * 1e-9
    if rc == -2 and n > 0:
        # group capacity estimate too small: regrow and redo, with fresh
        # PLC buffers (the reference aborts at PredNpeaks instead,
        # build_groups.c:357)
        if verbose:
            print(f"  group capacity {maxg} overflowed, retrying x2")
        return run_fragmentation(params, cosmo, fmax_result,
                                 plc_geom=plc_geom, scaledep_gm=scaledep_gm,
                                 geom=geom, cell_mask=cell_mask, quick=quick,
                                 verbose=verbose,
                                 _maxg_override=2 * maxg + 8192)
    if rc != 0:
        raise RuntimeError(f"group sweep failed with code {rc} "
                           f"(-2 = peak-capacity overflow)")

    catalogs = []
    stabl_f = np.asarray(geom.stabl, np.float32)
    Gf = np.asarray(geom.G, np.float32)
    for iout, z in enumerate([] if quick else params.output_z):
        c = int(cap_count[iout])
        base = iout * maxg
        q = cap_q[3 * base:3 * (base + c)].reshape(-1, 3) + stabl_f
        x = cap_x[3 * base:3 * (base + c)].reshape(-1, 3) + stabl_f
        catalogs.append(CatalogSnapshot(
            z=z, name=cap_name[base:base + c].copy(),
            mass=cap_mass[base:base + c].copy(),
            q=np.mod(q, Gf), x=np.mod(x, Gf),
            v=cap_v[3 * base:3 * (base + c)].reshape(-1, 3).copy()))

    ng = int(g_ngroups[0])
    # group ids only ever grow, so the final count is the peak count
    npeaks = max(ng - 1, 0)
    pred_npeaks = int(ncells / 6.0 * params.PredPeakFactor)
    if npeaks + 2 > pred_npeaks and verbose:
        print(f"WARNING: {npeaks} peaks exceed the PredPeakFactor "
              f"prediction ({pred_npeaks}); the reference would "
              f"abort — set PredPeakFactor >= {npeaks * 6.0 / ncells:4.2f}")
    groups = GroupState(
        ngroups=ng, mass=g_mass[:ng + 1], name=g_name[:ng + 1],
        halo_app=g_halo_app[:ng + 1], ll=g_ll[:ng + 1],
        merged_with=g_mw[:ng + 1], mass_at_merger=g_mam[:ng + 1],
        t_appear=g_tap[:ng + 1], t_peak=g_tpk[:ng + 1],
        t_merge=g_tmg[:ng + 1], good=g_good[:ng + 1], alive=g_alive[:ng + 1])

    plc = None
    if plc_on:
        nplc = int(plc_count[0])
        plc = PlcResult(
            name=plc_name[:nplc].copy(), z=plc_z[:nplc].copy(),
            mass=plc_mass[:nplc].copy(),
            x=plc_x[:3 * nplc].reshape(-1, 3).copy(),
            v=plc_v[:3 * nplc].reshape(-1, 3).copy(),
            nz=plc_nz.copy(), overflow=bool(plc_over[0]))
        if verbose:
            print(f"  PLC: stored {nplc} halo crossings"
                  + (" (OVERFLOW)" if plc.overflow else ""))

    # the timeless snapshot's GRUP: each particle's group name, with
    # groups[0].name = 0 and groups[FILAMENT].name = FILAMENT
    particle_grup = None
    if params.WriteTimelessSnapshot and not quick:
        names = g_name[:ng + 1].copy()
        names[0] = 0
        if ng >= FILAMENT:
            names[FILAMENT] = FILAMENT
        particle_grup = names[gop]

    timings["total"] = time.perf_counter() - t_all
    if verbose:
        print(f"  sweep: {timings['sweep']:.2f}s; peaks {counters[0]}, "
              f"good halos {counters[14]}, accretions {counters[7]}, "
              f"mergers {counters[10]}, filament particles {counters[12]}")
    return FragmentResult(catalogs=catalogs, groups=groups,
                          counters=counters, npeaks=npeaks, nstored=n,
                          plc=plc, particle_pos=pos, particle_zacc=zacc,
                          particle_grup=particle_grup, timings=timings,
                          best_pred_peak_factor=npeaks * 6.0 / ncells,
                          groups_q=g_q[:3 * (ng + 1)].reshape(-1, 3))
