"""Multi-sub-box fragmentation (counterpart of pinocchio_tpu/fragment/
subbox.py): the domain decomposition of the reference's V5 fragmentation
(set_subboxes, initialization.c:933-1140).

The grid is split into nbox[0] x nbox[1] x nbox[2] sub-volumes, each padded
with a boundary layer ('safe') of BoundaryLayerFactor times the Lagrangian
radius of the largest expected halo.  Each sub-volume runs the same native
sweep on its own, with no communication during group building
(DOCUMENTATION:127-133), and keeps only the halos whose peak lies in its
well-resolved region, so the union over sub-boxes is exact up to the
boundary layer's truncation of the largest halos.

The V5 two-turn scheme (fragment.c:159-316) sweeps a sub-box twice: a quick
pass over the well-resolved region and a 1-cell rim finds the halos, the
native map_update asks for a sphere of the boundary layer around each, and
the full pass sweeps that union.  Single-turn sweeps the whole padded box.

The sub-boxes are swept concurrently on a thread pool: the native sweep
releases the GIL and keeps its state per thread, and every thread reads the one
copy of the products.  While the rows still stream from the device (either
engine's overlapped hand-off), every sweep of every sub-box, the two-turn quick
passes too, waits on the one rows_ready watermark.  An exception in any
sub-box's sweep fails the run (ThreadPoolExecutor.map re-raises it).

With a host slice (h, H) a host sweeps only its round-robin share of the
sub-boxes.  When the products are a mesh run's deferred hand-off over a
mesh whose size H divides, its rows come through the exchange
(parallel/exchange.py): the padded volumes in one turn, or the two-turn
wire protocol (turn 0 the resolved regions, the quick passes, turn 1 the
boundary spheres); otherwise it reads the whole products.
"""

from __future__ import annotations

import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from .. import native
from ..config import Params
from ..cosmology import Cosmology
from .driver import (CatalogSnapshot, FragmentResult, PlcResult,
                     SubboxGeometry, run_fragmentation, _f32p, _i32p, _u8p)


def _exchange_mesh(fmax_result, nhosts: int):
    """The mesh to run the exchange over: the deferred hand-off's, when its
    size is above 1 and nhosts divides it; else None.  A mesh split over
    processes must be split over nhosts of them (which then divide it)."""
    handoff = fmax_result.handoff
    if handoff is None:
        return None
    mesh = handoff.decomp.mesh
    if mesh.procs is not None and mesh.procs[1] != nhosts:
        raise ValueError(f"{nhosts} hosts over a mesh split over "
                         f"{mesh.procs[1]} processes: a process is a host")
    if mesh.size > 1 and mesh.size % nhosts == 0:
        return mesh
    return None


def _host_copy(fmax_result, host_slice=None, all_geoms=None,
               verbose=False):
    """The products this host sweeps: with a host slice over a mesh's
    deferred hand-off, its share from the exchange (a mesh whose size the
    host count divides, as a mesh split over processes always is) or from
    the local fetch of every shard (the JAX package's branch for other
    meshes, which is the whole products in one process); else the whole
    products."""
    import dataclasses

    from ..fmax import ensure_host_products
    if host_slice is not None and host_slice[1] > 1 \
            and fmax_result.handoff is not None:
        if _exchange_mesh(fmax_result, host_slice[1]) is not None:
            from ..parallel.exchange import exchange_products
            sp = exchange_products(fmax_result, all_geoms, host_slice[1],
                                   hosts=host_slice[:1],
                                   verbose=verbose)[host_slice[0]]
        else:
            from ..parallel.multihost import fetch_local_sparse
            sp = fetch_local_sparse(fmax_result)
        return dataclasses.replace(fmax_result, host_products=sp,
                                   handoff=None)
    ensure_host_products(fmax_result)
    return fmax_result


def pool_workers() -> int:
    """Threads of the sub-box pool: ThreadPoolExecutor's default,
    min(32, cores + 4)."""
    return min(32, (os.cpu_count() or 1) + 4)


def find_start(L: int, n: int, ibox: int) -> int:
    # initialization.c:1142-1159
    if n == 1:
        return 0
    LL, MM = L // n, L % n
    if ibox == 0:
        return 0
    if ibox <= MM:
        return ibox * (LL + 1)
    return ibox * LL + MM


def find_length(L: int, n: int, ibox: int) -> int:
    # initialization.c:1161-1179
    if n == 1:
        return L
    LL, MM = L // n, L % n
    return LL + 1 if ibox < MM else LL


def choose_nbox(params: Params, cosmo: Cosmology, largest_mass: float,
                ntasks: int) -> Tuple[int, int, int]:
    """The factorization of ntasks with the least communicated boundary
    surface (set_subboxes, initialization.c:958-994)."""
    N = params.GridSize
    sizeG = float(cosmo.SizeForMass(largest_mass)) / params.InterPartDist
    best, best_surface = (1, 1, ntasks), float("inf")
    for k in range(1, ntasks + 1):
        if ntasks % k:
            continue
        for j in range(1, ntasks // k + 1):
            if (ntasks // k) % j:
                continue
            i = ntasks // k // j
            N1 = find_length(N, i, 0)
            N2 = find_length(N, j, 0)
            N3 = find_length(N, k, 0)
            this = ((2 * N2 * N3 if i > 1 else 0)
                    + (2 * N1 * N3 if j > 1 else 0)
                    + (2 * N1 * N2 if k > 1 else 0))
            tt = this
            if N1 / 2 < sizeG:
                this += tt * (2 * sizeG / N1) ** 2
            if N2 / 2 < sizeG:
                this += tt * (2 * sizeG / N2) ** 2
            if N3 / 2 < sizeG:
                this += tt * (2 * sizeG / N3) ** 2
            if this < best_surface:
                best_surface = this
                best = (i, j, k)
    return best


def subbox_geometries(params: Params, cosmo: Cosmology, largest_mass: float,
                      nbox: Tuple[int, int, int]) -> List[SubboxGeometry]:
    """Every sub-box's geometry with its boundary layers
    (initialization.c:1011-1057), x slowest."""
    N = params.GridSize
    sizeG = float(cosmo.SizeForMass(largest_mass)) / params.InterPartDist
    BB = int(params.BoundaryLayerFactor * sizeG + 1)
    geoms = []
    for bx in range(nbox[0]):
        for by in range(nbox[1]):
            for bz in range(nbox[2]):
                mybox = (bx, by, bz)
                Lgrid = [find_length(N, nbox[d], mybox[d]) for d in range(3)]
                pbc = [1 if nbox[d] == 1 else 0 for d in range(3)]
                safe = [0 if pbc[d] else
                        min(BB, N // 2 - Lgrid[d] // 2 - 1)
                        for d in range(3)]
                Lgwbl = [Lgrid[d] + 2 * safe[d] for d in range(3)]
                start = [find_start(N, nbox[d], mybox[d]) for d in range(3)]
                stabl = [start[d] - safe[d] for d in range(3)]
                geoms.append(SubboxGeometry(
                    L=tuple(Lgwbl), pbc=tuple(pbc), safe=tuple(safe),
                    stabl=tuple(stabl), G=(N, N, N)))
    return geoms


def turn0_bounds(geom: SubboxGeometry):
    """The turn-0 map box: the well-resolved region plus a 1-cell rim on
    each non-periodic side (create_map, fragment.c:708-751), as the lower
    and upper bounds (r1, r2) per dimension."""
    r1, r2 = [], []
    for d in range(3):
        if geom.pbc[d]:
            r1.append(0)
            r2.append(geom.L[d])
        else:
            r1.append(max(0, geom.safe[d] - 1))
            r2.append(min(geom.L[d], geom.L[d] - geom.safe[d] + 1))
    return r1, r2


def _map_update_lib():
    lib = native.load("groupsweep")
    if not getattr(lib, "_map_update_sig", False):
        lib.map_update.restype = ctypes.c_int
        lib.map_update.argtypes = [
            ctypes.c_int32, _i32p, _f32p, _i32p, _i32p, _i32p, _i32p,
            _u8p, ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
        lib._map_update_sig = True
    return lib


def boundary_sphere_map(params: Params, geom: SubboxGeometry, quick_res,
                        r1, r2):
    """The native update_map (build_groups.c:2246-2318): around each quick
    pass group's Lagrangian CM, ask for a sphere of radius
    BoundaryLayerFactor * R_Lag(mass); returns (add_map[ncells] uint8,
    counts[2]) with counts = (cells added, requested cells beyond the
    boundary layer)."""
    lib = _map_update_lib()
    add = np.zeros(int(np.prod(geom.L)), np.uint8)
    counts = np.zeros(2, np.int64)
    g = quick_res.groups
    mass = np.ascontiguousarray(g.mass, np.int32)
    gq = np.ascontiguousarray(quick_res.groups_q, np.float32)

    def arr3(v):
        return np.ascontiguousarray(v, np.int32)
    L, pbc, a1, a2 = arr3(geom.L), arr3(geom.pbc), arr3(r1), arr3(r2)
    rc = lib.map_update(
        np.int32(g.ngroups), mass.ctypes.data_as(_i32p),
        gq.ctypes.data_as(_f32p), L.ctypes.data_as(_i32p),
        pbc.ctypes.data_as(_i32p), a1.ctypes.data_as(_i32p),
        a2.ctypes.data_as(_i32p), add.ctypes.data_as(_u8p),
        ctypes.c_double(params.BoundaryLayerFactor),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError(f"map_update failed with code {rc}")
    return add, counts


def run_fragmentation_two_turn(params: Params, cosmo: Cosmology,
                               fmax_result, geom: SubboxGeometry,
                               plc_geom=None, scaledep_gm=None,
                               verbose: bool = False) -> FragmentResult:
    """The V5 two-turn scheme for one sub-box (fragment.c:159-316): turn 0
    keeps only the well-resolved region and a 1-cell rim and runs the quick
    sweep; update_map adds the boundary-layer spheres around the halos it
    found; turn 1 sweeps that union in full.  Sweep work and memory scale
    with the collapsed part of the resolved region, not of the padded box.
    The result's timings carry the quick pass's seconds ("quick") and the
    map's counts ("boundary_requested", "beyond_boundary")."""
    t0 = time.perf_counter()
    r1, r2 = turn0_bounds(geom)
    base = np.zeros(geom.L, np.uint8)
    base[r1[0]:r2[0], r1[1]:r2[1], r1[2]:r2[2]] = 1
    base = base.ravel()
    qres = run_fragmentation(params, cosmo, fmax_result, geom=geom,
                             scaledep_gm=scaledep_gm, cell_mask=base,
                             quick=True, verbose=False)
    add, counts = boundary_sphere_map(params, geom, qres, r1, r2)
    quick_wait = qres.timings.get("stream_wait")
    del qres                    # its arrays are not needed by turn 1
    np.bitwise_or(base, add, out=base)
    del add
    t_quick = time.perf_counter() - t0
    res = run_fragmentation(params, cosmo, fmax_result, plc_geom=plc_geom,
                            scaledep_gm=scaledep_gm, geom=geom,
                            cell_mask=base, verbose=False)
    res.timings["quick"] = t_quick
    if quick_wait is not None:
        res.timings["stream_wait"] += quick_wait
    res.timings["boundary_requested"] = float(counts[0])
    res.timings["beyond_boundary"] = float(counts[1])
    if verbose:
        print(f"  two-turn: {int(counts[0])} boundary particles "
              f"requested, {res.nstored} stored"
              + (f", {int(counts[1])} beyond the boundary layer"
                 if counts[1] else ""))
    return res


def quick_pass_spheres(params: Params, geom: SubboxGeometry, quick_res,
                       r1, r2) -> np.ndarray:
    """The boundary-request spheres of one sub-box's quick pass in global
    grid coordinates: float32 rows (cx, cy, cz, radius in cells) of every
    group whose request sphere (BoundaryLayerFactor x R_Lagrangian,
    update_map build_groups.c:2252-2262) reaches beyond the turn-0 region.
    They cross hosts instead of the reference's per-cell frag_map_update
    bitmap (distribute.c:689-698)."""
    g = quick_res.groups
    if g.ngroups <= 1:
        return np.zeros((0, 4), np.float32)
    mass = np.asarray(g.mass[2:g.ngroups + 1], np.float64)
    c = quick_res.groups_q[2:g.ngroups + 1].astype(np.int32)
    size = (params.BoundaryLayerFactor
            * np.cbrt(mass / 4.188790205) + 0.5).astype(np.int32)
    # a sphere is needed unless it lies inside along every non-periodic
    # dimension (map_update's fast path, groupsweep.c:1499-1505)
    fully = np.ones(len(mass), bool)
    for d in range(3):
        if not geom.pbc[d]:
            fully &= (c[:, d] - size >= r1[d]) & (c[:, d] + size < r2[d])
    keep = (mass > 0) & (size > 0) & ~fully
    N = geom.G[0]
    out = np.empty((int(keep.sum()), 4), np.float32)
    out[:, :3] = (c[keep] + np.asarray(geom.stabl, np.int32)) % N
    out[:, 3] = size[keep]
    return out


def _allgather_spheres(sph: np.ndarray, host_id: int, nhosts: int,
                       procs: tuple = None) -> dict:
    """Every host's sphere list, which the turn-1 exchange packs by: over a
    mesh split over processes (procs), one all-gather of the [n, 4]
    float32 lists of the group, their sizes first.  In one process each
    mocked host runs its own exchanges, and a host's rows depend on its own
    spheres alone (K17 paints each host's map with its own), so its own
    list is the one that matters."""
    if procs is None:
        return {host_id: sph}
    from ..parallel.multihost import all_gather_rows
    return dict(enumerate(all_gather_rows(
        "gather", np.asarray(sph, np.float32).reshape(-1, 4))))


def _base_mask(geom: SubboxGeometry):
    r1, r2 = turn0_bounds(geom)
    base = np.zeros(geom.L, np.uint8)
    base[r1[0]:r2[0], r1[1]:r2[1], r1[2]:r2[2]] = 1
    return base.ravel(), r1, r2


def _two_turn_exchange(params: Params, cosmo: Cosmology, fmax_result,
                       all_geoms, my_geoms, host_slice, scaledep_gm=None,
                       verbose: bool = False):
    """The V5 two-turn scheme across hosts (fragment.c:159-316 with
    distribute.c's two-pass maps): the turn-0 exchange ships each host's
    well-resolved regions and 1-cell rim, the quick passes find the halos,
    and the turn-1 exchange ships the cells of their boundary spheres.
    Returns (fmax_result with this host's merged products, each own
    sub-box's cell mask for the full sweep, quick-pass seconds, the
    particle copies of turn 0 and turn 1)."""
    import dataclasses

    from ..parallel.exchange import exchange_products, merge_sparse
    h, H = host_slice
    t0 = time.perf_counter()
    sp0 = exchange_products(fmax_result, all_geoms, H, turn=0, hosts=(h,),
                            verbose=verbose)[h]
    fr0 = dataclasses.replace(fmax_result, host_products=sp0, handoff=None)

    def quick_one(geom):
        base, r1, r2 = _base_mask(geom)
        if all(geom.pbc):
            return base, None
        qres = run_fragmentation(params, cosmo, fr0, geom=geom,
                                 scaledep_gm=scaledep_gm, cell_mask=base,
                                 quick=True, verbose=False)
        add, _ = boundary_sphere_map(params, geom, qres, r1, r2)
        return base | add, quick_pass_spheres(params, geom, qres, r1, r2)

    if len(my_geoms) == 1:
        quick_out = [quick_one(my_geoms[0])]
    else:
        with ThreadPoolExecutor(max_workers=pool_workers()) as ex:
            quick_out = list(ex.map(quick_one, my_geoms))
    masks = [m for m, _ in quick_out]
    parts = [s for _, s in quick_out if s is not None]
    t_quick = time.perf_counter() - t0
    sph = np.concatenate(parts) if parts else np.zeros((0, 4), np.float32)
    procs = fmax_result.handoff.decomp.mesh.procs
    sp1 = exchange_products(fmax_result, all_geoms, H, turn=1,
                            spheres=_allgather_spheres(sph, h, H, procs),
                            hosts=(h,), verbose=verbose)[h]
    sp = merge_sparse(sp0, sp1)
    if verbose:
        print(f"  two-turn exchange: {len(sp0.ci)} resolved + "
              f"{len(sp.ci) - len(sp0.ci)} boundary particle-copies "
              f"({len(sph)} spheres), quick passes {t_quick:.1f} s")
    return (dataclasses.replace(fmax_result, host_products=sp, handoff=None),
            masks, t_quick, (len(sp0.ci), len(sp.ci) - len(sp0.ci)))


def _resolved_particles(geom: SubboxGeometry, res: FragmentResult, N: int):
    """One sub-box's share of the distribute_back analog (distribute.c:
    718-948): its per-particle zacc and group name over its well-resolved
    region (the boundary-layer copies are dropped, keep_data_back's
    good_particle test, distribute.c:813-817), with positions turned from
    local to global grid indices, so that the timeless snapshot scatters
    them.  Returns (pos int64, zacc, grup)."""
    pos = res.particle_pos.astype(np.int64)
    Ly, Lz = geom.L[1], geom.L[2]
    k = pos % Lz
    j = (pos // Lz) % Ly
    i = pos // (Lz * Ly)
    good = np.ones(len(pos), bool)
    for d, c in ((0, i), (1, j), (2, k)):
        if geom.safe[d]:
            good &= (c >= geom.safe[d]) & (c < geom.L[d] - geom.safe[d])
    gi = (i[good] + geom.stabl[0]) % N
    gj = (j[good] + geom.stabl[1]) % N
    gk = (k[good] + geom.stabl[2]) % N
    return ((gi * N + gj) * N + gk, res.particle_zacc[good],
            res.particle_grup[good])


def single_turn_bytes(params: Params, cosmo: Cosmology, geoms) -> float:
    """Predicted host bytes of sweeping every sub-box's whole padded volume
    (single-turn): padded cells x collapsed fraction x the per-particle
    payload (F, pos, displacement rows, group id, zacc), as the JAX
    package's memory-driven default counts them."""
    from ..planner import collapsed_fraction
    frac = collapsed_fraction(params, cosmo)
    nfields = {1: 1, 2: 2, 3: 4}[params.lpt_order]
    per_particle = 4 + 4 + 3 * nfields * 4 + 4 + 4
    padded = sum(float(np.prod(g.L)) for g in geoms)
    return padded * frac * per_particle


def default_two_turn(params: Params, cosmo: Cosmology, geoms) -> bool:
    """The memory-driven default: the two-turn scheme costs a second sweep
    of the well-resolved region (the quick pass), so take single-turn when
    its padded volumes fit in half the host's memory, and the V5
    needed-particle scheme when they would not (the reference is always
    two-turn because its MPI hosts are memory-bound, fragment.c:159-316).
    ClassicFragmentation forces single-turn."""
    from ..planner import host_memory
    return (not params.classic_fragmentation
            and single_turn_bytes(params, cosmo, geoms)
            > 0.5 * host_memory())


def run_fragmentation_multibox(params: Params, cosmo: Cosmology,
                               fmax_result, nbox, plc_geom=None,
                               scaledep_gm=None, largest_mass=None,
                               two_turn: bool = None,
                               host_slice: Tuple[int, int] = None,
                               verbose: bool = True) -> FragmentResult:
    """Fragment the box as nbox independent sub-domains, swept concurrently
    on pool_workers() threads, and merge their catalogs, counters, timings,
    past light cones and group states (groups: one GroupState per
    sub-box).  two_turn: the V5 needed-particle scheme; default_two_turn
    decides when None.  A sub-box periodic in every direction has no
    boundary layer and always takes the single-turn sweep
    (fragment.c:190-199 all_pbc).  Timings: "total" is the slowest
    sub-box's (of its second turn, with two), "sort", "sweep", "quick" and
    "stream_wait" (the seconds the sweeps waited on a streamed hand-off's
    watermark) the sums over sub-boxes, "overhead" the stored particles
    over N^3, and
    "boundary_requested" / "beyond_boundary" the two-turn map's counts
    summed.  host_slice=(h, H): this host sweeps its round-robin share of
    the sub-boxes (a host that owns none raises ValueError) from the
    products _host_copy or _two_turn_exchange gives it; "transfer" times
    that, and "turn0_copies" / "turn1_copies" count the two-turn
    exchange's rows."""
    if largest_mass is None:
        from ..io.catalogs import largest_halo_mass
        largest_mass = largest_halo_mass(params, cosmo)
    geoms = subbox_geometries(params, cosmo, largest_mass, nbox)
    if two_turn is None:
        two_turn = default_two_turn(params, cosmo, geoms)
    all_geoms = geoms
    multi_host = host_slice is not None and host_slice[1] > 1
    if multi_host:
        from ..parallel.multihost import host_subboxes
        geoms = host_subboxes(geoms, *host_slice)
        if not geoms:
            raise ValueError(f"host {host_slice[0]} owns no sub-box "
                             f"(nbox={tuple(nbox)}, nhosts={host_slice[1]})")
    if verbose:
        g0 = geoms[0]
        print(f"  fragmentation over {len(geoms)} sub-boxes {tuple(nbox)}; "
              f"box 0: L={g0.L} safe={g0.safe}"
              + (" (two-turn)" if two_turn else ""))

    t_copy = time.perf_counter()
    masks, t_quick, copies = None, 0.0, None
    if multi_host and two_turn:
        if (_exchange_mesh(fmax_result, host_slice[1]) is not None
                and any(not all(g.pbc) for g in geoms)):
            # the quick passes run between the two exchanges, so that only
            # resolved and sphere-selected boundary cells cross hosts
            fmax_result, masks, t_quick, copies = _two_turn_exchange(
                params, cosmo, fmax_result, all_geoms, geoms, host_slice,
                scaledep_gm=scaledep_gm, verbose=verbose)
    if masks is None:
        fmax_result = _host_copy(fmax_result, host_slice=host_slice,
                                 all_geoms=all_geoms, verbose=verbose)
    t_copy = time.perf_counter() - t_copy - t_quick

    def one(args):
        i, geom = args
        if masks is not None:
            # the quick pass ran inside the two-turn exchange
            res = run_fragmentation(params, cosmo, fmax_result,
                                    plc_geom=plc_geom,
                                    scaledep_gm=scaledep_gm, geom=geom,
                                    cell_mask=masks[i], verbose=False)
        elif two_turn and not all(geom.pbc):
            res = run_fragmentation_two_turn(
                params, cosmo, fmax_result, geom, plc_geom=plc_geom,
                scaledep_gm=scaledep_gm, verbose=False)
        else:
            res = run_fragmentation(params, cosmo, fmax_result,
                                    plc_geom=plc_geom,
                                    scaledep_gm=scaledep_gm, geom=geom,
                                    verbose=False)
        if params.WriteTimelessSnapshot:
            # the timeless snapshot's share of this sub-box, on its thread
            (res.particle_pos, res.particle_zacc,
             res.particle_grup) = _resolved_particles(geom, res,
                                                      params.GridSize)
        return res

    if len(geoms) == 1:
        results = [one((0, geoms[0]))]
    else:
        with ThreadPoolExecutor(max_workers=pool_workers()) as ex:
            results = list(ex.map(one, enumerate(geoms)))

    catalogs = []
    for iout, z in enumerate(params.output_z):
        parts = [r.catalogs[iout] for r in results]
        catalogs.append(CatalogSnapshot(
            z=z, name=np.concatenate([s.name for s in parts]),
            mass=np.concatenate([s.mass for s in parts]),
            q=np.concatenate([s.q for s in parts]),
            x=np.concatenate([s.x for s in parts]),
            v=np.concatenate([s.v for s in parts])))
    counters = np.sum([r.counters for r in results], axis=0)
    nstored = sum(r.nstored for r in results)
    timings = {"total": max(r.timings["total"] for r in results),
               **{k: sum(r.timings.get(k, 0.0) for r in results)
                  for k in ("sort", "sweep", "quick", "boundary_requested",
                            "beyond_boundary", "stream_wait")},
               "overhead": nstored / float(params.GridSize) ** 3,
               "transfer": t_copy}
    timings["quick"] += t_quick
    if copies is not None:
        timings["turn0_copies"], timings["turn1_copies"] = map(float, copies)
    merged = FragmentResult(
        catalogs=catalogs, groups=[r.groups for r in results],
        counters=counters, npeaks=sum(r.npeaks for r in results),
        nstored=nstored, timings=timings,
        best_pred_peak_factor=max(r.best_pred_peak_factor for r in results))
    if params.WriteTimelessSnapshot:
        # each stored well-resolved cell once, in global grid indices
        merged.particle_pos = np.concatenate(
            [r.particle_pos for r in results])
        merged.particle_zacc = np.concatenate(
            [r.particle_zacc for r in results])
        merged.particle_grup = np.concatenate(
            [r.particle_grup for r in results])
    if results[0].plc is not None:
        merged.plc = PlcResult(
            name=np.concatenate([r.plc.name for r in results]),
            z=np.concatenate([r.plc.z for r in results]),
            mass=np.concatenate([r.plc.mass for r in results]),
            x=np.concatenate([r.plc.x for r in results]),
            v=np.concatenate([r.plc.v for r in results]),
            nz=np.sum([r.plc.nz for r in results], axis=0),
            overflow=any(r.plc.overflow for r in results))
    if verbose:
        msg = (f"  merged: {counters[0]} peaks, {counters[14]} good halos; "
               f"stored/total overhead {timings['overhead']:.3f}")
        if two_turn:
            msg += (f" ({int(timings['boundary_requested'])} boundary "
                    f"particles requested)")
        print(msg)
        if timings["beyond_boundary"]:
            print(f"  WARNING: {int(timings['beyond_boundary'])} requested "
                  f"particles lie beyond the boundary layer, some halos may "
                  f"be inaccurate")
    return merged
