"""Memory planner of the port: the peak device memory of the dense and of the
out-of-core fmax engine on one card or on each device of a mesh, array by
array and phase by phase, the
host memory of the sweep (one box, or the sub-boxes swept at once), the
sub-box decomposition, the engine choice and the pre-flight abort (the port's counterpart of pinocchio_tpu/planner.py; the reference's
bounded-memory contract, allocations.c:37-251, and its abort with the
per-array map, allocations.c:274-324).

The arrays are the port's own (fmax.run_fmax, fmax_ooc.run_fmax_ooc,
fragment/driver.py), counted in bytes for the grid, the number of
displacement fields and sets, and the predicted collapsed fraction.  The card
is read from torch (``total_memory``); a CPU device's memory is the host's.
"""

from __future__ import annotations

import math
import os

import torch

from .config import Params
from .cosmology import Cosmology

GiB = float(2 ** 30)
DELTA_C = 1.686
GROWTH_NTAB = 512       # entries of a growth table (fmax.growth_k_tables)
# torch.sort of the whole grid (ops.compact.needed_order) in units of one
# float32 field: the key and its mask (1.25), the int64 iota (2), the sorted
# keys and indices (3) and the radix sort's work area (about 4): the
# out-of-core needed phase measured 10.3 fields above its resident arrays on
# an H100 at 512^3 (chip_smoke.py prints the comparison)
SORT_FIELDS = 10.25
# per peak-group host bytes of the sweep (fragment/driver.py and
# groupsweep.c group arrays) and groups per stored particle
GROUP_BYTES = 108
GROUP_BYTES_PER_OUTPUT = 48
GROUP_BYTES_PER_FIELD = 24
PEAKS_PER_STORED = 0.12


class MemoryPlanError(MemoryError):
    """The chosen engine's predicted memory exceeds what the run has (the
    reference's pre-flight abort, allocations.c:317-324)."""


def collapsed_fraction(params: Params, cosmo: Cosmology, sm=None) -> float:
    """Predicted fraction of cells with Fmax >= Flast: Press-Schechter
    counting, 2 P(delta > delta_c / D(zlast)) at the grid-scale variance (the
    JAX planner's estimate; measured 0.668 at 32^3 for the HMF_Validation
    switches against 0.64 predicted)."""
    if sm is None:
        from .fmax import Smoothing
        sm = Smoothing.build(params, cosmo)
    sigma = math.sqrt(sm.variance[-1])
    D = float(cosmo.GrowingMode(params.zlast, params.k_for_GM))
    return min(1.0, math.erfc(DELTA_C / (sigma * D) / math.sqrt(2.0)))


def _sizes(params: Params, frac: float) -> dict:
    N = params.GridSize
    Nh = N // 2 + 1
    return dict(
        N=N,
        f=4.0 * N ** 3,                      # one float32 field
        k=8.0 * N * N * Nh,                  # one complex64 rfft spectrum
        count=frac * N ** 3,                 # needed cells
        nf={1: 1, 2: 2, 3: 4}[params.lpt_order],
        nseg=(len(params.output_z) if params.recompute_displacements
              else 1))


def _dense_phases(params: Params, frac: float) -> dict:
    """The dense engine's (fmax.run_fmax) arrays at each phase's peak."""
    s = _sizes(params, frac)
    f, k, count = s["f"], s["k"], s["count"]
    nf, nseg = s["nf"], s["nseg"]
    # cuFFT's work area of a batched c2r (calibrated on the measured peaks)
    fft = dict(fft_workspace=6 * k)
    cycle = dict(delta=k, fmax_rmax=2 * f, hessian_kspace=6 * k,
                 ifft2_out=6 * k, c2r_input_copy=6 * k, hessian_stack=6 * f,
                 **fft)
    sort = dict(delta=k, fmax_rmax=2 * f, hessian_stack=6 * f,
                needed_sort=SORT_FIELDS * f)
    sources = dict(delta=k, fmax_rmax=2 * f, needed_order=2 * f,
                   hessian_stack=6 * f, real_sources=2 * f, q2_spectrum=k,
                   phi2_kspace=6 * k, ifft2_out=6 * k, c2r_input_copy=6 * k,
                   phi2_stack=6 * f, **fft)
    packed = 4.0 * count * (2 + 3 * nf * nseg)
    # the hand-off's rank field lives through every set
    displ = dict(delta=k, fmax_rmax=2 * f, needed_order=2 * f,
                 needed_rank=f, source_spectra=(nf - 1) * k, packed_rows=packed,
                 displacement_set=3 * nf * f, gradient_kspace=3 * k,
                 ifft2_out=3 * k, c2r_input_copy=3 * k, **fft)
    # one set's rows into the packed buffer: gather_rows' row records (32 B
    # a row) beside the set's stacks, once its transforms' buffers are gone
    gather = dict(delta=k, fmax_rmax=2 * f, needed_order=2 * f,
                  needed_rank=f, source_spectra=(nf - 1) * k,
                  packed_rows=packed, displacement_set=3 * nf * f,
                  row_records=32.0 * count)
    return {"collapse cycle": cycle, "needed sort": sort,
            "LPT sources": sources, "displacements": displ,
            "row gather": gather}


def _ooc_phases(params: Params, frac: float, shards: int = 1,
                n_chips: int = 1) -> dict:
    """The out-of-core engine's (fmax_ooc.run_fmax_ooc) arrays at each
    phase's peak on one device.  Over a mesh of ``shards`` shards on
    n_chips devices a device holds shards / n_chips of them: of the arrays
    sharded over kz (stacks, spectra) and over x (Fmax, real fields, row
    ranks, rows) as many of the largest shard's pieces, at most the whole
    array (one card holding every shard holds the sum), and one shard's
    transient at a time: a kz batch of its window, a gathered x-slab, the
    sort of its x-block and, with several shards, the hand-off's keys and
    merged positions (a phase of its own) and one landing chunk."""
    from .fmax_ooc import KZ_BATCH, LAND_ROWS, slab_width, split
    from .ops import tabulated
    s = _sizes(params, frac)
    N, f, h, count, nf = s["N"], s["f"], s["k"], s["count"], s["nf"]
    Nh = N // 2 + 1
    nkz = split(Nh, shards)[0][1]      # the largest kz window
    B = min(params.ooc_kz_batch or KZ_BATCH, nkz)
    Bx = params.ooc_z_batch or slab_width(N, shards)
    # the largest x-block's share of the grid (runs of whole x-slabs)
    block = split(N // Bx, shards)[0][1] * Bx / N
    per = shards / n_chips
    rk, rx = min(1.0, per * nkz / Nh), min(1.0, per * block)
    plane = 8.0 * N * N * B            # one complex64 kz batch
    real_slab = 4.0 * Bx * N * N       # one float32 x-slab component
    half_slab = h * Bx / N             # one complex64 x-slab component

    def batch(ncomp, planes):
        # K9 planes, K10 factors, the ifft2 result and its work area
        return dict(kz_batch=(planes + 3 * ncomp) * plane)

    def slab(ncomp, extra=0):
        return dict(slab=ncomp * half_slab + (ncomp + extra) * real_slab)

    # a radius's TABULATED_CT / ELL_SNG table pair with the delta grid and
    # the aux map; the four growth tables over log10 |k| of one set
    nxy, nd = tabulated.CT_NBINS_XY, tabulated.CT_NBINS_D
    ct = (dict(ct_tables=4.0 * (2 * nxy * nxy * nd + nd + tabulated.AUX_N))
          if params.ell_model != "classic" else {})
    gt = (dict(growth_tables=4 * 4.0 * GROWTH_NTAB)
          if params.scale_dependent or params.mod_grav_fr else {})
    phases = {"cycle": dict(hessian_stack=6 * h * rk, fmax=f * rx, **ct,
                            **batch(6, 1))}
    order = params.lpt_order
    if order >= 2:
        nsrc = 3 if order >= 3 else 1
        phases["sources"] = dict(hessian_stack=6 * h * rk, fmax=f * rx,
                                 real_sources=nsrc * f * rx, **slab(6, 3))
    if order >= 3:
        phases["fold"] = dict(fmax=f * rx, q2_spectrum=h * rk,
                              q31_src32=2 * f * rx, pair_stack=2 * h * rk,
                              **batch(2, 1))
    nspec = nf - 1
    base = dict(fmax=f * rx, source_spectra=nspec * h * rk)
    phases["needed sort"] = dict(base, needed_sort=SORT_FIELDS * f * block)
    if shards > 1:
        # the last shard sorts beside the others' row ranks, cells and F;
        # then the merged positions: every shard's ranks, cells, F, (F,
        # cell) keys and positions, and one shard's int64 sum and
        # searchsorted result
        phases["needed sort"]["other_shards"] = ((f + 12.0 * count)
                                                 * (rx - block))
        phases["hand-off"] = dict(base, shard_products=(f + 24.0 * count)
                                  * rx, positions=16.0 * count * block)
    phases["v-streams"] = dict(fmax=f * rx, row_rank=(f + 4.0 * count) * rx,
                               source_spectra=nspec * h * rk,
                               displacement_stack=3 * h * rk,
                               rows_of_one_field=12.0 * count * rx, **gt,
                               **batch(3, 1))
    if shards > 1:
        # the merged positions, a landing chunk and one shard's share of
        # its positions (int64)
        phases["v-streams"]["merged_positions"] = 4.0 * count * rx
        phases["v-streams"]["landing_chunk"] = (12.0 + 8.0 * block) * min(
            LAND_ROWS, count)
    return phases


def device_peak(params: Params, ooc: bool, cosmo: Cosmology = None,
                frac: float = None, n_chips: int = 1,
                shards: int = None) -> dict:
    """The predicted device memory of the dense (ooc False) or the
    out-of-core engine: dict(phases={phase: {array: bytes}}, peak=bytes,
    phase=the phase of the peak, frac=the collapsed fraction used).  With
    n_chips > 1 (a mesh over that many devices) the dense engine's every
    array is sharded, so each device holds 1/n_chips of it (the JAX
    planner's per-chip model); the out-of-core engine's per-device model
    over ``shards`` shards (n_chips when None) is _ooc_phases'."""
    if frac is None:
        frac = collapsed_fraction(params, cosmo or Cosmology(params))
    if ooc:
        phases = _ooc_phases(params, frac, shards or n_chips, n_chips)
    else:
        phases = {p: {a: b / n_chips for a, b in arrays.items()}
                  for p, arrays in _dense_phases(params, frac).items()}
    totals = {p: sum(a.values()) for p, a in phases.items()}
    top = max(totals, key=totals.get)
    return dict(phases=phases, peak=totals[top], phase=top, frac=frac)


def host_phases(params: Params, frac: float, dense_products: bool = False,
                geoms=None, two_turn: bool = False,
                workers: int = None) -> dict:
    """Host bytes of the run by phase, array by array: at the end of fmax,
    the needed particles' products (cell index, F and the rows of every
    field of every displacement set); during the sweep, the same products
    (shared by every sub-box) and, for each box swept at once, the sweep's
    per-particle arrays, its peak groups and capture buffers, the box's row
    map and, with the PLC, its crossing buffers (4 Nmax per box).  geoms:
    the sub-boxes (fragment.subbox.subbox_geometries), one periodic box
    when None; a sub-box stores the collapsed fraction of its padded cells
    and adds its particles' rows in the shared products, the two-turn
    scheme three uint8 maps over its padded cells.  workers boxes
    (fragment.subbox.pool_workers when None) are swept at once; the
    others' results (groups, particle outputs) stay until the merge.  With
    the timeless snapshot the whole grid's products (Fmax, Rmax and the
    first set's stacks) are on the host from the end of fmax on, and its
    writer adds the IDs, ZACC, GRUP and one block's transposed rows.
    dense_products (special mode 3): the whole grid's products, no sweep,
    and the LPT snapshot writer's displacement sum, positions, IDs and one
    block's rows."""
    s = _sizes(params, frac)
    n, nf, cells = s["count"], s["nf"], float(s["N"]) ** 3
    products = dict(cell_index=8.0 * n, F=4.0 * n,
                    rows=12.0 * n * nf * s["nseg"])
    if params.WriteTimelessSnapshot or dense_products:
        products["dense_products"] = (8.0 + 12.0 * nf) * cells
    if dense_products:
        return {"fmax": products,
                "snapshot": dict(products, lpt_writer=44.0 * cells)}
    per_group = (GROUP_BYTES + GROUP_BYTES_PER_OUTPUT * len(params.output_z)
                 + GROUP_BYTES_PER_FIELD * nf)
    plc_on = params.plc_enabled and params.StartingzForPLC >= 0.0
    # name, z, mass, x and v of each of 4 Nmax crossings
    plc_bytes = 40.0 * 4 * int(cells / 6 * params.PredPeakFactor)
    boxes = sorted((float(math.prod(g.L)) for g in geoms), reverse=True) \
        if geoms else [cells]
    multi = len(boxes) > 1
    # per stored particle: F, pos, gop, zacc, join_F, and a sub-box's row
    per_particle = 24.0 if multi else 20.0

    def working(c):
        nb = frac * c
        w = dict(sweep_arrays=per_particle * nb,
                 groups=PEAKS_PER_STORED * nb * per_group, row_map=4.0 * c)
        if two_turn:
            w["turn_masks"] = 3.0 * c
        if plc_on:
            w["plc_buffers"] = plc_bytes
        return w

    if workers is None:
        from .fragment.subbox import pool_workers
        workers = pool_workers()
    sweep = dict(products)
    for c in boxes[:workers]:
        for k, b in working(c).items():
            sweep[k] = sweep.get(k, 0.0) + b
    if boxes[workers:]:
        sweep["finished_boxes"] = sum(boxes[workers:]) * frac * (
            PEAKS_PER_STORED * per_group + 16.0)
    phases = {"fmax": products, "sweep": sweep}
    if params.WriteTimelessSnapshot:
        # the sweep's positions (int64 after a multibox merge), zacc and
        # group names per stored particle, and every box's groups
        phases["snapshot"] = dict(
            products, particle_outputs=(20.0 if multi else 16.0) * n,
            groups=PEAKS_PER_STORED * frac * sum(boxes) * per_group,
            timeless_writer=32.0 * cells)
    return phases


def host_sweep_bytes(params: Params, frac: float) -> float:
    """Host bytes of the one-box fragmentation (host_phases)."""
    return sum(host_phases(params, frac)["sweep"].values())


def subbox_plan(params: Params, cosmo: Cosmology) -> dict:
    """The sub-box decomposition of a run with subbox_tasks > 1
    (fragment.subbox, set_subboxes): nbox, the geometries, whether the
    memory-driven default sweeps in two turns, the threads that sweep at
    once, and the boundary overhead, the padded volumes over N^3 (1 for
    one box)."""
    if params.subbox_tasks <= 1:
        return dict(nbox=(1, 1, 1), geoms=None, two_turn=False, workers=1,
                    boundary_overhead=1.0)
    from .fragment.subbox import (choose_nbox, default_two_turn,
                                  pool_workers, subbox_geometries)
    from .io.catalogs import largest_halo_mass
    largest = largest_halo_mass(params, cosmo)
    nbox = choose_nbox(params, cosmo, largest, params.subbox_tasks)
    geoms = subbox_geometries(params, cosmo, largest, nbox)
    padded = sum(float(math.prod(g.L)) for g in geoms)
    return dict(nbox=nbox, geoms=geoms,
                two_turn=default_two_turn(params, cosmo, geoms),
                workers=min(len(geoms), pool_workers()),
                boundary_overhead=padded / float(params.GridSize) ** 3)


def device_memory(device) -> float:
    """The memory of ``device`` in bytes: the card's total memory, or the
    host's for a CPU device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return host_memory()


def host_memory() -> float:
    """The host's physical memory in bytes."""
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def plan(params: Params, device="cuda", cosmo: Cosmology = None,
         dense_products: bool = False, n_chips: int = 1,
         shards: int = None) -> dict:
    """The memory forecast of a run on ``device``: both engines' peaks, the
    engine the run takes (params.ooc 'on', 'off', or 'auto': the
    out-of-core engine when the dense one does not fit), the sub-box
    decomposition (subbox_plan: nbox, boundary_overhead, two_turn,
    subbox_workers) and the host estimate of the run's phases (host_phases;
    dense_products for special mode 3).  n_chips: the distinct devices of a
    mesh run, each like ``device``, and shards its size (n_chips when
    None); the device fields are per device.  The out-of-core engine over a
    mesh lands its products in the same host arrays as on one device (its
    merge runs on the devices), so the host estimate does not depend on the
    mesh."""
    if cosmo is None:
        cosmo = Cosmology(params)
    frac = collapsed_fraction(params, cosmo)
    limit = device_memory(device)
    dense = device_peak(params, False, frac=frac, n_chips=n_chips)
    ooc = device_peak(params, True, frac=frac, n_chips=n_chips,
                      shards=shards)
    if params.ooc == "on":
        use_ooc = True
    elif params.ooc == "auto":
        use_ooc = dense["peak"] >= limit
    else:
        use_ooc = False
    chosen = ooc if use_ooc else dense
    sub = subbox_plan(params, cosmo)
    hphases = host_phases(params, frac, dense_products, geoms=sub["geoms"],
                          two_turn=sub["two_turn"], workers=sub["workers"])
    if torch.device(device).type == "cpu":
        # device arrays live in host memory too
        for arrays in hphases.values():
            arrays["device_arrays"] = chosen["peak"] * n_chips
    htotals = {p: sum(a.values()) for p, a in hphases.items()}
    hphase = max(htotals, key=htotals.get)
    host, host_limit = htotals[hphase], host_memory()
    return dict(grid=params.GridSize, device=str(device), n_chips=n_chips,
                shards=shards or n_chips, frac=frac,
                device_limit=limit, dense=dense, ooc=ooc, use_ooc=use_ooc,
                engine="out-of-core" if use_ooc else "dense",
                device_bytes=chosen["peak"],
                fits_device=chosen["peak"] < limit,
                host=dict(phases=hphases, phase=hphase),
                host_bytes=host, host_limit=host_limit,
                fits_host=host < host_limit, nbox=tuple(sub["nbox"]),
                boundary_overhead=sub["boundary_overhead"],
                two_turn=sub["two_turn"], subbox_workers=sub["workers"])


def ooc_selected(params: Params, device="cuda", cosmo: Cosmology = None,
                 n_chips: int = 1) -> bool:
    """Whether the run takes the out-of-core engine (see plan)."""
    return plan(params, device, cosmo, n_chips=n_chips)["use_ooc"]


def format_memory_map(report: dict) -> str:
    """The reference-style per-array map of the chosen engine's peak phase
    (allocations.c:274-311)."""
    eng = report["ooc"] if report["use_ooc"] else report["dense"]
    other = report["dense"] if report["use_ooc"] else report["ooc"]
    chips = report.get("n_chips", 1)
    shards = report.get("shards", chips)
    lines = [
        f"RUN PLAN for {report['grid']}^3 on {report['device']}"
        + (f" (per device of {chips})" if chips > 1 else "")
        + (f" ({shards} shards)" if shards > 1 else "")
        + f": {report['engine']} engine",
        f"  est. collapsed fraction:    {report['frac']:.3f}",
        f"  device memory, peak phase ({eng['phase']}): "
        f"{eng['peak'] / GiB:.2f} GiB of {report['device_limit'] / GiB:.2f} "
        f"GiB {'(OK)' if report['fits_device'] else '(EXCEEDS DEVICE!)'}"]
    for name, b in eng["phases"][eng["phase"]].items():
        lines.append(f"     {name:<22s} {b / GiB:9.3f} GiB")
    lines.append("  phases: " + ", ".join(
        f"{p} {sum(a.values()) / GiB:.2f}" for p, a in eng["phases"].items())
        + " GiB")
    lines.append(f"  the {'dense' if report['use_ooc'] else 'out-of-core'} "
                 f"engine would peak at {other['peak'] / GiB:.2f} GiB "
                 f"({other['phase']})")
    nbox = report["nbox"]
    if math.prod(nbox) > 1:
        lines.append(
            f"  fragmentation: {math.prod(nbox)} sub-boxes "
            f"({nbox[0]} x {nbox[1]} x {nbox[2]}), padded volume "
            f"{report['boundary_overhead']:.3f} N^3, "
            f"{'two-turn' if report['two_turn'] else 'single-turn'}, "
            f"{report['subbox_workers']} swept at once")
    host = report["host"]
    lines.append(f"  host memory, peak phase ({host['phase']}): "
                 f"{report['host_bytes'] / GiB:.2f} GiB of "
                 f"{report['host_limit'] / GiB:.2f} GiB "
                 f"{'(OK)' if report['fits_host'] else '(EXCEEDS HOST!)'}")
    for name, b in host["phases"][host["phase"]].items():
        lines.append(f"     {name:<22s} {b / GiB:9.3f} GiB")
    lines.append("  host phases: " + ", ".join(
        f"{p} {sum(a.values()) / GiB:.2f}"
        for p, a in host["phases"].items()) + " GiB")
    return "\n".join(lines)


def enforce_budget(params: Params, device="cuda", cosmo: Cosmology = None,
                   verbose: bool = True, dense_products: bool = False,
                   n_chips: int = 1, shards: int = None) -> dict:
    """Pre-flight check, before any allocation: raise MemoryPlanError with
    the per-array map when the chosen engine's device peak or the run's
    host memory exceeds what there is; returns the plan (n_chips and
    shards as in plan)."""
    report = plan(params, device, cosmo, dense_products, n_chips, shards)
    problems = []
    if not report["fits_device"]:
        problems.append(
            f"the {report['engine']} engine's device peak "
            f"{report['device_bytes'] / GiB:.2f} GiB exceeds the device's "
            f"{report['device_limit'] / GiB:.2f} GiB"
            + ("" if report["use_ooc"] else
               " (set ooc to 'auto' or 'on')"))
    if not report["fits_host"]:
        problems.append(
            f"the host memory of the run, {report['host_bytes'] / GiB:.2f} "
            f"GiB, exceeds the host's {report['host_limit'] / GiB:.2f} GiB")
    if problems:
        raise MemoryPlanError("memory pre-flight failed:\n  - "
                              + "\n  - ".join(problems) + "\n"
                              + format_memory_map(report))
    if verbose:
        print(format_memory_map(report))
    return report
