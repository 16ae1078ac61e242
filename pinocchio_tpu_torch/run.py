"""End-to-end pipeline driver on one CUDA device, or with the fmax phase
sharded over a mesh of devices, in one process or in one process per host:
parameter file -> catalogs (counterpart of pinocchio_tpu/run.py).

The classic ellipsoid or the TABULATED_CT / ELL_SNG collapse tables,
scale-independent or scale-dependent growth, with or without
RECOMPUTE_DISPLACEMENTS, the past light cone and the timeless snapshot.  The
planner picks the fmax engine: the dense one, or, with ooc 'on', or 'auto'
when the dense engine does not fit the device, the out-of-core one; it
aborts with the memory map when the chosen engine does not fit.  Either
engine hands its rows to the host overlapped (overlap, the default): they
stream while fragmentation sweeps behind their watermark, and the run
joins the streams after it.  DumpProducts writes the products after fmax,
or after fragmentation when they stream; ReadProductsFromDumps reads them
instead of running IC and fmax.  With subbox_tasks > 1 (--subboxes) the
fragmentation runs over that many padded sub-boxes, swept concurrently on
the host's cores and merged (fragment/subbox.py).  With a mesh (--chips N:
cuda:0..N-1, or N CPU shards with --device cpu; --decomp slab, pencil,
volumes or auto) IC and fmax run sharded over it (parallel/driver.py) and
hand the same host products to the rest; one process.  When the planner
picks the out-of-core engine for each of the mesh's devices (ooc 'on', or
'auto' where the dense one does not fit), that engine runs with its ledger
sharded over kz on the mesh's devices, whatever the decomposition
(fmax_ooc.py), and its products are on the host at once.  With hosts=(h, H)
the run is host h of H: it sweeps its round-robin share of the sub-boxes,
fed over a mesh by the cross-host exchange (parallel/exchange.py), or, after
the out-of-core engine, from the host products, and
writes its catalogs, histories and PLC as .out.<h> chunks, its share of the
timeless snapshot as an npz chunk, and the mass functions and n(z) through
part files that the last host sums; scripts/torch_merge_chunks.py
reassembles the files.  In one process (run_pipeline(hosts=) over an
ordinary mesh) each mocked host repeats IC and fmax over the whole mesh.
The CLI's --hosts H runs the hosts as H processes, one per host, joined in
a torch.distributed process group (parallel/multihost.py): each computes
only its own block of the mesh's shards, the transposes, reductions and
the exchange cross processes, and the outputs are those of the mocked
hosts.  With the out-of-core engine (ooc 'on', or 'auto' where the
planner's per-device map picks it) each process holds its own shards' kz
windows of the stacks and spectra and x-blocks of Fmax and the real
fields; the x-slab gathers, the spectra's pieces, the slab means and
histogram, and the hand-off's keys, positions and rows cross the group
(the row streams on a group of their own), so that every process lands
the whole host products, as each mocked host does, and sweeps its share.
Over processes the out-of-core engine with the timeless snapshot raises
(item 13), and the group runs on gloo, not NCCL (item 12b-iv).

  initialization -> plan and storage estimate -> PLC geometry -> fmax
  (collapse times + displacements, on the device; or the products read
  from a dump) ->
  fragmentation (host C sweep of one box or of sub-boxes on a thread
  pool, with the PLC crossings) -> catalogs / mass
  functions / histories / PLC catalog and n(z) / timeless snapshot

The special modes (run_special_mode, pinocchio.c argv[2]) write one product
and stop: 1 the collapse-time table, 2 the linear density, 3 the LPT
initial conditions as a Gadget snapshot.

Usage:
    python -m pinocchio_tpu_torch.run <parameter_file> [mode] [--norad]
        [--outdir DIR] [--device cuda] [--grid N] [--subboxes N]
        [--ooc on|off|auto]
        [--chips N] [--decomp auto|slab|pencil|volumes]
        [--shard-devices D,D,...] [--hosts H --host-id h
        --coordinator HOST:PORT [--group-timeout S]]

    e.g. two processes on the CPU, each holding 2 of 4 shards (add --ooc on
    for the out-of-core engine):
    python -m pinocchio_tpu_torch.run <pf> --device cpu --chips 4 \
        --hosts 2 --host-id <h> --coordinator localhost:<port> --outdir D
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import kernels
from .config import Params, read_parameter_file
from .cosmology import Cosmology
from .fmax_ooc import check_ooc_supported


def check_supported(params: Params) -> None:
    """Raise ValueError for an unknown ooc mode, and NotImplementedError,
    naming the ROADMAP item, for a feature outside the ported paths (with
    ooc 'on': fmax_ooc.check_ooc_supported)."""
    if params.ooc not in ("on", "off", "auto"):
        raise ValueError(f"ooc must be 'on', 'off' or 'auto', got "
                         f"{params.ooc!r}")
    if params.ooc == "on":
        check_ooc_supported(params)


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device that is not there raises (the run
    never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def run_pipeline(params: Params, outdir: str = ".", device="cuda",
                 verbose: bool = True, write_outputs: bool = True,
                 mesh=None, hosts: tuple = None, overlap: bool = True):
    """The run on ``device``, or with IC and fmax sharded over ``mesh``
    (parallel.pfft.Mesh; its devices replace ``device``); hosts=(h, H):
    host h's share of a run over H hosts (the module docstring), which over
    a mesh split over a process group (pfft.mesh_for(procs=)) must be the
    process's (rank, size), every process of the group calling it alike.
    overlap (the default): either engine's overlapped hand-off, the rows
    streaming to the host while fragmentation sweeps behind their watermark
    (the dense mesh engine does not stream); False: the blocking hand-off,
    the same outputs.  Returns dict(cosmo, plan (the planner's report),
    fmax, frag, timings, files)."""
    from .fmax import fmax_pdf, run_fmax
    from .fmax_ooc import run_fmax_ooc
    from .fragment.driver import run_fragmentation
    from .fragment.subbox import choose_nbox, run_fragmentation_multibox
    from .io import catalogs as io_cat
    from .io import dumps
    from .planner import enforce_budget, estimate_file_sizes
    from .plc import build_plc_geometry, write_nz, write_plc_catalog

    dev = resolve_device(device if mesh is None
                         else mesh.local_devices()[0])
    check_supported(params)
    t_total = time.perf_counter()
    host0 = kernels.host_totals()
    timings = {}
    host_id, nhosts = hosts if hosts else (0, 1)
    procs = None if mesh is None else mesh.procs
    if procs is not None and tuple(procs) != (host_id, nhosts):
        raise ValueError(f"a mesh split over {procs[1]} processes as rank "
                         f"{procs[0]} runs as that host, not as hosts="
                         f"{hosts}")
    if nhosts > 1 and write_outputs:
        # this host's part files of a run that failed would be summed into
        # this run's reductions
        io_cat.clear_stale_parts(outdir, host_id)
    if procs is not None:
        # no process writes a part file before every process cleared its
        # own stale ones
        from .parallel.multihost import barrier
        barrier()
    if verbose:
        greetings(params, dev, mesh)
    t0 = time.perf_counter()
    cosmo = Cosmology(params)
    timings["init"] = time.perf_counter() - t0
    if verbose:
        print(f"[init] cosmology ready in {timings['init']:.2f}s "
              f"(sigma8={params.Sigma8:.4f})")
    if write_outputs and host_id == 0:
        # one host writes the files that every host would write alike
        cosmo.write_cosmology_file(outdir)

    # per-radius effective growth scales of a scale-dependent cosmology
    # (set_scaledep_GM, host numpy in the shared jax-free module)
    scaledep_gm = None
    if getattr(cosmo, "scale_dep", False):
        from .scaledep import set_scaledep_gm

        from .fmax import Smoothing
        t0 = time.perf_counter()
        scaledep_gm = set_scaledep_gm(
            params, cosmo, Smoothing.build(params, cosmo),
            io_cat.largest_halo_mass(params, cosmo), verbose=verbose)
        timings["scaledep"] = time.perf_counter() - t0

    # the engine that fits the device (each of the mesh's devices), or an
    # abort with the memory map before any allocation; over a process group
    # every out-of-core process of this node lands the whole host products
    node_procs = 1
    if procs is not None:
        from .parallel.multihost import node_processes
        node_procs = node_processes()
    plan = enforce_budget(params, dev, cosmo, verbose=verbose,
                          n_chips=1 if mesh is None else mesh.n_devices(),
                          shards=1 if mesh is None else mesh.size,
                          procs=1 if procs is None else procs[1],
                          node_procs=node_procs)
    if verbose and write_outputs:
        # the output files' sizes from the analytic mass function
        estimate_file_sizes(params, cosmo)
    t0 = time.perf_counter()
    plc_geom = build_plc_geometry(params, cosmo, verbose=verbose)
    if plc_geom.enabled:
        timings["plc_geom"] = time.perf_counter() - t0
    if params.ReadProductsFromDumps:
        # no IC and no fmax (pinocchio.c:220-236)
        fmax_res = dumps.read_dumps(params, outdir)
        if verbose:
            print("[fmax] products read from dumps")
    elif plan["use_ooc"]:
        # over a mesh, its devices in flat order shard the ledger over kz
        # whatever the decomposition (as the JAX package's run.py), over a
        # process group each process holding its own shards
        check_ooc_supported(params)
        if verbose and mesh is not None:
            print(f"[fmax] out-of-core ledger sharded over {mesh.size} "
                  "devices" + ("" if procs is None else
                               f" of {procs[1]} processes"))
        fmax_res = run_fmax_ooc(params, cosmo, dev, scaledep_gm=scaledep_gm,
                                verbose=verbose, mesh=mesh, overlap=overlap)
    elif mesh is not None:
        from .parallel.driver import run_fmax_distributed
        if verbose:
            print(f"[fmax] sharded over mesh {mesh.shape}")
        # several hosts keep the hand-off on the devices for the exchange
        fmax_res = run_fmax_distributed(params, cosmo, mesh,
                                        scaledep_gm=scaledep_gm,
                                        verbose=verbose,
                                        defer_handoff=nhosts > 1)
    else:
        fmax_res = run_fmax(params, cosmo, dev, scaledep_gm=scaledep_gm,
                            verbose=verbose, overlap=overlap)
    timings.update({"fmax_" + k: v for k, v in fmax_res.timings.items()})
    # the rows of an overlapped hand-off are still streaming: no device
    # sync before fragmentation, and the dump (which reads every row)
    # after it
    pending = fmax_res.pending_fetch or fmax_res.ooc_pending
    dump_wanted = (params.DumpProducts and write_outputs
                   and not params.ReadProductsFromDumps)

    def dump():
        t0 = time.perf_counter()
        dumps.dump_products(params, fmax_res, outdir,
                            hosts=(host_id, nhosts))
        timings["dump"] = time.perf_counter() - t0
    if dump_wanted and pending is None:
        dump()

    t_frag = time.perf_counter()
    if params.subbox_tasks > 1 or nhosts > 1:
        largest = io_cat.largest_halo_mass(params, cosmo)
        nbox = choose_nbox(params, cosmo, largest,
                           max(params.subbox_tasks, nhosts))
        frag_res = run_fragmentation_multibox(
            params, cosmo, fmax_res, nbox, plc_geom=plc_geom,
            scaledep_gm=scaledep_gm, largest_mass=largest,
            host_slice=(host_id, nhosts) if nhosts > 1 else None,
            verbose=verbose)
    else:
        frag_res = run_fragmentation(params, cosmo, fmax_res,
                                     plc_geom=plc_geom,
                                     scaledep_gm=scaledep_gm,
                                     verbose=verbose)
    timings.update({"frag_" + k: v for k, v in frag_res.timings.items()})
    timings["frag_wall"] = time.perf_counter() - t_frag
    if pending is not None:
        # the last rows have landed (the sweeps read them): join the
        # streams, which re-raises a failed copy, and take their timings
        pending.join()
        timings.update({"fmax_" + k: v
                        for k, v in fmax_res.timings.items()})
        if dump_wanted:
            dump()
    if fmax_res.handoff is not None:
        # the exchanges are done: free the deferred device buffers
        fmax_res.handoff.release()
        fmax_res.handoff = None
    if verbose and frag_res.best_pred_peak_factor:
        print(f"  the PredPeakFactor parameter could have been "
              f"{frag_res.best_pred_peak_factor:5.2f} in place of "
              f"{params.PredPeakFactor:5.2f}")

    written = []
    if write_outputs:
        t0 = time.perf_counter()
        if fmax_res.pdf_hist is not None and host_id == 0:
            # not after a restart: the dumping run wrote it; every host
            # holds the whole histogram
            fmax_pdf(fmax_res.pdf_hist,
                     os.path.join(outdir,
                                  f"pinocchio.{params.RunFlag}.FmaxPDF.out"))
        largest = io_cat.largest_halo_mass(params, cosmo)
        # several hosts write into a staging directory of their own, so
        # that hosts sharing one filesystem never race on a file, and
        # surface each file as an .out.<h> chunk (the collector scheme,
        # write_halos.c:194-225)
        io_dir = outdir
        if nhosts > 1:
            io_dir = os.path.join(outdir, f".host{host_id}")
            os.makedirs(io_dir, exist_ok=True)

        def chunk(path):
            if nhosts == 1:
                return path
            out = os.path.join(outdir, f"{os.path.basename(path)}.{host_id}")
            os.replace(path, out)
            return out
        mf_hosts = (host_id, nhosts) if nhosts > 1 else None
        for snap in frag_res.catalogs:
            written.append(chunk(io_cat.write_catalog(params, snap, io_dir)))
            mf = io_cat.compute_mf(params, cosmo, snap, outdir,
                                   largest=largest, hosts=mf_hosts)
            if mf is not None:
                written.append(mf)
        if not params.DoNotWriteHistories:
            written.append(chunk(io_cat.write_histories(
                params, frag_res.groups, io_dir)))
        t1 = time.perf_counter()
        plc = frag_res.plc
        if plc is not None and not params.DoNotWriteCatalogs:
            written.append(chunk(write_plc_catalog(
                params, plc_geom, dict(name=plc.name, z=plc.z, mass=plc.mass,
                                       x=plc.x, v=plc.v), io_dir)))
            nz = plc.nz
            if nhosts > 1:
                # the n(z) histogram reduces across hosts like the mf bins
                nz = io_cat.reduce_parts(
                    os.path.join(outdir, f"pinocchio.{params.RunFlag}.nz.out"),
                    host_id, nhosts, dict(nz=plc.nz))
                nz = None if nz is None else nz["nz"]
            if nz is not None:
                written.append(write_nz(params, cosmo, plc_geom, nz, outdir))
            timings["io_plc"] = time.perf_counter() - t1
        if params.WriteTimelessSnapshot:
            from .io.snapshot import (write_timeless_chunk,
                                      write_timeless_snapshot)
            t1 = time.perf_counter()
            if nhosts > 1:
                written.append(write_timeless_chunk(
                    params, fmax_res, frag_res, outdir, host_id=host_id,
                    nhosts=nhosts))
            else:
                written.append(write_timeless_snapshot(params, fmax_res,
                                                       frag_res, outdir))
            timings["io_snapshot"] = time.perf_counter() - t1
        if nhosts > 1:
            os.rmdir(io_dir)
        timings["io"] = time.perf_counter() - t0

    timings["total"] = time.perf_counter() - t_total
    # the run's page-locked allocations and releases and its copies to the
    # host, from the process totals of kernels.HOST_COUNTS
    host1 = kernels.host_totals()
    for kind in ("pinned_alloc", "pinned_free", "d2h"):
        key = f"{kind}_bytes_total"
        timings[f"{kind}_gib"] = (host1[key] - host0[key]) / 2 ** 30
        key = f"{kind}_seconds_total"
        timings[kind] = host1[key] - host0[key]
    if verbose:
        write_cputimes(timings)
    return dict(cosmo=cosmo, plan=plan, fmax=fmax_res, frag=frag_res,
                timings=timings, files=written)


def greetings(params: Params, device: torch.device, mesh=None):
    """Run banner with the active feature set (greetings,
    initialization.c:2030)."""
    feats = [f"{params.lpt_order}LPT", f"ELL_{params.ell_model.upper()}"]
    if params.ell_model != "classic":
        feats.append(f"TABULATED_CT({params.ct_interp})")
    if params.norad:
        feats.append("NORADIATION")
    for flag, name in ((params.FixedIC, "FixedIC"),
                       (params.PairedIC, "PairedIC"),
                       (params.scale_dependent, "SCALE_DEPENDENT"),
                       (params.mod_grav_fr,
                        f"MOD_GRAV_FR(fR0={params.fr0:g})"),
                       (params.recompute_displacements,
                        "RECOMPUTE_DISPLACEMENTS"),
                       (params.WriteTimelessSnapshot, "SNAPSHOT"),
                       (params.use_sim_params, "USE_SIMULATION_PARAMS")):
        if flag:
            feats.append(name)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print("*" * 64)
    print("pinocchio-tpu, PyTorch + CUDA port")
    print(f"  run {params.RunFlag}: {params.GridSize}^3 grid, "
          f"{params.BoxSize:g} Mpc{'/h' if params.BoxInH100 else ''} box")
    print(f"  features: {' '.join(feats)}")
    print(f"  device: {device} ({name})")
    if mesh is not None:
        print(f"  mesh: {mesh.shape} over {mesh.n_devices()} device(s)")
    print("*" * 64)


def write_cputimes(t: dict):
    """Wall-clock report at exit (write_cputimes, pinocchio.c:266-292),
    then the run's page-locked host memory and copies to the host
    (kernels.HOST_COUNTS): seconds in allocation and release, GiB
    allocated, released and copied."""
    fd = sys.stdout
    total = t.get("total", 0.0) or 1e-30

    def line(label, key, depth=0):
        if key in t:
            fd.write(f"{'  ' * depth}{label:<28s}{t[key]:10.2f} s"
                     f"  ({100.0 * t[key] / total:5.1f}%)\n")

    def gib(label, key, depth=0):
        if key in t:
            fd.write(f"{'  ' * depth}{label:<28s}{t[key]:10.2f} GiB\n")

    fd.write("\nCPU TIMES\n")
    line("total", "total")
    line("initialization", "init", 1)
    line("scale-dependent growth", "scaledep", 1)
    line("PLC geometry", "plc_geom", 1)
    line("density in k-space", "fmax_dens", 1)
    line("collapse cycle (FFTs+ell)", "fmax_fmax_loop", 1)
    line("collapse tables", "fmax_ct_tables", 2)
    line("LPT displacements", "fmax_lpt", 1)
    line("sources", "fmax_sources", 2)
    line("3LPT-b fold", "fmax_fold", 2)
    line("source spectra", "fmax_spectra", 2)
    line("displacement rows", "fmax_lpt_rows", 2)
    line("needed-particle products", "fmax_products", 1)
    line("product dump", "dump", 1)
    line("fragmentation", "frag_total", 1)
    line("fragmentation wall", "frag_wall", 1)
    line("group sweep (+PLC)", "frag_sweep", 2)
    line("quick pass (two-turn)", "frag_quick", 2)
    line("I/O", "io", 1)
    line("PLC", "io_plc", 2)
    line("snapshot", "io_snapshot", 2)
    fd.write("\nHOST MEMORY\n")
    line("page-locked allocation", "pinned_alloc", 1)
    line("page-locked release", "pinned_free", 1)
    gib("page-locked allocated", "pinned_alloc_gib", 1)
    gib("page-locked released", "pinned_free_gib", 1)
    gib("copied to the host", "d2h_gib", 1)


def run_special_mode(params: Params, mode: int, outdir: str = ".",
                     device="cuda", verbose: bool = True) -> str:
    """The special modes (pinocchio.c argv[2]); returns the file written.
    1: the collapse-time table of the run's radii (host numpy, to
    CTtableFile when set); 2: the linear density contrast as a snapshot
    (K1 and one c2r on ``device``); 3: the LPT initial conditions at the
    first output redshift as a Gadget snapshot (the dense fmax engine with
    the whole grid's products kept on the host)."""
    from .fmax import Smoothing, run_fmax
    from .io.snapshot import write_density_snapshot, write_lpt_snapshot

    dev = resolve_device(device)
    cosmo = Cosmology(params)
    if mode == 1:
        # the collapse-time table only (pinocchio.c:100-133)
        from .ops import tabulated
        sm = Smoothing.build(params, cosmo)
        model = "sng" if params.ell_model == "sng" else "classic"
        ct = tabulated.build_ct_tables_all(cosmo, sm, model=model)
        path = (params.CTtableFile
                if params.CTtableFile not in ("none", "") else
                os.path.join(outdir,
                             f"pinocchio.{params.RunFlag}.CTtable.out"))
        tabulated.write_ct_table_file(path, params, sm, ct["tables"])
        if verbose:
            print(f"collapse-time table written to {path}")
        return path
    if mode == 2:
        from .grids import Grid
        from .ic import generate_kdensity
        from .ops.derivatives import density_field
        grid = Grid(N=params.GridSize, BoxSize=params.BoxSize_htrue)
        kden = generate_kdensity(grid, cosmo, params.RandomSeed, dev,
                                 fixed=params.FixedIC,
                                 paired=params.PairedIC)
        dens = density_field(kden, params.GridSize).cpu().numpy()
        return write_density_snapshot(params, dens, outdir)
    if mode == 3:
        from .planner import enforce_budget
        plan = enforce_budget(params, dev, cosmo, verbose=verbose,
                              dense_products=True)
        if plan["use_ooc"]:
            raise NotImplementedError(
                "special mode 3 writes the dense displacement stacks, which "
                "the out-of-core engine of pinocchio_tpu_torch does not keep "
                "(ROADMAP.md, queue 1 item 13)")
        fmax_res = run_fmax(params, cosmo, dev, verbose=verbose,
                            keep_dense_products=True)
        path = write_lpt_snapshot(params, cosmo, fmax_res, outdir)
        fmax_res.pending_fetch.join()      # re-raises a failed copy
        return path
    raise ValueError(f"unknown special mode {mode}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("parameter_file")
    ap.add_argument("mode", nargs="?", type=int, default=None,
                    help="special mode: 1 = collapse-time table, 2 = linear "
                    "density snapshot, 3 = LPT initial-conditions snapshot "
                    "(pinocchio.c argv[2])")
    ap.add_argument("--norad", action="store_true",
                    help="no radiation in the background (reference "
                    "-DNORADIATION)")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    ap.add_argument("--grid", type=int, default=None,
                    help="override GridSize")
    ap.add_argument("--subboxes", type=int, default=None,
                    help="fragmentation sub-domains, swept concurrently on "
                    "the host's cores (the subbox_tasks parameter)")
    ap.add_argument("--ooc", default=None, choices=["on", "off", "auto"],
                    help="the fmax engine (the ooc parameter): on = the "
                    "out-of-core engine, auto (the default) = where the "
                    "dense engine does not fit the device, off = dense")
    ap.add_argument("--chips", type=int, default=1,
                    help="shard IC and fmax over this many devices in all "
                    "(over every process with --hosts): cuda:0..N-1 with "
                    "--device cuda (raises when fewer exist), N shards on "
                    "the CPU with --device cpu")
    ap.add_argument("--decomp", default="auto",
                    choices=["auto", "slab", "pencil", "volumes"],
                    help="FFT domain decomposition for --chips "
                    "(set_fft_decomposition; auto: pencil for even counts "
                    "from 4, else slab)")
    ap.add_argument("--shard-devices", default=None,
                    help="comma-separated devices of this process's shards "
                    "(chips / hosts of them; a device may repeat, e.g. "
                    "cuda:0,cuda:0 for two shards on one card); default "
                    "cuda:0..chips/hosts-1, or the CPU with --device cpu")
    ap.add_argument("--hosts", type=int, default=1,
                    help="processes of a run over several hosts, one per "
                    "host (torch.distributed over gloo; launch each with "
                    "its --host-id and the same --coordinator); each holds "
                    "chips / hosts of the shards, of the dense or of the "
                    "out-of-core engine, and lands the whole products")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this process's id in [0, hosts)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0, where the process group "
                    "meets (any free port)")
    ap.add_argument("--group-timeout", type=float, default=1800.0,
                    help="seconds after which a collective of the process "
                    "group, its rendezvous included, fails the run")
    args = ap.parse_args(argv)
    overrides = {"norad": True} if args.norad else {}
    params = read_parameter_file(args.parameter_file, **overrides)
    if args.grid:
        params.GridSize = args.grid
    if args.subboxes:
        params.subbox_tasks = args.subboxes
    if args.ooc:
        params.ooc = args.ooc
    procs = None
    if args.hosts > 1:
        if args.mode is not None:
            raise ValueError("the special modes run in one process")
        if args.chips % args.hosts:
            raise ValueError(f"--hosts {args.hosts} needs --chips a "
                             f"multiple of it, not {args.chips}: each "
                             "process holds chips / hosts of the shards")
        # refused before the group's rendezvous
        check_supported(params)
        from .parallel.multihost import initialize_cluster
        procs = initialize_cluster(args.hosts, args.coordinator,
                                   args.host_id, timeout=args.group_timeout)
    try:
        _run_main(args, params, procs)
    finally:
        if procs is not None:
            from .parallel.multihost import shutdown_cluster
            shutdown_cluster()


def _run_main(args, params, procs):
    dev = resolve_device(args.device)
    mesh = None
    if args.chips > 1:
        from .parallel.pfft import mesh_for
        local = args.chips // (1 if procs is None else procs[1])
        devices = (args.shard_devices.split(",") if args.shard_devices
                   else None if dev.type == "cuda" else [dev] * local)
        mesh = mesh_for(args.chips, args.decomp, devices=devices,
                        procs=procs)
    os.makedirs(args.outdir, exist_ok=True)
    if args.mode is not None:
        run_special_mode(params, args.mode, outdir=args.outdir,
                         device=args.device)
    elif procs is None:
        run_pipeline(params, outdir=args.outdir, device=args.device,
                     mesh=mesh)
    else:
        from .parallel.multihost import ResidentPeak, process_report
        t0 = time.perf_counter()
        with ResidentPeak() as resident:
            res = run_pipeline(params, outdir=args.outdir, device=args.device,
                               mesh=mesh, hosts=procs)
        print("[cluster] " + json.dumps(process_report(
            mesh, res["timings"], time.perf_counter() - t0, res["plan"],
            resident)), flush=True)


if __name__ == "__main__":
    main()
