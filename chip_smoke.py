#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pinocchio_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. needs a CUDA device (exits non-zero without one) and prints the card's
   name and power limit;
2. builds the CUDA kernels from csrc/ with nvcc (one process per source, in
   parallel) and prints the build time, then what the compiler made of
   the collapse template, of K6a, K6b and of K1/K1s/K9 (registers and
   spills from ptxas -v, the runtime's shared memory and resident blocks
   per SM, SASS counts), the proof of K3's cube root on every positive
   float32 and the proof of K1's phases (every phase the generator can
   draw: the kernel's phase, sincosf and dead-mode signed zeros against the
   plain version's phase, sin and cos);
3. runs every kernel at 256^3 and 512^3 on the card at the shapes its path
   gives it (K6a on the classic path's own state after the radius loop,
   beside its check after the mid radius; K3 also per branch of
   ell_classic and with direct loads; K11 and K13 also 20 calls back to
   back and the host's enqueue of one), holds each against its plain
   PyTorch version on the same inputs, with the tolerance printed (K3, K7,
   K11 and K13 exactly; K1, K1s and K9 bit for bit, signed zeros included,
   K1 also with FixedIC and PairedIC, K1s also on a ragged window, K9 also
   on the batch that ends at Nh; K6b also on adversarial F), and times the
   kernel, the plain
   version and, where one exists, the one PyTorch call that computes the
   same function (median of 5, CUDA events); each kernel's bound is the
   larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s
   (float32 outside the tensor cores); the shard kernels K1s, K2s, K5s and
   K8s on the (1, 1) shard of a 2x2 pencil mesh's k layout, and the
   exchange's K15, K16 and K17 on the (1, 1) shard of its real layout (2
   hosts with the main path's sub-box boxes, timed; 16 hosts with wrapped
   boxes, a host with none, spheres across edges), exactly; times special
   mode 2's density_field (a library c2r) beside its bound and irfftn;
4. drives each path through run_pipeline (with the overlapped hand-off,
   its default: the rows stream to the host while the sweep starts on
   their watermark), with the launch counters reset
   just before it and read just after, and checks its outputs (catalogs and
   mass functions at 4 redshifts with halos, FmaxPDF, histories, the
   cosmology table), its own launch set (every kernel of the path launched,
   none of another path's) and the planner's predicted peak against the
   measured one:
     classic     the main path: classic ellipsoid, 256^3, 1 Mpc/h cells;
     tabulated   TABULATED_CT with the bicubic lookup, 256^3;
     scaledep    f(R) scale-dependent growth with RECOMPUTE_DISPLACEMENTS,
                 256^3;
     tabulated_trilinear, tabulated_bilinear   the other two lookups, 128^3;
     ooc         the out-of-core engine (ooc='on'), 256^3;
     ooc_tabulated   the out-of-core engine with the bicubic lookup, 256^3;
     ooc_tabulated_trilinear, ooc_tabulated_bilinear   the other two, 128^3;
     ooc_scaledep    the out-of-core engine with f(R) growth, RECOMPUTE
                 and DumpProducts, 256^3, then a ReadProductsFromDumps run
                 that must launch no kernel and give the same catalogs;
     plc         the classic path with the past light cone (z 0.3 to 0,
                 30 degrees) and the timeless snapshot with RMAX, 256^3:
                 the PLC catalog and n(z) beside the prediction, crossings
                 in range and aperture, no overflow, every snapshot block
                 N^3 long, FMAX and RMAX equal to the run's, GRUP a group
                 name;
     subbox      the plc path with the fragmentation over one sub-box per
                 core this process may use (subbox_tasks), swept
                 concurrently: the core count, nbox, the stored/total
                 overhead, the sweep's wall beside the plc path's, the
                 summed per-box sweep seconds and the host peak beside the
                 planner's; its catalogs held to the plc path's (counts
                 within max(5, 0.5 %) per output, over 97 % of the z=0
                 names found, no duplicates) and its PLC crossings within
                 1 % of the plc path's, with no overflow;
     mesh        the classic path with IC and fmax over a 2x2 pencil mesh
                 whose four shards all live on the one card (the shard
                 kernels, K3, K4, K6; the single-device K1, K2, K5 must not
                 run), held to the classic path: at most 1e-3 N^3 cells
                 with |dF| > 0.1, variances within rtol 1e-4, halo counts
                 per output within 0.5 %;
     ooc_mesh    the ooc path with the out-of-core ledger sharded over kz
                 on 4 shards of the one card (K9, K10, K11, K4, K12, K6b on
                 every shard; none of K1-K3, K5, the shard kernels or
                 K15-K17), held to the ooc path: Fmax, variances, the needed
                 cells, their order and every row bit for bit, or within the
                 JAX package's mesh tolerance (ooc_held_to_one_device), and
                 the catalogs identical (or halo counts within max(10,
                 6 sqrt(n) + 5 %) when the products are not bit-equal);
   then delta over a slab 4, a pencil 2x2 and a volumes 2x2x2 mesh of the
   card, bit-equal to the single-device field; the fmax phase alone over
   the slab 4 and the volumes 2x2x2 mesh (classic, at 128^3, held to a
   single-device fmax there) and over the pencil 2x2 with f(R) growth and
   RECOMPUTE (K8s, held to the scaledep path), each with its launch set
   and peak; the
   distributed c2r and one all_to_all beside one device's c2r (on one card
   the transposes are device-local copies, not NVLink); the c2r of one
   radius's Hessian at 128^3 and 256^3 three ways (one device's 2-D ifft,
   two 1-D iffts, the slab 4 and volumes 2x2x2 meshes) in bit-equal cells
   and ulps (mesh_c2r); the out-of-core fmax phase alone at 256^3 over 3
   and 4 shards of the card with the bicubic lookup (K13) and with f(R)
   growth and RECOMPUTE (K14, 4 row sets), each held to the single-device
   engine as the ooc_mesh path is, with its launch set and its phases'
   peaks beside the planner's per-device map (ooc_mesh_fmax); then the
   exchange
   (hosts_exchange) on one deferred fmax over a 2x2 pencil mesh of the card
   at 256^3: single-turn and turn 0 for 2 and 4 mocked hosts, each host's
   rows held to the brute-force selection, with the count, pack, route and
   extract times, wire bytes and device peak, and the two-turn wire
   protocol for 2 hosts (K15, K16, K17 launched; the union of the hosts'
   catalogs equal to the one-process two-turn multibox); the hosts path:
   run_pipeline(hosts=(h, 2)) for h = 0, 1 over that mesh, one sub-box per
   core, into one outdir (the mesh kernels, K15 and K16 launched; the
   chunks, no part file; the union of the catalogs equal to the one-process
   multibox on the same products exactly; mf.out byte-identical, or equal
   in counts with the bins' mean masses within rtol 1e-6;
   scripts/torch_merge_chunks.py); then the special
   modes at 256^3 through run_special_mode: 1 (the CT
   table, no kernel), 2 (the linear density: K1 and one c2r, its mean 0
   and its variance the classic path's R=0 grid variance), 3 (the LPT
   snapshot: the classic launch set, POS equal to q + the classic path's
   displacement rows at the needed cells); and the sub-box sweeps of the
   classic path's products, single-turn and two-turn (subbox_turns), each
   with its wall, quick-pass seconds, boundary particles requested and
   beyond-boundary count, held to the classic path's one-box catalogs;
   then the hand-off (handoff): the overlapped hand-off against the
   blocking one (overlap=False) on the classic fmax at 256^3 on one delta,
   the cell indices, F, rows and FmaxPDF counts bit for bit, its timeline
   from the end of the collapse cycle (return, ci/F landed, first and last
   chunk, each table's host buffer allocated and landed), its rate on the
   host's clock and, from a torch.profiler trace, the copies' device time,
   rate and the part of it beside a kernel; the
   watermark proof at 128^3 (0.02 s before each chunk lands; one box and
   2x1x1 sub-boxes single- and two-turn: the blocking run's catalogs, the
   sweeps waiting on the watermark, the run longer than 0.02 x 16 / 2 s);
   f(R) with RECOMPUTE (4 sets, traced) and the out-of-core engine at
   128^3, bit for bit, with the blocking run's catalogs; run_pipeline at
   128^3 with the PLC and a dump both ways, every output file equal;
5. runs the classic path at 48^3, the tabulated and scaledep paths at 64^3
   and the plc path at 64^3 (z 0.1), also over 4 sub-boxes, the mesh path
   at 48^3 and the hosts path at 48^3 (each device's hosts united equal to
   its one-process run), on the card and on the CPU (the plain versions)
   and holds the halo catalogs and the PLC crossings to each other;
6. holds the out-of-core engine to the dense engine, the dense one fed the
   delta assembled from the engine's kz planes (Fmax, variances, the needed
   set and its order, the rows of every displacement set, halo counts),
   for the classic ellipsoid with the PLC at 256^3 (the crossings must be
   identical), the bicubic lookup and f(R) growth with RECOMPUTE at 128^3,
   with each engine's peak memory beside the planner's;
7. runs the out-of-core fmax phase at 512^3 (ooc='on'; classic, and the
   bicubic lookup) and at 1024^3 under ooc='auto' (classic, f(R) growth),
   where the planner must choose the out-of-core engine; prints its map,
   each phase's measured peak beside the predicted one, the host's free
   memory beside the planner's host estimate, the needed count and the
   phase times, when run_fmax_ooc returned, when each table's host buffer
   was allocated and when its last row landed;
   at 1024^3 classic also one blocking run (overlap=False) with the same
   (ci, F), its wall, hand-off and host peak; then the classic fmax phase
   at 1024^3 under ooc='auto'
   over 4 shards of the card (ooc_mesh_big): the planner's per-device map
   must choose the out-of-core engine, the needed count and a SHA-256 of
   (ci, F) must equal the single-device run's, each phase's time and peak
   beside the planner's, the hand-off's seconds, the last row's time and
   the host peak beside the single device's, and one blocking run as
   above; and the planner's map of f(R) growth with
   RECOMPUTE at 1024^3, which must refuse the run on host memory before
   any allocation;
8. checks that neither jax nor any module of the JAX package was imported;
9. prints one JSON line of the kernels (with the hand-off's timelines and
   traces under "handoff"), then {"ok": true, "device": ...} as the last
   line.  Any failed check exits non-zero before that.

    python3 chip_smoke.py --only subbox,subbox_turns,reference:subbox

runs only the named phases (kernels, density_field, a path's name,
mesh_fmax, mesh_c2r, ooc_mesh_fmax or one of its names, modes,
subbox_turns, reference:<path>, ooc_dense:<name>, ooc_fmax, big,
ooc_mesh_big, refusal, handoff) and prints no JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SIZES = (256, 512)
PIPELINE_N = 256
OUTPUT_Z = [2.0, 1.0, 0.5, 0.0]
REPS = 5
GiB = float(2 ** 30)
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory bytes per second, float32 operations per second outside the tensor
# cores
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# operations per element of each kernel, counted from its source: a mode
# (K1, K9: two threefry2x32 evaluations of 20 rounds, six transcendentals,
# a 12-step table search; K2/K5/K8/K10: the mode's k, one exponential or
# table read, a few multiplies per output), a cell (K3/K7/K11: the
# eigenvalues with acos and cos, the ellipsoid root, the growth fit, the
# running max; K4: the products of its expression) or a row (K6a, K12)
OPS = {"ic_kdensity": 380, "ic_kdensity_planes": 380, "kspace_hessian": 40,
       "kspace_gradient": 20, "kspace_gradient_tab": 40,
       "ooc_factors_hessian": 40, "ooc_factors_gradient": 20,
       "ooc_factors_pair": 20, "collapse_update": 400,
       "collapse_update_slab": 400, "collapse_update_table_trilinear": 330,
       "collapse_update_table_bilinear": 450,
       "collapse_update_table_bicubic": 900, "lpt_sources_pointwise": 35,
       "lpt_src32_accumulate": 18, "needed_rank": 0, "gather_rows": 0,
       "pdf_hist": 5,
       "vrows_slab": 1, "collapse_update_slab_table_trilinear": 330,
       "collapse_update_slab_table_bilinear": 450,
       "collapse_update_slab_table_bicubic": 900,
       "ooc_factors_gradient_tab": 40, "ic_kdensity_shard": 380,
       "kspace_hessian_shard": 40, "kspace_gradient_shard": 20,
       "kspace_gradient_tab_shard": 40, "exchange_count": 12,
       "exchange_pack": 4, "exchange_paint": 20}
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
# each path's launch set: the dense engine's shared kernels, then each
# path's own; the out-of-core engine's
DENSE = {"ic_kdensity", "kspace_hessian", "lpt_sources_pointwise",
         "lpt_src32_accumulate", "needed_rank", "gather_rows", "pdf_hist"}
OOC_COMMON = {"ic_kdensity_planes", "ooc_factors_hessian", "ooc_factors_pair",
              "needed_rank", "vrows_slab", "lpt_sources_pointwise",
              "lpt_src32_accumulate", "pdf_hist"}
OOC = OOC_COMMON | {"collapse_update_slab", "ooc_factors_gradient"}
OOC_FR = OOC_COMMON | {"collapse_update_slab", "ooc_factors_gradient_tab"}
TAB = dict(ell_model="tabulated", ct_interp="bicubic")
# the past light cone from the default vertex along the default axis, and
# the timeless snapshot with its RMAX block
PLC = dict(plc_enabled=True, StartingzForPLC=0.3, LastzForPLC=0.0,
           PLCAperture=30.0, PLCProvideConeData=True)
SNAPSHOT = dict(WriteTimelessSnapshot=True, add_rmax_to_snapshot=True)
CLASSIC = DENSE | {"collapse_update", "kspace_gradient"}
# the fmax phase over a mesh: the shard kernels K1s, K2s, K5s (K8s with
# scale-dependent growth), K3, K4 and K6 on each shard; the single-device K1,
# K2 and K5 must not run
MESH = {"ic_kdensity_shard", "kspace_hessian_shard", "kspace_gradient_shard",
        "collapse_update", "lpt_sources_pointwise", "lpt_src32_accumulate",
        "needed_rank", "gather_rows", "pdf_hist"}
MESH_FR = (MESH - {"kspace_gradient_shard"}) | {"kspace_gradient_tab_shard"}
# the cores this process may use: one sub-box each on the subbox path
CORES = len(os.sched_getaffinity(0))
# two hosts mocked over a 2x2 pencil mesh of the card: the mesh path's
# kernels and the exchange's count and pack (K15, K16); the two-turn wire
# protocol adds the sphere paint (K17)
HOSTS = 2
HOSTS_MESH = ("pencil", (2, 2))
HOSTS_LAUNCH = MESH | {"exchange_count", "exchange_pack"}
TWO_TURN_LAUNCH = {"exchange_count", "exchange_pack", "exchange_paint"}


def ooc_tab(interp):
    """The out-of-core launch set with the lookup ``interp``."""
    return OOC_COMMON | {f"collapse_update_slab_table_{interp}",
                         "ooc_factors_gradient"}


OOC_N = 512
BIG_N = 1024
# out-of-core against dense: name -> (grid size, switches); the bicubic
# and f(R) checks run at 128^3 to keep the whole run inside its time budget
# (the ooc_mesh_fmax phases hold both models' out-of-core runs at 256^3)
OOC_CHECKS = {"classic": (256, PLC), "tabulated": (128, TAB),
              "scaledep": (128, FR)}
# the big out-of-core fmax phases: name -> (grid size, ooc, switches,
# launch set); at BIG_N under ooc='auto', where the planner must choose the
# out-of-core engine; the bicubic lookup runs at OOC_N with ooc='on' (cut
# from BIG_N to keep the whole run inside its time budget: K13 is timed at
# 512^3 in the kernel phases)
BIG = {"classic": (BIG_N, "auto", {}, OOC),
       "tabulated": (OOC_N, "on", TAB, ooc_tab("bicubic")),
       "scaledep": (BIG_N, "auto", dict(FR, recompute_displacements=False),
                    OOC_FR)}
# name -> (grid size, Params switches, the path's launch set)
PATHS = {
    "classic": (PIPELINE_N, {}, CLASSIC),
    "tabulated": (PIPELINE_N, dict(ell_model="tabulated",
                                   ct_interp="bicubic"),
                  DENSE | {"collapse_update_table_bicubic",
                           "kspace_gradient"}),
    "scaledep": (PIPELINE_N, FR, DENSE | {"collapse_update",
                                          "kspace_gradient_tab"}),
    "tabulated_trilinear": (128, dict(ell_model="tabulated",
                                      ct_interp="trilinear"),
                            DENSE | {"collapse_update_table_trilinear",
                                     "kspace_gradient"}),
    "tabulated_bilinear": (128, dict(ell_model="tabulated",
                                     ct_interp="bilinear"),
                           DENSE | {"collapse_update_table_bilinear",
                                    "kspace_gradient"}),
    "ooc": (PIPELINE_N, dict(ooc="on"), OOC),
    "ooc_tabulated": (PIPELINE_N, dict(TAB, ooc="on"), ooc_tab("bicubic")),
    "ooc_tabulated_trilinear": (128, dict(ooc="on", ell_model="tabulated",
                                          ct_interp="trilinear"),
                                ooc_tab("trilinear")),
    "ooc_tabulated_bilinear": (128, dict(ooc="on", ell_model="tabulated",
                                         ct_interp="bilinear"),
                               ooc_tab("bilinear")),
    "ooc_scaledep": (PIPELINE_N, dict(FR, ooc="on", DumpProducts=True),
                     OOC_FR),
    "plc": (PIPELINE_N, dict(PLC, **SNAPSHOT), CLASSIC),
    "subbox": (PIPELINE_N, dict(PLC, subbox_tasks=CORES, **SNAPSHOT),
               CLASSIC),
    "mesh": (PIPELINE_N, {}, MESH),
    "ooc_mesh": (PIPELINE_N, dict(ooc="on"), OOC),
}
# paths over a mesh of the one card: name -> (decomposition, mesh shape);
# the out-of-core engine shards its ledger over the mesh's devices in flat
# order whatever the decomposition
MESH_PATHS = {"mesh": ("pencil", (2, 2)), "ooc_mesh": ("slab", (4,))}
# the fmax phase alone over other meshes of the card: name ->
# (decomposition, mesh shape, switches, launch set, grid size); the slab and
# volumes meshes run at 128^3 to keep the whole run inside its time budget
MESH_FMAX = {"mesh_slab4": ("slab", (4,), {}, MESH, 128),
             "mesh_volume222": ("volumes", (2, 2, 2), {}, MESH, 128),
             "mesh_scaledep": ("pencil", (2, 2), FR, MESH_FR, PIPELINE_N)}
# the out-of-core fmax phase alone at PIPELINE_N over shards of the card,
# held to the single-device engine: name -> (shards, switches, launch set);
# 3 shards split the 129 kz planes 43 / 43 / 43 and the 16 x-slabs 6 / 5 / 5
OOC_MESH_FMAX = {
    "ooc_mesh_bicubic3": (3, TAB, ooc_tab("bicubic")),
    "ooc_mesh_bicubic4": (4, TAB, ooc_tab("bicubic")),
    "ooc_mesh_scaledep3": (3, FR, OOC_FR),
    "ooc_mesh_scaledep4": (4, FR, OOC_FR)}
# shards of the card for the fmax phase at BIG_N
OOC_MESH_BIG = 4
# card-vs-CPU checks: path -> (grid size, switches over the path's); the
# plc path's cone stops at z 0.1, as a deeper one fills the crossing buffer
# (4 Nmax) of a 64 Mpc/h box
REFERENCE = {"classic": (48, {}), "tabulated": (64, {}), "scaledep": (64, {}),
             "plc": (64, dict(StartingzForPLC=0.1)),
             "subbox": (64, dict(StartingzForPLC=0.1, subbox_tasks=4)),
             "mesh": (48, {}), "hosts": (48, dict(subbox_tasks=4))}
# the classic path's halos at PIPELINE_N per output (z = 2, 1, 0.5, 0),
# recorded on an NVIDIA H100 80GB HBM3 with the kernels of commit a7598f1,
# before K1 and K6b were redesigned: the redesigned kernels give the same
# delta and the same FmaxPDF, so the catalogs must not move
CLASSIC_HALOS = (49706, 62173, 63610, 62929)
# what later phases hold to: the classic path's host products and grid
# variance (special modes), its fmax result, catalogs and timings (the
# sub-box turns); the plc path's catalogs, crossings and timings (the
# subbox path)
KEPT = {}


class CheckFailed(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise CheckFailed(what)


def time_ms(fn, reps=REPS):
    """Median over ``reps`` calls of fn's device time, CUDA events."""
    import torch
    fn()                                   # warm-up (and Triton compile)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(fn, calls=20, reps=REPS):
    """Median over ``reps`` runs of the device time of one call of fn when
    ``calls`` calls run back to back, so that the host's enqueue of a call
    hides behind the card's work on the one before; CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_ms(fn, calls=50):
    """The host's time to enqueue one call of fn, on the host's clock over
    ``calls`` calls back to back (the card idle before the first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return ms


def misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary: the collapse kernels load its cells directly instead of
    through the bulk-copy ring (the same cells, grid and partials)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def bound(name, nbytes, nelem):
    """(bound_ms, bound_by) of a call that must move nbytes and does
    OPS[name] operations on each of its nelem elements."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = OPS[name] * nelem / PEAK_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def record_phase(rec, N, name, err, tol, ms, plain_ms, nbytes, nelem,
                 library_ms=None, extra=""):
    """Print one kernel's line at N^3 and fill rec[name] with its
    max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms; fails when
    err exceeds tol."""
    ok = err <= tol
    bms, by = bound(name, nbytes, nelem)
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    print(f"  [{N}^3] {name:<22s} max_abs_err {err:.3e} "
          f"(tolerance {tol:.3e}) {extra}kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms{lib}, bound {bms:.3f} ms ({by}) "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    need(ok, f"{name} at {N}^3 disagrees with its plain version")
    rec[name] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=library_ms)


def same_values(a, b):
    """Whether two tensors hold equal values (complex ones part by part)."""
    import torch
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return torch.equal(a, b)


def same_bits(a, b):
    """Whether two float32 or complex64 tensors hold the same bits (so a
    signed zero equals only itself)."""
    import torch
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def adversarial_F(dev):
    """Inputs that K6b's bins must take as the plain version does (the card
    test's, tests/torch_hist_cases.py): {name: float32 tensor on dev}."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_hist_cases import adversarial_F as cases
    return cases(dev)


def card_mesh(dev, kind, shape):
    """A mesh of math.prod(shape) shards, every one on the device ``dev``:
    kind 'slab', 'pencil' or 'volumes' in the mesh shape ``shape``."""
    from pinocchio_tpu_torch.parallel import pfft
    devices = [dev] * math.prod(shape)
    if kind == "slab":
        return pfft.make_mesh(devices=devices)
    if kind == "pencil":
        return pfft.make_pencil_mesh(shape=shape, devices=devices)
    return pfft.make_volume_mesh(shape=shape, devices=devices)


def params_for(N, **kw):
    from pinocchio_tpu_torch.config import Params
    args = dict(GridSize=N, BoxSize=float(N), output_z=list(OUTPUT_Z),
                norad=True, plc_enabled=False)
    args.update(kw)
    return Params(**args)


def collapse_branches(sd, pack, cells):
    """K3's time per cell on the cells of each branch of ell_classic: the
    stack's cells that take the single-root branch (the cube root) and the
    three-root branch (a second acos and cos), each drawn with replacement
    into a stack of ``cells`` cells so that no warp diverges; prints the
    share of each branch and its time per cell through the bulk-copy ring
    and with direct loads.  Returns {branch: (share, ns_ring, ns_direct)}."""
    import torch
    from pinocchio_tpu_torch.ops import collapse as c
    l1, l2, l3, fail = c.eigenvalues_descending(sd)
    delta = l1 + l2 + l3
    den = l1 * l2 * l3 * c.INV126 + 5.0 * l1 * delta * (delta - l1) * c.INV84
    rden = 1.0 / den
    a1 = 3.0 * l1 * (delta - l1) * c.INV14 * rden
    a2 = l1 * rden
    q = (a1 * a1 - 3.0 * a2) * c.INV9
    r = (2.0 * (a1 * a1 * a1) - 9.0 * a1 * a2 - 27.0 * rden) * c.INV54
    regular = (~fail) & (l1.abs() >= c.SMALL) & (den.abs() >= c.SMALL)
    single = (regular & (r * r - q * q * q > 0.0)).reshape(-1)
    three = (regular.reshape(-1)) & (~single)
    del l1, l2, l3, fail, delta, den, rden, a1, a2, q, r, regular
    flat = sd.reshape(6, -1)
    gen = torch.Generator(device=sd.device).manual_seed(0)
    out = {}
    for name, mask in (("single-root", single), ("three-root", three)):
        where = mask.nonzero().reshape(-1)
        pick = where[torch.randint(where.numel(), (cells,), generator=gen,
                                   device=sd.device)]
        derivs = flat[:, pick].contiguous()
        skew = misaligned(derivs)
        F = torch.full((cells,), -10.0, device=sd.device)
        R = torch.full((cells,), -1, dtype=torch.int32, device=sd.device)
        ring = time_ms(lambda: c.collapse_update(derivs, F, R, 1, pack))
        direct = time_ms(lambda: c.collapse_update(skew, F, R, 1, pack))
        share = where.numel() / mask.numel()
        out[name] = (share, 1e6 * ring / cells, 1e6 * direct / cells)
        del derivs, skew, F, R, pick, where
    print("  collapse_update by branch of ell_classic (share of the stack's "
          "cells; ns per cell through the ring / with direct loads): "
          + "; ".join(f"{k} {100 * v[0]:.1f}%, {v[1]:.4f} / {v[2]:.4f}"
                      for k, v in out.items()), flush=True)
    return out


def k6a_path_phase(N, dev, rec, p, cosmo, grid, sm, delta):
    """K6a on the classic path's own state at N^3: Fmax after the whole
    radius loop (fmax.fmax_loop) and four distinct random [3, N^3] stacks;
    the rank kernel and gather_rows held to their plain versions bit for
    bit, timed beside one index_select per stack and of F on the same rows
    (gather_rows timed with its rank built inside, as one call of the
    function, and with the rank given, as a hand-off with several sets
    runs it); fills rec["needed_rank"] and rec["gather_rows"]."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax
    from pinocchio_tpu_torch.ops import compact

    cells = N ** 3
    radii = (sm.radii / grid.CellSize).astype(np.float32)
    Fmax, Rmax, stats, sd = fmax.fmax_loop(
        delta, radii, fmax.inverse_growth_packs(cosmo, sm), N)
    del Rmax, stats, sd
    idx = compact.needed_order(Fmax, p.Flast)
    count = idx.numel()
    gen = torch.Generator(device=dev).manual_seed(N)
    stacks = [torch.randn((3, N, N, N), generator=gen, device=dev)
              for _ in range(4)]

    rank = compact.needed_rank(idx, cells)
    want_rank = compact.needed_rank_plain(idx, cells)
    need(torch.equal(rank, want_rank), f"needed_rank at {N}^3 is not "
         "identical to its plain version")
    ar = torch.arange(count, dtype=torch.int32, device=dev)
    filled = torch.full((cells,), -1, dtype=torch.int32, device=dev)
    record_phase(rec, N, "needed_rank", 0.0, 0.0,
                 time_ms(lambda: compact.needed_rank(idx, cells)),
                 time_ms(lambda: compact.needed_rank_plain(idx, cells)),
                 8 * count + 4 * cells, count,
                 library_ms=time_ms(lambda: filled.index_copy_(0, idx, ar)),
                 extra=f"identical, {count} rows (library: index_copy_ of "
                 "the ranks, without the fill), ")
    del want_rank, ar, filled

    size = compact.packed_size(count, len(stacks), True)
    got = torch.empty(size, device=dev)
    want = torch.empty(size, device=dev)
    compact.gather_rows(idx, stacks, got, F=Fmax, rank=rank)
    compact.gather_rows_plain(idx, stacks, want, F=Fmax)
    need(torch.equal(got.view(torch.int32), want.view(torch.int32)),
         f"gather_rows at {N}^3 on the path's state is not identical to its "
         "plain version")
    got.zero_()
    compact.gather_rows(idx, stacks, got, F=Fmax)
    need(torch.equal(got.view(torch.int32), want.view(torch.int32)),
         f"gather_rows at {N}^3 without a rank is not identical")
    Fflat = Fmax.reshape(-1)
    flat = [v.reshape(3, -1) for v in stacks]
    ranked_ms = time_ms(lambda: compact.gather_rows(idx, stacks, got,
                                                    F=Fmax, rank=rank))
    record_phase(rec, N, "gather_rows", 0.0, 0.0,
                 time_ms(lambda: compact.gather_rows(idx, stacks, got,
                                                     F=Fmax)),
                 time_ms(lambda: compact.gather_rows_plain(idx, stacks, want,
                                                           F=Fmax)),
                 count * (8 + 12 + 24 * len(stacks)), count,
                 library_ms=time_ms(lambda: [Fflat.index_select(0, idx)] + [
                     v.index_select(1, idx) for v in flat]),
                 extra=f"identical, the path's state: {count} rows "
                 f"({100 * count / cells:.1f}% of N^3) of 4 distinct "
                 f"stacks, with its rank ({ranked_ms:.3f} ms with the rank "
                 "given), ")
    rec["gather_rows"].update(rows=count, ranked_ms=ranked_ms)
    del got, want, stacks, flat, rank, idx, Fmax, Fflat
    torch.cuda.empty_cache()


# the kernels whose compiled form compiled_report prints: a pattern of the
# mangled name -> a label
COMPILED = {r"rank_kernel": "needed_rank",
            r"record_quad_kernel": "record pass (quads)",
            r"record_cell_kernel": "record pass (cells)",
            r"column_kernel": "column pass",
            r"hist_kernel": "pdf_hist",
            r"kdensity_kernel": "ic modes (K1, K1s)",
            r"kdensity_planes_kernel": "ic planes (K9)",
            r"pk_table_kernel": "ic P(k) table",
            r"collapse_kernelILi(\d)E(?:Lb([01])E)?": None}
COLLAPSE_MODES = ("classic", "trilinear", "bilinear", "bicubic")
FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DEPBAR.F64", "F2F.F64",
            "F2F.F32.F64", "MUFU.RCP64H", "MUFU.RSQ64H", "DMMA")


def _compiled_label(name):
    """The label of a mangled kernel name in COMPILED, or None."""
    import re
    for pat, label in COMPILED.items():
        m = re.search(pat, name)
        if m:
            if label is None:
                mode, ring = int(m.group(1)), m.group(2) == "1"
                return (f"collapse_kernel<{COLLAPSE_MODES[mode]}, "
                        f"{'ring' if ring else 'direct'}>")
            return label
    return None


def _ptxas_report(path):
    """{label: (registers, spill stores, spill loads)} from ptxas -v."""
    import re
    out, label, spills = {}, None, (0, 0)
    if not os.path.exists(path):
        return out
    with open(path) as fd:
        for line in fd:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                label = _compiled_label(m.group(1))
                spills = (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and label is not None:
                out[label] = (int(m.group(1)),) + spills
                label = None
    return out


def _sass_report(library):
    """{label: (instructions, float64 instructions, calls)} of the SASS
    that cuobjdump shows for the library, or {} without cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    res = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300)
    out, label = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = _compiled_label(m.group(1))
            if label is not None:
                out[label] = [0, 0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if m and label is not None:
            op = m.group(1)
            out[label][0] += 1
            out[label][1] += op.startswith(FP64_OPS)
            out[label][2] += op.startswith("CALL")
    return {k: tuple(v) for k, v in out.items()}


def compiled_report(dev):
    """What the compiler made of the redesigned kernels: registers and
    spills from ptxas -v (kept by the build), the runtime's registers,
    spill bytes, shared memory and resident blocks per SM (the occupancy
    query), and the static SASS instruction, float64 instruction and call
    counts (cuobjdump); then the cube root's proof on every positive finite
    float32 and the proof of K1's phases (ic.phase_check).  Returns {label:
    dict}."""
    import torch
    from pinocchio_tpu_torch import ic, kernels
    from pinocchio_tpu_torch.ops import collapse, compact
    lib = kernels.library_path()
    ptx = _ptxas_report(kernels.ptxas_path(lib))
    sass = _sass_report(lib)
    runtime = dict(compact.kernel_info())
    runtime.update(ic.kernel_info())
    for m, mode in enumerate(COLLAPSE_MODES):
        for ring in ((True, False) if m == 0 else (False,)):
            label = (f"collapse_kernel<{mode}, "
                     f"{'ring' if ring else 'direct'}>")
            runtime[label] = collapse.kernel_info(
                None if m == 0 else mode, ring)
    out = {}
    print("  compiled kernels: ptxas registers / spill stores / spill loads; "
          "runtime registers / local bytes / shared bytes / resident 256-"
          "thread blocks per SM; SASS instructions / float64 / calls",
          flush=True)
    for label, rt in runtime.items():
        out[label] = dict(ptxas=ptx.get(label), runtime=rt,
                          sass=sass.get(label))
        print(f"    {label:<32s} ptxas {ptx.get(label, 'not kept')}; "
              f"runtime {rt}; SASS {sass.get(label, 'not read')}",
              flush=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    bad, near = collapse.cbrt_check(dev)
    end.record()
    torch.cuda.synchronize()
    print(f"  cube root: {bad} of the 2139095041 floats 0 to +inf differ "
          f"from the float64 pow rounded once (need 0); {near} lie near a "
          f"float32 midpoint and take the pow; "
          f"{start.elapsed_time(end):.1f} ms", flush=True)
    need(bad == 0, f"the kernel's cube root differs from the float64 pow on "
         f"{bad} floats")
    out["cbrt"] = dict(differ=bad, near_midpoint=near,
                       ms=start.elapsed_time(end))
    torch.cuda.synchronize()
    start.record()
    phases, values, zeros = ic.phase_check(dev)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    print(f"  K1's phases: of the {ic.PHASES} phases the generator can draw "
          f"(2^23 uniforms, and shifted by float32(pi)), {phases} differ from "
          f"the plain version's phase, {values} in sincosf from its sin and "
          f"cos, {zeros} in a dead mode's signed zeros from its signs of "
          f"sin and cos (need 0 each); {ms:.1f} ms", flush=True)
    need(phases == 0 and values == 0 and zeros == 0,
         f"K1's phases: {phases} phases, {values} sincosf values, {zeros} "
         "dead-mode signs differ")
    out["phases"] = dict(phases=ic.PHASES, phase_differ=phases,
                         sincos_differ=values, sign_differ=zeros, ms=ms)
    return out


def kernel_phases(N, dev, report):
    """Every kernel at N^3 against its plain version; fills report[N][name]
    with max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms of
    this size."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax, fmax_ooc, ic
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid, irfft3, rfft3
    from pinocchio_tpu_torch.ops import (collapse, compact, derivatives, lpt,
                                         tabulated)

    p = params_for(N)
    cosmo = Cosmology(p)
    grid = Grid(N, p.BoxSize_htrue)
    sm = fmax.Smoothing.build(p, cosmo)
    Nh = N // 2 + 1
    modes, cells = N * N * Nh, N ** 3
    rec = {}

    def phase(*args, **kw):
        record_phase(rec, N, *args, **kw)

    same = same_values

    # ---- K1: initial conditions.  delta must equal the plain version's
    # bit for bit, which needs bit-identical phase and amplitude draws ----
    kp, ka = ic.split(ic.prng_key(p.RandomSeed))
    logk, logpk = ic.pk_table(cosmo, grid)
    logk, logpk = torch.from_numpy(logk).to(dev), torch.from_numpy(logpk).to(dev)
    logkf = float(np.float32(math.log10(2.0 * math.pi / grid.BoxSize)))
    fac = float(np.float32(grid.BoxSize ** -1.5 * float(N) ** 3))
    args = (N, logk, logpk, kp, ka, logkf, fac, False, False)
    # FixedIC and PairedIC first (bit for bit, untimed)
    for fixed, paired in ((True, False), (False, True)):
        sw = args[:7] + (fixed, paired)
        need(same_bits(ic.kdensity(*sw), ic.kdensity_plain(*sw)),
             f"ic_kdensity at {N}^3 (fixed {fixed}, paired {paired}) is not "
             "bit for bit its plain version")
    delta = ic.kdensity(*args)
    ref = ic.kdensity_plain(*args)
    err = (delta - ref).abs().max().item()
    need(same_bits(delta, ref),
         f"ic_kdensity at {N}^3 is not bit for bit its plain version")
    zeros = int((ref == 0).sum())
    del ref

    def k1():
        return ic.kdensity(*args)
    ms, batch, host = time_ms(k1), batch_ms(k1), host_ms(k1)
    phase("ic_kdensity", err, 1e-5 * delta.abs().max().item(), ms,
          time_ms(lambda: ic.kdensity_plain(*args)),
          8 * modes + 8 * logk.numel(), modes,
          extra=f"bit for bit (signed zeros of {zeros} dead modes "
          f"included; FixedIC and PairedIC too; 20 calls back to back "
          f"{batch:.3f} ms a call, the host's enqueue {host:.3f} ms), ")
    rec["ic_kdensity"].update(dead_modes=zeros, batch_ms=batch,
                              host_ms=host)

    # ---- K2: Hessian multiply (a mid radius and R=0) ----
    R_mid = float(np.float32(sm.radii[sm.n // 2] / grid.CellSize))
    for R in (R_mid, 0.0):
        got = derivatives.hessian_kspace(delta, R, N)
        ref = derivatives.hessian_kspace_plain(delta, R, N)
        err = (got - ref).abs().max().item()
        tol = 1e-6 * ref.abs().max().item()
        if R == 0.0:
            phase("kspace_hessian", err, tol,
                  time_ms(lambda: derivatives.hessian_kspace(delta, R, N)),
                  time_ms(lambda: derivatives.hessian_kspace_plain(
                      delta, R, N)), 56 * modes, modes,
                  extra=f"R={R:g} ")
        else:
            need(err <= tol, f"kspace_hessian at R={R} disagrees")
            print(f"  [{N}^3] kspace_hessian R={R:.4f}: max_abs_err "
                  f"{err:.3e} (tolerance {tol:.3e}) -> ok", flush=True)
        del got, ref

    # ---- K5: gradient multiply ----
    D1 = float(cosmo.GrowingMode(0.0))
    got = derivatives.gradient_kspace(delta, D1, N)
    ref = derivatives.gradient_kspace_plain(delta, D1, N)
    phase("kspace_gradient", (got - ref).abs().max().item(),
          1e-6 * ref.abs().max().item(),
          time_ms(lambda: derivatives.gradient_kspace(delta, D1, N)),
          time_ms(lambda: derivatives.gradient_kspace_plain(delta, D1, N)),
          32 * modes, modes)
    del got, ref

    # ---- K3: collapse update on the mid-radius stack, from a state
    # left by the first radius ----
    pack = fmax.inverse_growth_packs(cosmo, sm)[0]
    sd0 = derivatives.second_derivatives(
        delta, float(np.float32(sm.radii[0] / grid.CellSize)), N)
    F0 = torch.full((N, N, N), -10.0, dtype=torch.float32, device=dev)
    R0 = torch.full((N, N, N), -1, dtype=torch.int32, device=dev)
    collapse.collapse_update_plain(sd0, F0, R0, 0, pack)
    del sd0
    sd = derivatives.second_derivatives(delta, R_mid, N)
    Fk, Rk = F0.clone(), R0.clone()
    mk = collapse.collapse_update(sd, Fk, Rk, 1, pack)
    Fp, Rp = F0.clone(), R0.clone()
    mp = collapse.collapse_update_plain(sd, Fp, Rp, 1, pack)
    dF = (Fk - Fp).abs()
    okF = (dF <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)).double().mean().item()
    okR = (Rk == Rp).double().mean().item()
    exact = (Fk == Fp).double().mean().item()
    rel = abs(mk[1].item() / mp[1].item() - 1.0)
    print(f"  [{N}^3] collapse_update: F equal on {100 * exact:.4f}% (need "
          f"100%), within 1e-4*max(1,|F|) on "
          f"{100 * okF:.4f}%, Rmax equal on "
          f"{100 * okR:.4f}% (need 100%), mean delta^2 rel err "
          f"{rel:.2e} (need <= 1e-5)", flush=True)
    need(exact == 1.0 and okR == 1.0 and rel <= 1e-5,
         f"collapse_update at {N}^3 disagrees with its plain version")
    # the same stack 4 bytes off a 16-byte boundary takes direct loads
    skew = misaligned(sd)
    Ft, Rt = F0.clone(), R0.clone()
    md = collapse.collapse_update(skew, Ft, Rt, 1, pack)
    need(torch.equal(Ft, Fk) and torch.equal(Rt, Rk) and torch.equal(md, mk),
         f"collapse_update at {N}^3 with direct loads differs")
    Ft, Rt = F0.clone(), R0.clone()
    ms = time_ms(lambda: collapse.collapse_update(sd, Ft, Rt, 1, pack))
    direct = time_ms(lambda: collapse.collapse_update(skew, Ft, Rt, 1, pack))
    del skew
    Ft, Rt = F0.clone(), R0.clone()
    plain_ms = time_ms(lambda: collapse.collapse_update_plain(
        sd, Ft, Rt, 1, pack))
    phase("collapse_update", dF.max().item(), 0.0, ms, plain_ms,
          36 * cells, cells, extra=f"identical (direct loads {direct:.3f} "
          "ms), ")
    rec["collapse_update"]["direct_ms"] = direct
    rec["collapse_update"]["branches"] = collapse_branches(sd, pack, cells)
    del Fk, Rk, Fp, Rp, Ft, Rt, dF

    # ---- K7: the three table lookups on the same stack and state, with
    # the port's classic tables of the two radii ----
    keep = [0, sm.n // 2]
    sub = fmax.Smoothing(radii=sm.radii[keep], variance=sm.variance[keep])
    ct = tabulated.build_ct_tables_all(cosmo, sub)
    tabs = fmax.load_jax_state({k: ct[k] for k in ("tables", "tables2", "dv",
                                                   "idx_map")}, dev)
    targs = (tabs["tables"][1], tabs["tables2"][1], tabs["dv"],
             tabs["idx_map"], float(ct["ampl"][1]))
    table_bytes = 8 * targs[0].numel() + 4 * (targs[2].numel()
                                              + targs[3].numel())
    for interp in tabulated.INTERP:
        name = f"collapse_update_table_{interp}"
        Fk, Rk = F0.clone(), R0.clone()
        mk = collapse.collapse_update_table(sd, Fk, Rk, 1, *targs, interp)
        Fp, Rp = F0.clone(), R0.clone()
        mp = collapse.collapse_update_table_plain(sd, Fp, Rp, 1, *targs,
                                                  interp)
        dF = (Fk - Fp).abs()
        okF = (dF <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)).double().mean()
        exact = (Fk == Fp).double().mean().item()
        okR = (Rk == Rp).double().mean().item()
        rel = abs(mk[1].item() / mp[1].item() - 1.0)
        print(f"  [{N}^3] {name}: F equal on {100 * exact:.4f}% (need "
              f"100%), within 1e-4*max(1,|F|) on {100 * okF.item():.4f}%, "
              f"Rmax equal on {100 * okR:.4f}% (need 100%), mean delta^2 rel "
              f"err {rel:.2e} (need <= 1e-5)", flush=True)
        need(exact == 1.0 and okR == 1.0 and rel <= 1e-5,
             f"{name} at {N}^3 disagrees with its plain version")
        Ft, Rt = F0.clone(), R0.clone()
        ms = time_ms(lambda: collapse.collapse_update_table(
            sd, Ft, Rt, 1, *targs, interp))
        Ft, Rt = F0.clone(), R0.clone()
        plain_ms = time_ms(lambda: collapse.collapse_update_table_plain(
            sd, Ft, Rt, 1, *targs, interp))
        phase(name, dF.max().item(), 0.0, ms, plain_ms,
              36 * cells + table_bytes, cells, extra="identical, ")
        del Fk, Rk, Fp, Rp, Ft, Rt, dF

    # ---- K6a and K6b: the needed rows of four stacks (overlapping views
    # of the Hessian), and the FmaxPDF histogram, of the state after the mid
    # radius; K6a's row is taken at the path's state (k6a_path_phase) ----
    collapse.collapse_update_plain(sd, F0, R0, 1, pack)
    idx = compact.needed_order(F0, p.Flast)
    count = idx.numel()
    stacks = [sd[i:i + 3] for i in (0, 3, 1, 2)]
    size = compact.packed_size(count, len(stacks), True)
    got = torch.empty(size, device=dev)
    want = torch.empty(size, device=dev)
    compact.gather_rows(idx, stacks, got, F=F0)
    compact.gather_rows_plain(idx, stacks, want, F=F0)
    need(torch.equal(got.view(torch.int32), want.view(torch.int32)),
         f"gather_rows at {N}^3 is not identical to its plain version")
    Fflat = F0.reshape(-1)
    flat = [v.reshape(3, -1) for v in stacks]
    mid = dict(rows=count,
               ms=time_ms(lambda: compact.gather_rows(idx, stacks, got,
                                                      F=F0)),
               library_ms=time_ms(lambda: [Fflat.index_select(0, idx)] + [
                   v.index_select(1, idx) for v in flat]))
    print(f"  [{N}^3] gather_rows after the mid radius: identical, {count} "
          f"rows ({100 * count / cells:.1f}% of N^3) of 4 overlapping views "
          f"of the Hessian: kernel {mid['ms']:.3f} ms (with its rank), "
          f"index_select {mid['library_ms']:.3f} ms", flush=True)
    del got, want, stacks, flat
    got = compact.pdf_hist(F0)
    want = compact.pdf_hist_plain(F0)
    need(torch.equal(got, want), f"pdf_hist at {N}^3 is not identical to "
         "its plain version")
    bins = torch.clamp(torch.nan_to_num(Fflat * 10.0, nan=0.0), 0.0,
                       209.0).to(torch.int64)
    def k6b():
        return compact.pdf_hist(F0)
    ms, batch, host = time_ms(k6b), batch_ms(k6b), host_ms(k6b)
    phase("pdf_hist", (got - want).abs().max().item(), 0.0, ms,
          time_ms(lambda: compact.pdf_hist_plain(F0)),
          4 * cells + 8 * compact.PDF_BINS, cells,
          library_ms=time_ms(lambda: torch.bincount(
              bins, minlength=compact.PDF_BINS)),
          extra=f"identical (library: bincount of the bins; 20 calls back "
          f"to back {batch:.3f} ms a call, the host's enqueue {host:.3f} "
          "ms), ")
    rec["pdf_hist"].update(batch_ms=batch, host_ms=host)
    del bins
    cases = adversarial_F(dev)
    for what, F in cases.items():
        got = compact.pdf_hist(F)
        need(torch.equal(got, compact.pdf_hist_plain(F))
             and int(got.sum()) == F.numel(),
             f"pdf_hist on {what} ({F.numel()} cells) differs from its "
             "plain version")
    print(f"  [{N}^3] pdf_hist on the adversarial inputs "
          f"({', '.join(cases)}): identical", flush=True)
    del cases

    # ---- the out-of-core engine's kernels at the shapes of its path: a kz
    # batch of planes, an x-slab ----
    B = min(fmax_ooc.KZ_BATCH, Nh)
    Bx = fmax_ooc.slab_width(N)
    gen = ic.PlaneGenerator(grid, cosmo, p.RandomSeed, dev)
    planes = gen(0, B)
    gen_args = (N, gen.logk, gen.logpk, gen.keys)
    ref = ic.kdensity_planes_plain(*gen_args, 0, B, gen.logkf, gen.fac,
                                   False, False)
    need(same_bits(planes, ref), f"ic_kdensity_planes at {N}^3 is not bit "
         "for bit its plain version")
    # the last batch (it holds the Nyquist plane kz = N/2 and ends at Nh),
    # from the generator and from the public wrapper (which builds its
    # P(k) table in the call)
    last = (Nh - B, B)
    need(same_bits(gen(*last), ic.kdensity_planes_plain(
        *gen_args, *last, gen.logkf, gen.fac, False, False))
         and same_bits(ic.kdensity_planes(*gen_args, *last, gen.logkf,
                                          gen.fac, False, False),
                       gen(*last)),
         f"ic_kdensity_planes at {N}^3, planes {Nh - B}..{Nh - 1}, is not "
         "bit for bit its plain version")
    with_table = time_ms(lambda: ic.kdensity_planes(
        *gen_args, 0, B, gen.logkf, gen.fac, False, False))

    def k9():
        return gen(0, B)
    ms, batch, host = time_ms(k9), batch_ms(k9), host_ms(k9)
    phase("ic_kdensity_planes", (planes - ref).abs().max().item(), 0.0, ms,
          time_ms(lambda: ic.kdensity_planes_plain(
              *gen_args, 0, B, gen.logkf, gen.fac, False, False)),
          8 * B * N * N + 16 * B + 8 * gen.logk.numel(),
          B * N * N, extra=f"bit for bit (and planes {Nh - B}..{Nh - 1}), "
          f"[{B}, {N}, {N}] (with its P(k) table built in the call "
          f"{with_table:.3f} ms; 20 calls back to back {batch:.3f} ms a "
          f"call, the host's enqueue {host:.3f} ms), ")
    rec["ic_kdensity_planes"].update(with_table_ms=with_table,
                                     batch_ms=batch, host_ms=host)
    del ref
    spec = delta[:, :, 1:1 + B].permute(2, 0, 1)      # a strided batch
    kz_cases = (
        ("ooc_factors_hessian", lambda f: f(planes, 0, R_mid, N),
         derivatives.ooc_hessian, derivatives.ooc_hessian_plain, 56),
        ("ooc_factors_gradient", lambda f: f(spec, 1, D1, N),
         derivatives.ooc_gradient, derivatives.ooc_gradient_plain, 32),
        ("ooc_factors_pair", lambda f: f(planes, spec, 0, 0, 1, N),
         derivatives.ooc_pair, derivatives.ooc_pair_plain, 32))
    for name, call, kern, plain, per_mode in kz_cases:
        got, ref = call(kern), call(plain)
        ident = same(got, ref)
        phase(name, (got - ref).abs().max().item(),
              1e-6 * ref.abs().max().item(), time_ms(lambda: call(kern)),
              time_ms(lambda: call(plain)), per_mode * B * N * N, B * N * N,
              extra=("identical, " if ident else ""))
        del got, ref
    del planes, spec

    # K11 on the first x-slab of the mid-radius stack, from an empty state;
    # K3 on the same slab must give the same F
    sd_slab = sd[:, :Bx].contiguous()
    F_slab = torch.full((Bx, N, N), -10.0, device=dev)
    Fk, Fp, F3 = F_slab.clone(), F_slab.clone(), F_slab.clone()
    mk = collapse.collapse_update_slab(sd_slab, Fk, pack)
    mp = collapse.collapse_update_slab_plain(sd_slab, Fp, pack)
    R3 = torch.zeros_like(F3, dtype=torch.int32)
    collapse.collapse_update(sd_slab, F3, R3, 1, pack)
    dF = (Fk - Fp).abs()
    okF = (dF <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)).double().mean().item()
    rel = abs(mk[1].item() / mp[1].item() - 1.0)
    print(f"  [{N}^3] collapse_update_slab [6, {Bx}, {N}, {N}]: F equal to "
          f"K3's on the slab: {torch.equal(Fk, F3)}, equal to the plain "
          f"version on {100 * (Fk == Fp).double().mean().item():.4f}% "
          f"(need 100%), within 1e-4*max(1,|F|) on {100 * okF:.4f}%, "
          f"mean delta^2 rel err {rel:.2e} (need <= 1e-5)", flush=True)
    need(torch.equal(Fk, F3) and torch.equal(Fk, Fp) and rel <= 1e-5,
         f"collapse_update_slab at {N}^3 disagrees")
    Ft = F_slab.clone()

    def k11():
        return collapse.collapse_update_slab(sd_slab, Ft, pack)
    ms, batch, host = time_ms(k11), batch_ms(k11), host_ms(k11)
    Ft = F_slab.clone()
    plain_ms = time_ms(lambda: collapse.collapse_update_slab_plain(
        sd_slab, Ft, pack))
    phase("collapse_update_slab", dF.max().item(), 0.0, ms, plain_ms,
          32 * sd_slab[0].numel(), sd_slab[0].numel(),
          extra=f"identical (20 calls back to back {batch:.3f} ms a call, "
          f"the host's enqueue {host:.3f} ms), ")
    rec["collapse_update_slab"].update(batch_ms=batch, host_ms=host)
    del Fk, Fp, F3, R3, Ft, dF

    # K13 on the same slab with each lookup, from the same state; K7 on the
    # slab (with an Rmax) must give the same F
    ncell = sd_slab[0].numel()
    for interp in tabulated.INTERP:
        name = f"collapse_update_slab_table_{interp}"
        Fk, Fp, F7 = F_slab.clone(), F_slab.clone(), F_slab.clone()
        mk = collapse.collapse_update_slab_table(sd_slab, Fk, *targs, interp)
        mp = collapse.collapse_update_slab_table_plain(sd_slab, Fp, *targs,
                                                       interp)
        R7 = torch.zeros_like(F7, dtype=torch.int32)
        collapse.collapse_update_table(sd_slab, F7, R7, 1, *targs, interp)
        dF = (Fk - Fp).abs()
        okF = (dF <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)).double().mean()
        exact = (Fk == Fp).double().mean().item()
        same7 = (Fk == F7).double().mean().item()
        rel = abs(mk[1].item() / mp[1].item() - 1.0)
        print(f"  [{N}^3] {name} [6, {Bx}, {N}, {N}]: F equal to the plain "
              f"version on {100 * exact:.4f}% and to K7's on the slab on "
              f"{100 * same7:.4f}% (need 100%), within 1e-4*max(1,|F|) "
              f"on {100 * okF.item():.4f}%, mean delta^2 rel "
              f"err {rel:.2e} (need <= 1e-5)", flush=True)
        need(exact == 1.0 and same7 == 1.0 and rel <= 1e-5,
             f"{name} at {N}^3 disagrees")
        Ft = F_slab.clone()

        def k13():
            return collapse.collapse_update_slab_table(sd_slab, Ft, *targs,
                                                       interp)
        ms, batch, host = time_ms(k13), batch_ms(k13), host_ms(k13)
        Ft = F_slab.clone()
        plain_ms = time_ms(lambda: collapse.collapse_update_slab_table_plain(
            sd_slab, Ft, *targs, interp))
        phase(name, dF.max().item(), 0.0, ms, plain_ms,
              32 * ncell + table_bytes, ncell,
              extra=f"identical (20 calls back to back {batch:.3f} ms a "
              f"call, the host's enqueue {host:.3f} ms), ")
        rec[name].update(batch_ms=batch, host_ms=host)
        del Fk, Fp, F7, R7, Ft, dF
    del tabs, targs, F_slab

    # K12: the needed rows of the first x-slab of a displacement-like
    # stack, into the rows buffer of all needed cells
    rank = compact.needed_rank(idx, cells)
    n_slab = Bx * N * N
    rk = rank[:n_slab]
    comps = sd[:3, :Bx].reshape(3, -1).contiguous()
    got = torch.zeros((count, 3), device=dev)
    want = torch.zeros((count, 3), device=dev)
    compact.vrows_slab(rk, comps, got)
    compact.vrows_slab_plain(rk, comps, want)
    need(torch.equal(got, want), f"vrows_slab at {N}^3 is not identical to "
         "its plain version")
    in_slab = int((rk >= 0).sum())
    phase("vrows_slab", (got - want).abs().max().item(), 0.0,
          time_ms(lambda: compact.vrows_slab(rk, comps, got)),
          time_ms(lambda: compact.vrows_slab_plain(rk, comps, want)),
          16 * n_slab + 12 * in_slab, n_slab,
          extra=f"identical, {in_slab} rows of a [3, {Bx}, {N}, {N}] slab, ")
    del got, want, rank, rk, comps, sd_slab, idx, F0, R0

    k6a_path_phase(N, dev, rec, p, cosmo, grid, sm, delta)
    rec["gather_rows"].update({f"mid_{k}": v for k, v in mid.items()})

    # ---- K8: tabulated growth (an f(R) cosmology, so that the growth
    # varies with k) on delta ----
    cosmo_fr = Cosmology(params_for(N, **FR))
    gtabs, glo, gdx = fmax.growth_k_tables(cosmo_fr, 0.0, N, dev)
    got = derivatives.gradient_kspace_tab(delta, gtabs[0], glo, gdx, N)
    ref = derivatives.gradient_kspace_tab_plain(delta, gtabs[0], glo, gdx, N)
    need(same(got, ref), f"kspace_gradient_tab at {N}^3 is not identical to "
         "its plain version")
    phase("kspace_gradient_tab", (got - ref).abs().max().item(), 0.0,
          time_ms(lambda: derivatives.gradient_kspace_tab(
              delta, gtabs[0], glo, gdx, N)),
          time_ms(lambda: derivatives.gradient_kspace_tab_plain(
              delta, gtabs[0], glo, gdx, N)),
          32 * modes + 4 * gtabs[0].numel(), modes, extra="identical, ")

    # ---- K14: the same growth table on a [B, N, N] kz batch of delta, as a
    # contiguous copy of its planes and as a strided view (a resident
    # spectrum's batch), against its plain version and K8's values ----
    kz0 = 1
    view = delta[:, :, kz0:kz0 + B].permute(2, 0, 1)
    k8 = got[..., kz0:kz0 + B].permute(0, 3, 1, 2)
    for what, src in (("contiguous", view.contiguous()), ("strided", view)):
        g14 = derivatives.ooc_gradient_tab(src, kz0, gtabs[0], glo, gdx, N)
        ref = derivatives.ooc_gradient_tab_plain(src, kz0, gtabs[0], glo,
                                                 gdx, N)
        need(same(g14, ref) and same(g14, k8), f"ooc_factors_gradient_tab "
             f"({what}) at {N}^3 is not identical to its plain version and "
             "K8")
    phase("ooc_factors_gradient_tab", (g14 - ref).abs().max().item(), 0.0,
          time_ms(lambda: derivatives.ooc_gradient_tab(
              view, kz0, gtabs[0], glo, gdx, N)),
          time_ms(lambda: derivatives.ooc_gradient_tab_plain(
              view, kz0, gtabs[0], glo, gdx, N)),
          32 * B * N * N + 4 * gtabs[0].numel(), B * N * N,
          extra=f"identical to the plain version and to K8, contiguous and "
          f"strided [{B}, {N}, {N}], ")
    del got, ref, g14, k8, view

    # ---- K4: the two LPT passes on the R=0 stack, and the accumulation of
    # one component pair on an x-slab (the out-of-core fold) ----
    sd = derivatives.second_derivatives(delta, 0.0, N)
    got = lpt.sources_pointwise(sd)
    ref = lpt.sources_pointwise_plain(sd)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    tol = 1e-5 * max(b.abs().max().item() for b in ref)
    phase("lpt_sources_pointwise", err, tol,
          time_ms(lambda: lpt.sources_pointwise(sd)),
          time_ms(lambda: lpt.sources_pointwise_plain(sd)), 36 * cells,
          cells)
    src32 = ref[2]
    phi2 = irfft3(derivatives.hessian_kspace(rfft3(ref[0]), 0.0, N), N)
    del got, ref
    want = lpt.src32_accumulate_plain(phi2, sd, src32)
    acc = lpt.src32_accumulate(phi2, sd, src32.clone())
    err = (acc - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    scratch = src32.clone()
    phase("lpt_src32_accumulate", err, tol,
          time_ms(lambda: lpt.src32_accumulate(phi2, sd, scratch)),
          time_ms(lambda: lpt.src32_accumulate_plain(phi2, sd, src32)),
          56 * cells, cells)
    a = phi2[3:4, :Bx].contiguous()
    b = sd[3:4, :Bx].contiguous()
    s_slab = src32[:Bx].contiguous()
    w = (lpt.PHI2_WEIGHTS[3],)
    want = lpt.src32_accumulate_plain(a, b, s_slab, w)
    acc = lpt.src32_accumulate(a, b, s_slab.clone(), weights=w)
    err = (acc - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    scratch = s_slab.clone()
    ms = time_ms(lambda: lpt.src32_accumulate(a, b, scratch, weights=w))
    plain_ms = time_ms(lambda: lpt.src32_accumulate_plain(a, b, s_slab, w))
    # one pair: 16 B and 3 of the six-pair pass's 18 operations per cell
    pb, pby = bound("lpt_src32_accumulate", 16 * s_slab.numel(),
                    s_slab.numel() / 6)
    print(f"  [{N}^3] lpt_src32_accumulate, one pair on a [{Bx}, {N}, {N}] "
          f"slab: max_abs_err {err:.3e} (tolerance {tol:.3e}) kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {pb:.3f} ms ({pby}) "
          f"-> {'ok' if err <= tol else 'FAIL'}", flush=True)
    need(err <= tol, f"lpt_src32_accumulate (one pair) at {N}^3 disagrees")
    rec["lpt_src32_accumulate"].update(pair_ms=ms, pair_plain_ms=plain_ms,
                                       pair_bound_ms=pb)
    del sd, phi2, src32, want, acc, scratch, delta, a, b, s_slab
    torch.cuda.empty_cache()
    report[N] = rec


def shard_kernel_phases(N, dev, report):
    """K1s, K2s (R=0, and a mid radius untimed), K5s and K8s at N^3 on the
    (1, 1) shard of a 2x2 pencil mesh's k layout, the window [N, N/2:N,
    Nhp/2:Nhp] whose last kz plane is padding, against their plain
    versions: exactly equal; fills report[N][name]."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax, ic
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid
    from pinocchio_tpu_torch.ops import derivatives
    from pinocchio_tpu_torch.parallel import pfft

    p = params_for(N)
    cosmo = Cosmology(p)
    grid = Grid(N, p.BoxSize_htrue)
    sm = fmax.Smoothing.build(p, cosmo)
    decomp = pfft.make_decomp(card_mesh(dev, "pencil", (2, 2)), N)
    y0, ny, z0, nz = decomp.k_window(3)
    modes = N * ny * nz
    rec = report.setdefault(N, {})
    logk, logpk, kp, ka, logkf, fac = ic.kdensity_args(grid, cosmo,
                                                       p.RandomSeed)
    tabs = (torch.from_numpy(logk).to(dev), torch.from_numpy(logpk).to(dev))
    args = (N, *tabs, kp, ka, logkf, fac, False, False, y0, ny, z0, nz)
    win = f"[{N}, {ny}, {nz}] at ({y0}, {z0}), "
    shard = ic.kdensity_shard(*args)
    ref = ic.kdensity_shard_plain(*args)
    need(same_bits(shard, ref), f"ic_kdensity_shard at {N}^3 is not bit "
         "for bit its plain version")
    # a ragged window: odd y0 and ny, reaching into the padded planes
    odd = args[:9] + (N // 2 + 1, N // 2 - 3, N // 4 + 1, N // 4 + 3)
    need(same_bits(ic.kdensity_shard(*odd), ic.kdensity_shard_plain(*odd)),
         f"ic_kdensity_shard at {N}^3 on the window {odd[9:]} is not bit "
         "for bit its plain version")
    record_phase(rec, N, "ic_kdensity_shard", 0.0, 0.0,
                 time_ms(lambda: ic.kdensity_shard(*args)),
                 time_ms(lambda: ic.kdensity_shard_plain(*args)),
                 8 * modes + 8 * logk.size, modes,
                 extra=f"bit for bit (and on the window {odd[9:]}), " + win)
    del ref
    R_mid = float(np.float32(sm.radii[sm.n // 2] / grid.CellSize))
    cosmo_fr = Cosmology(params_for(N, **FR))
    gtabs, glo, gdx = fmax.growth_k_tables(cosmo_fr, 0.0, N, dev)
    D1 = float(cosmo.GrowingMode(0.0))
    cases = (
        ("kspace_hessian_shard", derivatives.hessian_kspace_shard,
         derivatives.hessian_kspace_shard_plain, (R_mid,), 56, False),
        ("kspace_hessian_shard", derivatives.hessian_kspace_shard,
         derivatives.hessian_kspace_shard_plain, (0.0,), 56, True),
        ("kspace_gradient_shard", derivatives.gradient_kspace_shard,
         derivatives.gradient_kspace_shard_plain, (D1,), 32, True),
        ("kspace_gradient_tab_shard", derivatives.gradient_kspace_tab_shard,
         derivatives.gradient_kspace_tab_shard_plain, (gtabs[0], glo, gdx),
         32, True))
    for name, kern, plain, extra, per_mode, timed in cases:
        def call(f):
            return f(shard, *extra, N, y0, z0)
        got, ref = call(kern), call(plain)
        need(same_values(got, ref), f"{name} at {N}^3 {extra[:1]} is not "
             "identical to its plain version")
        if timed:
            tab = 4 * gtabs[0].numel() if "tab" in name else 0
            record_phase(rec, N, name, 0.0, 0.0, time_ms(lambda: call(kern)),
                         time_ms(lambda: call(plain)),
                         per_mode * modes + tab, modes,
                         extra="identical, " + win)
        del got, ref
    del shard
    torch.cuda.empty_cache()


def density_field_phase(N, dev, report):
    """Special mode 2's density_field at N^3: the port's two-step c2r of
    K1's delta (a library call; there is no plain version), its bound (read
    the spectrum once, write the field once) and torch.fft.irfftn of the
    same input; fills report[N]["density_field"]."""
    import torch
    from pinocchio_tpu_torch import ic
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid
    from pinocchio_tpu_torch.ops import derivatives

    p = params_for(N)
    delta = ic.generate_kdensity(Grid(N, p.BoxSize_htrue), Cosmology(p),
                                 p.RandomSeed, dev)
    dens = derivatives.density_field(delta, N)
    need(tuple(dens.shape) == (N, N, N) and bool(torch.isfinite(dens).all()),
         f"density_field at {N}^3: not a finite [N, N, N] field")
    full = torch.fft.irfftn(delta, s=(N, N, N), dim=(-3, -2, -1))
    diff = (full - dens).abs().max().item() / dens.abs().max().item()
    nbytes = 8 * N * N * (N // 2 + 1) + 4 * N ** 3
    rec = dict(ms=time_ms(lambda: derivatives.density_field(delta, N)),
               bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
               library_ms=time_ms(lambda: torch.fft.irfftn(
                   delta, s=(N, N, N), dim=(-3, -2, -1))))
    print(f"  [{N}^3] density_field (ifft2 + irfft, cuFFT): "
          f"{rec['ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms (bytes), "
          f"irfftn {rec['library_ms']:.3f} ms (differs by {diff:.1e} of "
          f"max|delta|)", flush=True)
    report.setdefault(N, {})["density_field"] = rec
    del delta, dens, full
    torch.cuda.empty_cache()


def c2r_check(dev):
    """The two c2r decompositions at 64^3 on a gradient-mode input (not
    Hermitian on the kx and ky Nyquist planes): the port's ifft2 + irfft on
    the card against the same on the CPU (pocketfft, the JAX package's
    convention), and torch.fft.irfftn on the card for information."""
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch import ic
    from pinocchio_tpu_torch.grids import Grid, irfft3
    from pinocchio_tpu_torch.ops import derivatives
    N = 64
    p = params_for(N)
    delta = ic.generate_kdensity(Grid(N, p.BoxSize_htrue), Cosmology(p),
                                 p.RandomSeed, dev)
    g = derivatives.gradient_kspace_plain(delta, 1.0, N)
    two_step = irfft3(g, N)
    cpu = irfft3(g.cpu(), N)
    full = torch.fft.irfftn(g, s=(N, N, N), dim=(-3, -2, -1))
    scale = cpu.abs().max().item()
    err = (two_step.cpu() - cpu).abs().max().item()
    err_n = (full.cpu() - cpu).abs().max().item()
    print(f"  [64^3] c2r: ifft2+irfft on the card vs CPU max_abs_err "
          f"{err:.3e} (tolerance {1e-5 * scale:.3e}); irfftn on the card vs "
          f"CPU {err_n:.3e} ({'agrees' if err_n <= 1e-5 * scale else 'differs'})",
          flush=True)
    need(err <= 1e-5 * scale, "the two-step c2r on the card disagrees with "
         "the CPU transform")


def host_rss():
    """This process's resident set in bytes (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as fd:
        for line in fd:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) * 1024.0
    return 0.0


class HostPeak:
    """The largest resident set of this process while the block runs,
    sampled every 5 ms by a thread, less its size at the start."""

    def __enter__(self):
        self.base = self.peak = host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, host_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, host_rss())

    def line(self, report):
        """The run's host peak beside the planner's estimate of its largest
        host phase."""
        grew, pred = self.peak - self.base, report["host_bytes"]
        return (f"host peak {grew / GiB:.2f} GiB above the start (VmRSS "
                f"sampled every 5 ms), planner {pred / GiB:.2f} GiB "
                f"({report['host']['phase']}; measured/predicted "
                f"{grew / pred:.3f})")


def run_path(dev, name):
    """Drive one path through run_pipeline with the launch counts set to 0
    just before it; returns (launch counts, timings)."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import kernels, planner
    from pinocchio_tpu_torch.run import run_pipeline

    N, kw, own = PATHS[name]
    p = params_for(N, **kw)
    mesh = card_mesh(dev, *MESH_PATHS[name]) if name in MESH_PATHS else None
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with HostPeak() as host:
            res = run_pipeline(p, outdir=out, device=dev, verbose=False,
                               mesh=mesh)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        files = set(os.listdir(out))
        pred = res["plan"]["device_bytes"]
        print(f"  {name} path {N}^3: {wall:.2f} s wall, {res['plan']['engine']}"
              f" engine, peak device memory {peak / GiB:.2f} GiB, planner "
              f"{pred / GiB:.2f} GiB ({res['plan']['ooc' if res['plan']['use_ooc'] else 'dense']['phase']}; "
              f"measured/predicted {peak / pred:.3f}); "
              + host.line(res["plan"]), flush=True)
        need(res["plan"]["use_ooc"] == (p.ooc == "on"),
             f"{name}: the planner chose the {res['plan']['engine']} engine")
        # the multibox merge's counts ride in its timings, as in JAX
        counts = ("frag_overhead", "frag_boundary_requested",
                  "frag_beyond_boundary")
        print("  phases: " + ", ".join(
            f"{k} {v:.3f}" + ("" if k in counts else " s")
            for k, v in sorted(res["timings"].items())), flush=True)
        halos = []
        for snap in res["frag"].catalogs:
            nh = int((snap.mass >= p.MinHaloMass).sum())
            halos.append(nh)
            print(f"  z={snap.z:g}: {nh} halos", flush=True)
            need(nh > 0, f"{name}: no halos at z={snap.z}")
            for kind in ("catalog", "mf"):
                fn = f"pinocchio.{snap.z:6.4f}.{p.RunFlag}.{kind}.out"
                need(fn in files, f"{name}: missing {fn}")
        if name == "classic" and N == 256:
            print(f"  halos per output {tuple(halos)}, recorded before the "
                  f"redesign of K1 and K6b {CLASSIC_HALOS} (need equal)",
                  flush=True)
            need(tuple(halos) == CLASSIC_HALOS, "classic: the halo counts "
                 "moved from those recorded")
        for fn in (f"pinocchio.{p.RunFlag}.FmaxPDF.out",
                   f"pinocchio.{p.RunFlag}.histories.out",
                   f"pinocchio.{p.RunFlag}.cosmology.out"):
            need(fn in files, f"{name}: missing {fn}")
        need(len(res["frag"].catalogs) == len(OUTPUT_Z),
             f"{name}: catalogs missing for some output redshifts")
        # HMF residual against the analytic fit (bench.py's formula)
        mf = np.loadtxt(os.path.join(
            out, f"pinocchio.{OUTPUT_Z[-1]:6.4f}.{p.RunFlag}.mf.out"))
        sel = mf[:, 4] > 100
        resid = float(np.abs(mf[sel, 1] / mf[sel, 5] - 1.0).mean())
        print(f"  HMF mean |n/n_fit - 1| over bins with > 100 halos: "
              f"{resid:.4f} ({int(sel.sum())} bins)", flush=True)
        sv = res["fmax"].smoothing.true_variance
        need(np.all(np.isfinite(sv)) and sv[-1] > 0,
             f"{name}: non-finite grid variance")
        if p.recompute_displacements:
            segs = res["fmax"].host_products.segments
            need(segs is not None and len(segs) == len(OUTPUT_Z),
                 f"{name}: one displacement set per output redshift "
                 "expected")
        if p.DumpProducts:
            restart_check(dev, p, out, res)
        if p.plc_enabled:
            plc_checks(p, res, out)
        if name == "classic":
            KEPT["classic"] = (res["fmax"].host_products,
                               sv.copy())
            KEPT["classic_run"] = (res["fmax"], res["frag"].catalogs,
                                   res["timings"])
        if name == "plc":
            KEPT["plc"] = (res["frag"].catalogs, len(res["frag"].plc.z),
                           res["timings"])
        if name == "scaledep":
            KEPT["scaledep"] = (res["fmax"].products.Fmax.cpu().numpy(),
                                sv.copy())
        if name == "ooc":
            KEPT["ooc"] = (res["fmax"].products.Fmax.cpu().numpy(), sv.copy(),
                           res["fmax"].host_products, res["frag"].catalogs)
        if p.subbox_tasks > 1:
            subbox_checks(dev, p, res, host)
        if mesh is not None and res["plan"]["use_ooc"]:
            KEPT["ooc_mesh_path"] = dict(wall_s=wall, peak_gib=peak / GiB,
                                         planner_gib=pred / GiB)
            ooc_mesh_checks(dev, p, res)
        elif mesh is not None:
            KEPT["mesh_peak"] = (peak, pred)
            mesh_checks(dev, p, res)
    print(f"  launches on the {name} path: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    expected = own
    missing = sorted(k for k in expected if launches[k] <= 0)
    stray = sorted(k for k, v in launches.items()
                   if v > 0 and k not in expected)
    need(not missing, f"kernels of the {name} path not launched: {missing}")
    need(not stray, f"kernels of other paths launched on the {name} path: "
         f"{stray}")
    return launches, res["timings"]


def held_to_single_device(what, N, F, sv, F_ref, sv_ref):
    """A mesh run's Fmax and grid variances against one device's: at most
    1e-3 N^3 cells with |dF| > 0.1 (the ellipsoid's near-degenerate cells
    flip when the FFT sums in another order), the variances within rtol
    1e-4 (a mean of shard means)."""
    import numpy as np
    nflip = int((np.abs(F - F_ref) > 0.1).sum())
    rv = float(np.abs(sv / sv_ref - 1.0).max())
    print(f"  {what}: {nflip} cells with |dF| > 0.1 against one device "
          f"(need <= {1e-3 * N ** 3:.0f}), max |dF| "
          f"{float(np.abs(F - F_ref).max()):.3e}, F equal on "
          f"{100 * float(np.mean(F == F_ref)):.4f}%; variances rel err "
          f"{rv:.2e} (need <= 1e-4)", flush=True)
    need(nflip <= 1e-3 * N ** 3 and rv <= 1e-4,
         f"{what}: Fmax or the variances differ from the single-device run")


def mesh_checks(dev, p, res):
    """The mesh path's run ``res`` against the classic path's (run first if
    this process has not): Fmax and the variances by held_to_single_device,
    halo counts per output within 0.5 %."""
    if "classic_run" not in KEPT:
        run_path(dev, "classic")
    ref, cats, _ = KEPT["classic_run"]
    F, _ = res["fmax"].products.gather()
    held_to_single_device("mesh", p.GridSize, F,
                          res["fmax"].smoothing.true_variance,
                          ref.products.Fmax.cpu().numpy(),
                          ref.smoothing.true_variance)
    for got, want in zip(res["frag"].catalogs, cats):
        ng = int((got.mass >= p.MinHaloMass).sum())
        nw = int((want.mass >= p.MinHaloMass).sum())
        print(f"  mesh z={got.z:g}: {ng} halos, classic path {nw} (need "
              "within 0.5 %)", flush=True)
        need(nw > 0 and abs(ng - nw) <= 0.005 * nw,
             f"mesh: halo count at z={got.z} differs from the classic path")
    g, w = res["frag"].catalogs[-1], cats[-1]
    have = dict(zip(w.name.tolist(), w.mass.tolist()))
    found = sum(1 for nm, ms in zip(g.name.tolist(), g.mass.tolist())
                if have.get(nm) == ms) / max(len(w.name), 1)
    print(f"  mesh: {100 * found:.2f} % of the classic path's z=0 halos "
          "identical in name and mass", flush=True)


def mesh_deltas(dev):
    """delta(k) over a slab 4, a pencil 2x2 and a volumes 2x2x2 mesh of the
    card (K1s) against the single-device field (K1): every shard equal to
    its window bit for bit, its padded planes zero."""
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid
    from pinocchio_tpu_torch.ic import generate_kdensity
    from pinocchio_tpu_torch.parallel import driver, pfft

    N = PIPELINE_N
    p = params_for(N)
    cosmo = Cosmology(p)
    grid = Grid(N, p.BoxSize_htrue)
    full = generate_kdensity(grid, cosmo, p.RandomSeed, dev)
    for kind, shape in (("slab", (4,)), ("pencil", (2, 2)),
                        ("volumes", (2, 2, 2))):
        decomp = pfft.make_decomp(card_mesh(dev, kind, shape), N)
        shards = driver.build_kdensity(decomp, grid, cosmo, p.RandomSeed)
        ok = True
        for i, sh in enumerate(shards):
            y0, ny, z0, nz = decomp.k_window(i)
            nzv = max(0, min(nz, N // 2 + 1 - z0))
            ok = ok and same_values(sh[..., :nzv],
                                    full[:, y0:y0 + ny, z0:z0 + nzv])
            ok = ok and bool(torch.all(sh[..., nzv:] == 0))
        print(f"  delta over {kind} {shape} ({len(shards)} shards, Nhp "
              f"{decomp.Nhp}): identical to the single-device delta: {ok}",
              flush=True)
        need(ok, f"delta over the {kind} mesh differs from one device's")
        del shards
    del full
    torch.cuda.empty_cache()


def mesh_fmax_phase(dev, name):
    """The fmax phase alone over the mesh MESH_FMAX[name] of the card at
    its grid size with the launch counts set to 0 just before it: its wall,
    device peak and launch set, held to the single-device run of the same
    switches by held_to_single_device: at PIPELINE_N the one kept by
    run_path (classic or scaledep; run first if this process has not), at
    another size a single-device fmax of its own.  Returns the launches."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.parallel.driver import run_fmax_distributed

    from pinocchio_tpu_torch.fmax import run_fmax

    kind, shape, kw, own, N = MESH_FMAX[name]
    p = params_for(N, **kw)
    cosmo = Cosmology(p)
    gm = scaledep_gm_for(p, cosmo)
    if N != PIPELINE_N:
        one = run_fmax(p, cosmo, dev, scaledep_gm=gm)
        F_ref = one.products.Fmax.cpu().numpy()
        sv_ref = one.smoothing.true_variance
        del one
    else:
        ref_name = "scaledep" if kw else "classic"
        if ref_name not in KEPT:
            run_path(dev, ref_name)
        F_ref, sv_ref = (KEPT["scaledep"] if kw else
                         (KEPT["classic_run"][0].products.Fmax.cpu().numpy(),
                          KEPT["classic"][1]))
    mesh = card_mesh(dev, kind, shape)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_fmax_distributed(p, cosmo, mesh, scaledep_gm=gm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: {kind} {shape} of the card, fmax {wall:.2f} s wall, "
          f"device peak {peak / GiB:.2f} GiB; phases: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items()),
          flush=True)
    F, _ = res.products.gather()
    held_to_single_device(name, N, F, res.smoothing.true_variance,
                          F_ref, sv_ref)
    sp = res.host_products
    nsets = len(sp.segments) if sp.segments else 1
    need(nsets == (len(OUTPUT_Z) if p.recompute_displacements else 1),
         f"{name}: {nsets} displacement sets")
    need(np.all(np.diff(sp.F[::997]) <= 0), f"{name}: products not in -F "
         "order")
    print(f"  launches: { {k: v for k, v in launches.items() if v} }",
          flush=True)
    missing = sorted(k for k in own if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in own)
    need(not missing and not stray, f"{name}: not launched {missing}, "
         f"launched from another path {stray}")
    KEPT.setdefault("mesh_fmax", {})[name] = dict(
        wall_s=wall, peak_gib=peak / GiB, timings=res.timings)
    del res, sp
    torch.cuda.empty_cache()
    return launches


def mesh_c2r_ulps(dev):
    """One radius's 6 Hessian components (R = 2 cells) taken to real space
    at 128^3 and PIPELINE_N three ways: one device's c2r (grids.irfft3: a
    2-D ifft over x and y, then the irfft over z), the same with the 2-D
    ifft as two 1-D iffts (the mesh's sequence), and the distributed c2r
    over a slab 4 and a volumes 2x2x2 mesh of the card; each pair's share
    of bit-equal cells, its largest difference in ulps (where the value is
    above 1e-3 of the maximum) and over the maximum.  Returns them."""
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid, irfft3, irfft_z
    from pinocchio_tpu_torch.ic import generate_kdensity
    from pinocchio_tpu_torch.ops import derivatives
    from pinocchio_tpu_torch.parallel import pfft

    def ulps(a, b):
        # ulps where |b| is above 1e-3 of its maximum (near zero a sign
        # change is billions of ulps), on the card
        d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
        big = b.abs() > 1e-3 * b.abs().max()
        return dict(equal=float((d == 0).double().mean()),
                    max_ulps=int(d[big].max()),
                    max_rel=float((a - b).abs().max() / b.abs().max()))

    out = {}
    for N in (128, PIPELINE_N):
        p = params_for(N)
        full = generate_kdensity(Grid(N, p.BoxSize_htrue), Cosmology(p),
                                 p.RandomSeed, dev)
        hk = derivatives.hessian_kspace(full, 2.0, N)
        del full
        one = irfft3(hk, N)
        seq = irfft_z(torch.fft.ifft(torch.fft.ifft(hk, dim=-3), dim=-2), N)
        res = {"one_vs_two_1d": ulps(one, seq)}
        for kind, shape in (("slab", (4,)), ("volumes", (2, 2, 2))):
            decomp = pfft.make_decomp(card_mesh(dev, kind, shape), N)
            real = torch.from_numpy(decomp.gather(decomp.inv(
                decomp.scatter(hk, kspace=True)))).to(dev)
            res[f"{kind}_vs_one"] = ulps(real, one)
            res[f"{kind}_vs_two_1d"] = ulps(real, seq)
            del real
        del hk, one, seq
        torch.cuda.empty_cache()
        print(f"  [{N}^3] c2r of 6 Hessian components, share of bit-equal "
              "cells and largest difference: " + "; ".join(
                  f"{k} {100 * v['equal']:.3f}% ({v['max_ulps']} ulps, "
                  f"{v['max_rel']:.1e} of the maximum)"
                  for k, v in res.items()), flush=True)
        out[N] = res
    return out


def mesh_transposes(dev):
    """The distributed c2r of one radius's 6 Hessian components at
    PIPELINE_N over a pencil 2x2 and a volumes 2x2x2 mesh of the card, beside
    one device's batched c2r of the same spectrum, and the transposes alone:
    on one card they are device-local copies (torch.cat of chunk views),
    not NVLink traffic.  Returns the times in ms."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid, irfft3
    from pinocchio_tpu_torch.ic import generate_kdensity
    from pinocchio_tpu_torch.ops import derivatives
    from pinocchio_tpu_torch.parallel import pfft

    N = PIPELINE_N
    p = params_for(N)
    full = generate_kdensity(Grid(N, p.BoxSize_htrue), Cosmology(p),
                             p.RandomSeed, dev)
    hk = derivatives.hessian_kspace(full, 0.0, N)
    out = dict(single_c2r_ms=time_ms(lambda: irfft3(hk, N)))
    print(f"  one device: batched c2r of the 6 components "
          f"{out['single_c2r_ms']:.3f} ms", flush=True)
    del hk
    for kind, shape in (("pencil", (2, 2)), ("volumes", (2, 2, 2))):
        decomp = pfft.make_decomp(card_mesh(dev, kind, shape), N)
        hs = decomp.map(lambda i, k: derivatives.hessian_kspace_shard(
            k, 0.0, N, *pfft._origin(decomp, i)),
            decomp.scatter(full, kspace=True))
        inv = time_ms(lambda: decomp.inv(hs))
        a2a = time_ms(lambda: pfft.all_to_all(hs, decomp.groups("a"), -3,
                                              -2))
        nbytes = sum(h.numel() * 8 for h in hs)
        key = f"{kind}_{'x'.join(map(str, shape))}"
        out[f"{key}_c2r_ms"] = inv
        out[f"{key}_a2a_ms"] = a2a
        print(f"  {kind} {shape} of the card: distributed c2r {inv:.3f} ms; "
              f"one all_to_all over 'a' of the 6 components "
              f"({nbytes / GiB:.3f} GiB) {a2a:.3f} ms, "
              f"{nbytes / a2a / 1e6:.0f} GB/s (a device-local copy)",
              flush=True)
        del hs
    del full
    torch.cuda.empty_cache()
    return out


def plc_checks(p, res, out):
    """The past light cone and the timeless snapshot of the run ``res``
    that wrote into ``out``: the files; crossings stored without overflow,
    their redshifts in the cone's range (+- 0.02, the crossing solve's
    tolerance) and their directions inside the aperture; n(z) beside the
    analytic prediction; every snapshot block N^3 entries long, FMAX and
    RMAX equal to the run's Fmax and Rmax, GRUP 0, 1 or a group's name."""
    import numpy as np
    from pinocchio_tpu_torch.io.snapshot import read_snapshot

    N = p.GridSize
    files = set(os.listdir(out))
    for kind in ("plc", "nz", "t_snapshot"):
        need(f"pinocchio.{p.RunFlag}.{kind}.out" in files,
             f"plc: missing pinocchio.{p.RunFlag}.{kind}.out")
    plc = res["frag"].plc
    n = len(plc.z)
    zlo = min(p.StartingzForPLC, p.LastzForPLC)
    zhi = max(p.StartingzForPLC, p.LastzForPLC)
    axis = np.asarray(p.PLCAxis, float) / np.linalg.norm(p.PLCAxis)
    rho = np.linalg.norm(plc.x, axis=1)
    ang = np.degrees(np.arccos(np.clip(plc.x @ axis / rho, -1.0, 1.0)))
    print(f"  PLC: {n} crossings, overflow {plc.overflow}, z in "
          f"[{plc.z.min():.4f}, {plc.z.max():.4f}] (need [{zlo - 0.02:g}, "
          f"{zhi + 0.02:g}]), largest angle from the axis {ang.max():.4f} "
          f"deg (need < {p.PLCAperture + 1e-3:g})", flush=True)
    need(n > 0 and not plc.overflow, "plc: no crossings, or the buffer "
         "overflowed")
    need(plc.z.min() >= zlo - 0.02 and plc.z.max() <= zhi + 0.02,
         "plc: crossing redshifts outside the cone's range")
    need(ang.max() < p.PLCAperture + 1e-3, "plc: crossings outside the "
         "aperture")
    nz = np.atleast_2d(np.loadtxt(os.path.join(
        out, f"pinocchio.{p.RunFlag}.nz.out")))
    for zl, zh, cnt, _, pred in nz:
        print(f"  n(z) [{zl:.3f}, {zh:.3f}]: {cnt:.0f} crossings, prediction "
              f"{pred:.0f}, ratio {cnt / pred:.4f}", flush=True)
    print(f"  n(z) total: {nz[:, 2].sum():.0f} crossings, prediction "
          f"{nz[:, 4].sum():.0f}, ratio {nz[:, 2].sum() / nz[:, 4].sum():.4f}",
          flush=True)
    _, blocks = read_snapshot(os.path.join(
        out, f"pinocchio.{p.RunFlag}.t_snapshot.out"))
    size = {"ID  ": 8, "RMAX": 4, "FMAX": 4, "VEL ": 12, "VEL2": 12,
            "VL31": 12, "VL32": 12, "ZACC": 4, "GRUP": 8}
    for label, b in size.items():
        need(len(blocks.get(label, b"")) == b * N ** 3,
             f"plc: snapshot block {label!r} does not hold {N}^3 entries")
    fm = res["fmax"].products
    F = np.frombuffer(blocks["FMAX"], np.float32)
    R = np.frombuffer(blocks["RMAX"], np.int32)
    same_F = np.array_equal(F, fm.Fmax.cpu().numpy().ravel())
    same_R = np.array_equal(R, fm.Rmax.cpu().numpy().ravel())
    grup = np.frombuffer(blocks["GRUP"], np.uint64)
    groups = res["frag"].groups
    names = np.concatenate([[0, 1]] + [
        g.name for g in (groups if isinstance(groups, list) else [groups])
    ]).astype(np.uint64)
    named = np.isin(grup, names)
    print(f"  snapshot: {len(size)} blocks of {N}^3, FMAX equal to the run's "
          f"Fmax: {same_F}, RMAX equal to its Rmax: {same_R}, GRUP a group "
          f"name (or 0, 1) on {100 * named.mean():.4f} % "
          f"({int((grup > 1).sum())} particles in named groups)", flush=True)
    need(same_F and same_R, "plc: snapshot FMAX or RMAX differ from the run")
    need(named.all(), "plc: snapshot GRUP holds values that name no group")


def same_halos(p, what, got, want):
    """The tolerance family of the JAX package's sub-box tests: halo counts
    per output within max(5, 0.5 %) of ``want``'s, no duplicate names, and
    over 97 % of want's final halos found in name and mass."""
    import numpy as np
    for g, w in zip(got, want):
        ng = int((g.mass >= p.MinHaloMass).sum())
        nw = int((w.mass >= p.MinHaloMass).sum())
        dup = len(g.name) - len(np.unique(g.name))
        print(f"  {what} z={g.z:g}: {ng} halos against {nw} (tolerance "
              f"max(5, 0.5 %)), {dup} duplicate names", flush=True)
        need(nw > 0 and abs(ng - nw) <= max(5, 0.005 * nw) and dup == 0,
             f"{what}: halo count at z={g.z} differs, or names repeat")
    g, w = got[-1], want[-1]
    have = dict(zip(g.name.tolist(), g.mass.tolist()))
    found = sum(1 for nm, ms in zip(w.name.tolist(), w.mass.tolist())
                if have.get(nm) == ms) / max(len(w.name), 1)
    print(f"  {what}: {100 * found:.2f} % of the z={w.z:g} halos found in "
          f"name and mass (need > 97 %)", flush=True)
    need(found > 0.97, f"{what}: final halos differ")


def subbox_checks(dev, p, res, host):
    """The subbox path's run ``res`` against the plc path's (run first if
    this process has not): the decomposition and its overhead, the sweep's
    wall beside the plc path's, the summed per-box sweep seconds, the host
    peak within 1.25 of the planner's, the catalogs by same_halos, the PLC
    crossings within 1 % of the plc path's with no overflow."""
    plan, t = res["plan"], res["timings"]
    nbox = plan["nbox"]
    print(f"  sub-boxes: {CORES} cores, nbox {nbox[0]} x {nbox[1]} x "
          f"{nbox[2]} ({'two' if plan['two_turn'] else 'single'}-turn, "
          f"{plan['subbox_workers']} swept at once), padded volume "
          f"{plan['boundary_overhead']:.4f} N^3, stored/total overhead "
          f"{t['frag_overhead']:.4f}", flush=True)
    need(math.prod(nbox) == p.subbox_tasks,
         "subbox: nbox does not give one sub-box per core")
    if "plc" not in KEPT:
        run_path(dev, "plc")
    cats, ncross, tp = KEPT["plc"]
    print(f"  subbox sweep: frag_wall {t['frag_wall']:.3f} s against the plc "
          f"path's one box {tp['frag_wall']:.3f} s "
          f"({tp['frag_wall'] / t['frag_wall']:.2f}x); per-box sweeps "
          f"{t['frag_sweep']:.3f} s summed (slowest box {t['frag_total']:.3f}"
          f" s), the one box's sweep {tp['frag_sweep']:.3f} s", flush=True)
    need(host.peak - host.base <= 1.25 * plan["host_bytes"],
         "subbox: the host peak exceeds the planner's by more than 25 %")
    same_halos(p, "subbox against plc", res["frag"].catalogs, cats)
    plc = res["frag"].plc
    rel = abs(len(plc.z) / ncross - 1.0)
    print(f"  subbox PLC: {len(plc.z)} crossings against the plc path's "
          f"{ncross} ({100 * rel:.3f} %, need <= 1 %), overflow "
          f"{plc.overflow}", flush=True)
    need(rel <= 0.01 and not plc.overflow, "subbox: the PLC crossings "
         "differ from the plc path's, or overflowed")


def subbox_turns(dev):
    """run_fragmentation_multibox on the classic path's products (the run
    kept by run_path; run first if this process has not) over one sub-box
    per core, single-turn then two-turn: each one's wall, quick-pass
    seconds, boundary particles requested and beyond-boundary count, held
    to the classic path's one-box catalogs by same_halos."""
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.subbox import (
        choose_nbox, run_fragmentation_multibox)
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass

    if "classic_run" not in KEPT:
        run_path(dev, "classic")
    fres, cats, t = KEPT["classic_run"]
    p = params_for(PIPELINE_N)
    cosmo = Cosmology(p)
    largest = largest_halo_mass(p, cosmo)
    nbox = choose_nbox(p, cosmo, largest, CORES)
    for two_turn in (False, True):
        what = f"{'two' if two_turn else 'single'}-turn"
        t0 = time.perf_counter()
        res = run_fragmentation_multibox(p, cosmo, fres, nbox,
                                         largest_mass=largest,
                                         two_turn=two_turn, verbose=False)
        wall = time.perf_counter() - t0
        r = res.timings
        print(f"  {what} over {nbox}: {wall:.3f} s wall against the one-box "
              f"frag_wall {t['frag_wall']:.3f} s; per-box sweeps "
              f"{r['sweep']:.3f} s summed, quick passes {r['quick']:.3f} s "
              f"summed; {int(r['boundary_requested'])} boundary particles "
              f"requested, {int(r['beyond_boundary'])} beyond the boundary "
              f"layer; stored/total overhead {r['overhead']:.4f}",
              flush=True)
        need(two_turn == (r["quick"] > 0.0),
             f"subbox_turns: {what}: the quick pass ran or did not")
        same_halos(p, f"{what} against one box", res.catalogs, cats)
        del res


def special_modes(dev):
    """run_special_mode at PIPELINE_N with the launch counts set to 0 just
    before each mode: 1 writes the CT table and launches no kernel; 2
    launches K1 alone and calls density_field once, its density has mean 0
    (to 1e-6 max|delta|) and the variance of the classic path's R=0 grid
    (to 1e-4); 3 has the classic launch set and its POS equals q + the sum
    of the classic path's rows at the needed cells (periodically, to 1e-5
    of the box).  Returns the mode-2 run's density_field calls."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import kernels, planner
    from pinocchio_tpu_torch.fmax import Smoothing
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.io.snapshot import read_snapshot
    from pinocchio_tpu_torch.ops import derivatives, tabulated
    from pinocchio_tpu_torch.run import run_special_mode

    if "classic" not in KEPT:
        run_path(dev, "classic")
    sp, true_variance = KEPT["classic"]
    N = PIPELINE_N
    p = params_for(N)
    calls = []
    real_density_field = derivatives.density_field

    def counted(*a, **k):
        calls.append(1)
        return real_density_field(*a, **k)

    with tempfile.TemporaryDirectory() as out:
        walls = {}
        for mode in (1, 2, 3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            derivatives.density_field = counted
            t0 = time.perf_counter()
            try:
                with HostPeak() as host:
                    path = run_special_mode(p, mode, out, device=dev,
                                            verbose=False)
            finally:
                derivatives.density_field = real_density_field
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            hline = ""
            if mode == 3:
                hline = ", " + host.line(planner.plan(p, dev,
                                                      dense_products=True))
            print(f"  mode {mode} {N}^3: {walls[mode]:.2f} s wall, "
                  f"{os.path.basename(path)} {os.path.getsize(path)} bytes, "
                  f"peak device memory "
                  f"{torch.cuda.max_memory_allocated() / GiB:.2f} GiB"
                  f"{hline}, launches {launched}", flush=True)
            if mode == 1:
                need(not launched, f"mode 1 launched kernels: {launched}")
                sm = Smoothing.build(p, Cosmology(p))
                tabs = tabulated.read_ct_table_file(path, p, sm)
                need(tabs.shape[0] == sm.n and np.all(np.isfinite(tabs))
                     and tabs.max() > 1.0, "mode 1: implausible CT table")
            elif mode == 2:
                need(launched == {"ic_kdensity": 1} and len(calls) == 1,
                     f"mode 2: launches {launched}, density_field called "
                     f"{len(calls)} times (need K1 once, one call)")
                dens = np.frombuffer(read_snapshot(path)[1]["DENS"],
                                     np.float32).astype(np.float64)
                need(dens.size == N ** 3, "mode 2: DENS is not N^3 long")
                mean, amax = dens.mean(), np.abs(dens).max()
                var = (dens * dens).mean()
                rel = abs(var / true_variance[-1] - 1.0)
                print(f"  mode 2: mean delta {mean:.3e} (need |.| <= "
                      f"{1e-6 * amax:.3e}), variance {var:.6f} against the "
                      f"classic path's R=0 grid variance "
                      f"{true_variance[-1]:.6f}, rel err {rel:.2e} (need <= "
                      "1e-4)", flush=True)
                need(abs(mean) <= 1e-6 * amax and rel <= 1e-4,
                     "mode 2: the density's mean or variance is off")
                del dens
            else:
                missing = sorted(k for k in CLASSIC if not launched.get(k))
                stray = sorted(k for k in launched if k not in CLASSIC)
                need(not missing and not stray, f"mode 3: not launched "
                     f"{missing}, launched from another path {stray}")
                pos = np.frombuffer(read_snapshot(path)[1]["POS "],
                                    np.float32).reshape(-1, 3)
                need(len(pos) == N ** 3, "mode 3: POS is not N^3 long")
                ci = sp.ci
                q = np.stack([ci // (N * N), (ci // N) % N, ci % N],
                             axis=1).astype(np.float64) + 0.5
                disp = sum(v.astype(np.float64) for v in sp.vel.values())
                unit = p.InterPartDist * p.Hubble100
                box = N * unit
                d = pos[ci].astype(np.float64) - np.mod(q + disp, N) * unit
                d -= box * np.round(d / box)
                err = np.abs(d).max()
                print(f"  mode 3: POS at the {len(ci)} needed cells against "
                      f"q + the classic path's rows: max periodic |d| "
                      f"{err:.3e} Mpc/h (need <= {1e-5 * box:.3e})",
                      flush=True)
                need(err <= 1e-5 * box, "mode 3: POS differs from the "
                     "classic path's displacements")
                del pos, d, disp, q
            os.remove(path)
    return len(calls), walls


def restart_check(dev, p, out, first):
    """A ReadProductsFromDumps run from the dump that the run ``first``
    wrote into ``out``: it must launch no kernel and give the same halo
    catalogs, name for name and mass for mass, at every output."""
    import dataclasses
    import numpy as np
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.run import run_pipeline

    q = dataclasses.replace(p, DumpProducts=False, ReadProductsFromDumps=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(q, outdir=out, device=dev, verbose=False,
                       write_outputs=False)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"  restart from the dump: {time.perf_counter() - t0:.2f} s wall, "
          f"launches {launched}", flush=True)
    need(not launched, f"the restart launched kernels: {launched}")
    need(len(res["frag"].catalogs) == len(first["frag"].catalogs),
         "the restart gave another number of catalogs")
    for a, b in zip(first["frag"].catalogs, res["frag"].catalogs):
        same = (a.z == b.z and np.array_equal(a.name, b.name)
                and np.array_equal(a.mass, b.mass))
        print(f"  restart z={b.z:g}: {len(b.name)} halos, identical in name "
              f"and mass to the dumping run: {same}", flush=True)
        need(same, f"the restart's catalog at z={b.z} differs")


def reference_check(dev, name):
    """A path at a small size on the card against the same run on the CPU,
    where every kernel is its plain PyTorch version (the versions the CPU
    tests hold to the JAX package).  The tolerance family of those tests:
    halo counts per output within max(5, 0.5 %), more than 97 % of the
    final halos identical in name and mass."""
    import torch
    from pinocchio_tpu_torch.run import run_pipeline

    N, over = REFERENCE[name]
    p = params_for(N, **dict(PATHS[name][1], **over))
    frags = []
    for d in (dev, torch.device("cpu")):
        mesh = (card_mesh(d, *MESH_PATHS[name]) if name in MESH_PATHS
                else None)
        with tempfile.TemporaryDirectory() as out:
            frags.append(run_pipeline(p, outdir=out, device=d, verbose=False,
                                      write_outputs=False, mesh=mesh)["frag"])
    card, host = [f.catalogs for f in frags]
    for g, c in zip(card, host):
        ng = int((g.mass >= p.MinHaloMass).sum())
        nc = int((c.mass >= p.MinHaloMass).sum())
        print(f"  [{name} {N}^3] z={g.z:g}: {ng} halos on the card, {nc} "
              f"on the CPU (tolerance max(5, 0.5 %))", flush=True)
        need(nc > 0 and abs(ng - nc) <= max(5, 0.005 * nc),
             f"{name}: halo count at z={g.z} differs from the CPU run")
    g, c = card[-1], host[-1]
    on_cpu = dict(zip(c.name.tolist(), c.mass.tolist()))
    same = sum(1 for nm, ms in zip(g.name.tolist(), g.mass.tolist())
               if on_cpu.get(nm) == ms) / max(len(c.name), 1)
    print(f"  [{name} {N}^3] final halos identical in name and mass: "
          f"{100 * same:.2f} % (need > 97 %)", flush=True)
    need(same > 0.97, f"{name}: final halos differ from the CPU run")
    if p.plc_enabled:
        g, c = frags[0].plc, frags[1].plc
        ng, nc = len(g.z), len(c.z)
        on_cpu = set(zip(c.name.tolist(), c.mass.tolist()))
        same = sum(1 for k in zip(g.name.tolist(), g.mass.tolist())
                   if k in on_cpu) / max(nc, 1)
        print(f"  [{name} {N}^3] PLC: {ng} crossings on the card, {nc} on "
              f"the CPU (tolerance max(5, 0.5 %)), {100 * same:.2f} % "
              "identical in name and mass (need > 97 %)", flush=True)
        need(nc > 0 and not g.overflow and not c.overflow
             and abs(ng - nc) <= max(5, 0.005 * nc) and same > 0.97,
             f"{name}: the PLC crossings differ from the CPU run")


def exchange_inputs(N, dev, nhosts, seed=0):
    """K15-K17's inputs on the (1, 1) shard of a 2x2 pencil layout at N^3:
    about 60 % of the shard's cells as its needed rows (sorted); with 2
    hosts the padded and turn-0 boxes of the main path's 8 sub-boxes
    (wrapped across the grid's edge), with more hosts random boxes, some
    wrapped, one wider than the grid, the last host none; 400 boundary
    spheres of radius 0 to 40 centred anywhere, so that some cross the
    shard's edge and the periodic wrap, and one of radius N/2; a 4-channel
    hand-off buffer (the classic path's v1, v2, v31, v32) in a random row
    order."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.subbox import (choose_nbox,
                                                     subbox_geometries)
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.parallel.exchange import (build_host_regions,
                                                       region_tables)
    h2 = N // 2
    ncell = h2 * h2 * N
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cells = torch.nonzero(torch.rand(ncell, generator=gen, device=dev)
                          < 0.6).reshape(-1)
    rng = np.random.default_rng(seed)
    if nhosts == HOSTS:
        p = params_for(N)
        cosmo = Cosmology(p)
        largest = largest_halo_mass(p, cosmo)
        geoms = subbox_geometries(p, cosmo, largest,
                                  choose_nbox(p, cosmo, largest, 8))
        pad = build_host_regions(geoms, nhosts, N)
        t0 = build_host_regions(geoms, nhosts, N, turn0=True)
    else:
        def boxes():
            out = [tuple(tuple((int(rng.integers(0, N)),
                                int(rng.integers(N // 8, N + N // 4)))
                               for _ in range(3))
                         for _ in range(rng.integers(1, 4)))
                   for _ in range(nhosts - 1)] + [()]
            out[0] += (((N - 5, N + 9), (0, N), (N - 3, 40)),)
            return tuple(out)
        pad, t0 = boxes(), boxes()
    sph = np.column_stack([rng.integers(0, N, (400, 3)),
                           rng.integers(0, 41, 400)]).astype(np.float32)
    sph[0] = (h2, h2, N - 2, h2)
    sph[1] = (N - 1, 0, 1, 30)
    n = cells.numel()
    nch = 4
    return dict(block=(h2, h2, h2, h2, 0, N), cells=cells,
                tables=(*region_tables(pad, dev), *region_tables(t0, dev)),
                nboxes=sum(len(h) for h in pad),
                spheres=torch.from_numpy(sph).to(dev),
                owner=torch.from_numpy(rng.integers(0, nhosts, len(sph))
                                       .astype(np.int32)).to(dev),
                buf=torch.randn(n * (2 + 3 * nch), generator=gen, device=dev),
                perm=torch.randperm(n, generator=gen, device=dev), nch=nch)


def exchange_kernel_phases(N, dev, report):
    """K15 (with boxes, and with request maps), K16 and K17 at N^3 on the
    (1, 1) shard of a 2x2 pencil layout against their plain versions:
    identical, for 2 hosts (the main path's boxes, timed) and 16 hosts (the
    edge cases); each host's rows dealt over 2 destinations, as host h of a
    2x2 mesh holds positions 2h and 2h + 1.  Fills report[N][name]."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch.ops import exchange as xops
    rec = report.setdefault(N, {})
    for nhosts in (HOSTS, 16):
        case = exchange_inputs(N, dev, nhosts)
        pb, po, tb, to = case["tables"]
        block, cells, n = case["block"], case["cells"], case["cells"].numel()
        timed = nhosts == HOSTS
        shard = f"{nhosts} hosts, shard (1, 1) [{N // 2}, {N // 2}, {N}], "

        def count(f, hmap=None):
            return f(cells, block, N, pb, po, nhosts, hmap=hmap)
        got, want = count(xops.count), count(xops.count_plain)
        need(all(torch.equal(g, w) for g, w in zip(got, want)),
             f"exchange_count at {N}^3 ({nhosts} hosts) differs")
        bits, counts = got
        members = int(counts.sum())
        W = xops.words(nhosts)
        if timed:
            record_phase(rec, N, "exchange_count", 0.0, 0.0,
                         time_ms(lambda: count(xops.count)),
                         time_ms(lambda: count(xops.count_plain), reps=2),
                         n * (8 + 4 * W) + 4 * counts.numel(),
                         n * case["nboxes"],
                         extra=f"identical, {shard}{members} memberships "
                         f"of {n} rows, ")
        paint_args = (case["spheres"], case["owner"], block, N, pb, po, tb,
                      to, nhosts)
        hmap = xops.paint(*paint_args)
        need(torch.equal(hmap, xops.paint_plain(*paint_args)),
             f"exchange_paint at {N}^3 ({nhosts} hosts) differs")
        need(all(torch.equal(g, w) for g, w in zip(
            count(xops.count, hmap), count(xops.count_plain, hmap))),
            f"exchange_count with request maps at {N}^3 differs")
        painted = int(hmap.sum())
        if timed:
            # the cells of each sphere that fall in the shard, each tested
            # once (the rest of the cube needs no box test)
            h2 = N // 2
            inside = cube = 0
            for cx, cy, cz, r in case["spheres"].tolist():
                s = int(r)
                if s <= 0:
                    continue
                off = np.arange(-s, s)
                ox, oy, oz = [off[((int(c) + off) % N - o >= 0)
                                  & ((int(c) + off) % N - o < e)]
                              for c, o, e in ((cx, h2, h2), (cy, h2, h2),
                                              (cz, 0, N))]
                cube += len(ox) * len(oy) * len(oz)
                rest = s * s - (ox[:, None] ** 2 + oy[None, :] ** 2)
                inside += int(np.searchsorted(np.sort(oz ** 2), rest,
                                              side="right").sum())
            record_phase(rec, N, "exchange_paint", 0.0, 0.0,
                         time_ms(lambda: xops.paint(*paint_args)),
                         time_ms(lambda: xops.paint_plain(*paint_args),
                                 reps=2),
                         hmap.numel() + case["spheres"].numel() * 4, inside,
                         extra=f"identical, {shard}"
                         f"{case['spheres'].shape[0]} spheres, {painted} "
                         f"cells painted of {inside} in the spheres "
                         f"({cube} in their cubes), ")
        tot = counts.sum(0, dtype=torch.int64).tolist()
        nd = 2
        seg_n = np.array([max(0, -(-(tot[h] - j) // nd))
                          for h in range(nhosts) for j in range(nd)],
                         np.int64)
        rowf = 2 + 3 * case["nch"]
        seg_base = np.concatenate([[0], np.cumsum(seg_n * rowf)[:-1]])
        args = (case["perm"], case["buf"], n, bits,
                torch.cumsum(counts, 0, dtype=torch.int64) - counts,
                torch.full((nhosts,), nd, dtype=torch.int32, device=dev),
                torch.tensor([[2 * h, 2 * h + 1] for h in range(nhosts)],
                             dtype=torch.int32, device=dev),
                torch.from_numpy(seg_base).to(dev),
                torch.from_numpy(seg_n).to(dev), case["nch"])
        size = int(seg_n.sum()) * rowf
        out_k = torch.zeros(size, device=dev)
        out_p = torch.zeros(size, device=dev)
        xops.pack(*args, out_k)
        xops.pack_plain(*args, out_p)
        need(torch.equal(out_k, out_p),
             f"exchange_pack at {N}^3 ({nhosts} hosts) differs")
        if timed:
            record_phase(rec, N, "exchange_pack", 0.0, 0.0,
                         time_ms(lambda: xops.pack(*args, out_k)),
                         time_ms(lambda: xops.pack_plain(*args, out_p)),
                         n * (8 + 4 * W + 4 * rowf) + 8 * counts.numel()
                         + 4 * rowf * members, members,
                         extra=f"identical, {shard}{members} rows of "
                         f"{4 * rowf} B packed, ")
        else:
            print(f"  [{N}^3] exchange_count, exchange_pack, exchange_paint:"
                  f" identical with {shard}{members} memberships, "
                  f"{painted} cells painted", flush=True)
        del case, got, want, bits, counts, hmap, args, out_k, out_p
        torch.cuda.empty_cache()


def hosts_products(dev):
    """The hosts phases' shared products: the classic fmax at PIPELINE_N
    over the 2x2 pencil mesh of the card with the hand-off deferred, the
    whole products, and the single-process multibox catalogs over one
    sub-box per core (single-turn, as run_pipeline chooses there) and
    two-turn; kept in KEPT."""
    import dataclasses
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.subbox import (
        choose_nbox, run_fragmentation_multibox)
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.parallel.driver import run_fmax_distributed
    from pinocchio_tpu_torch.parallel.multihost import fetch_local_sparse
    if "hosts" in KEPT:
        return KEPT["hosts"]
    p = params_for(PIPELINE_N, subbox_tasks=CORES)
    cosmo = Cosmology(p)
    largest = largest_halo_mass(p, cosmo)
    nbox = choose_nbox(p, cosmo, largest, max(CORES, HOSTS))
    t0 = time.perf_counter()
    fr = run_fmax_distributed(p, cosmo, card_mesh(dev, *HOSTS_MESH),
                              defer_handoff=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    whole = dataclasses.replace(fr, host_products=fetch_local_sparse(fr),
                                handoff=None)
    single = {tt: run_fragmentation_multibox(p, cosmo, whole, nbox,
                                             largest_mass=largest,
                                             two_turn=tt, verbose=False)
              for tt in (None, True)}
    print(f"  deferred mesh fmax {wall:.2f} s; {len(whole.host_products.ci)}"
          f" needed rows on {fr.handoff.decomp.p} shards; the one-process "
          f"multibox over {nbox}: single-turn "
          f"{single[None].timings['total']:.2f} s, two-turn "
          f"{single[True].timings['total']:.2f} s (slowest box)", flush=True)
    KEPT["hosts"] = dict(p=p, cosmo=cosmo, largest=largest, nbox=nbox, fr=fr,
                         whole=whole.host_products, single=single)
    return KEPT["hosts"]


def united(what, parts, want):
    """The union of the hosts' catalogs equals ``want`` exactly, names and
    masses at every output, with no name twice."""
    import numpy as np
    for iout, w in enumerate(want):
        names = np.concatenate([c[iout].name for c in parts])
        masses = np.concatenate([c[iout].mass for c in parts])
        o, ow = np.argsort(names, kind="stable"), np.argsort(w.name,
                                                             kind="stable")
        ok = (len(names) == len(np.unique(names)) == len(w.name) > 0
              and np.array_equal(names[o], w.name[ow])
              and np.array_equal(masses[o], w.mass[ow]))
        if iout == len(want) - 1 or not ok:
            print(f"  {what} z={w.z:g}: {len(names)} halos over the hosts, "
                  f"{len(w.name)} in one process; identical in name and "
                  f"mass: {ok}", flush=True)
        need(ok, f"{what}: the hosts' catalogs at z={w.z} differ from one "
             "process's")


def hosts_exchange(dev):
    """The exchange on the deferred 256^3 mesh products (hosts_products):
    single-turn and turn 0 for 2 and 4 hosts, each host's rows held to the
    brute-force selection from the gathered products (cells, F, v1 rows),
    with each exchange's count, pack, route and extract times, wire bytes
    and device peak; then the two-turn wire protocol for 2 hosts with the
    launch counts set to 0 just before: K15, K16 and K17 launched, the
    union of the hosts' catalogs equal to the one-process two-turn
    multibox; turn 0 ships fewer copies than single-turn.  Returns the
    two-turn run's launches."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.fragment.subbox import (
        run_fragmentation_multibox, subbox_geometries)
    from pinocchio_tpu_torch.parallel.exchange import (build_host_regions,
                                                       exchange_products)
    d = hosts_products(dev)
    p, fr, whole = d["p"], d["fr"], d["whole"]
    N = p.GridSize
    geoms = subbox_geometries(p, d["cosmo"], d["largest"], d["nbox"])
    F, _ = fr.products.gather()
    needed = F >= p.Flast
    row = np.empty(N ** 3, np.int64)
    row[whole.ci] = np.arange(len(whole.ci))
    coord = np.arange(N)
    copies = {}
    out = {}
    for nhosts in (HOSTS, 4):
        for turn in (None, 0):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            st = {}
            got = exchange_products(fr, geoms,
                                    nhosts, turn=turn, stats=st)
            peak = torch.cuda.max_memory_allocated() - base
            regions = build_host_regions(geoms, nhosts, N, turn0=turn == 0)
            ok = True
            for h in range(nhosts):
                m = np.zeros((N, N, N), bool)
                for (x0, lx), (y0, ly), (z0, lz) in regions[h]:
                    m |= (((coord - x0) % N < lx)[:, None, None]
                          & ((coord - y0) % N < ly)[None, :, None]
                          & ((coord - z0) % N < lz)[None, None, :])
                m &= needed
                sp = got[h]
                # the host's cells are the selection when they are as many
                # and all in it (the rows' own cells are distinct: the
                # sweep's order is strict)
                idx = row[sp.ci]
                ok = (ok and len(sp.ci) == int(m.sum())
                      and bool(m.ravel()[sp.ci].all())
                      and np.array_equal(sp.F, whole.F[idx])
                      and np.array_equal(sp.vel["v1"], whole.vel["v1"][idx])
                      and bool(np.all((np.diff(sp.F) < 0)
                                      | ((np.diff(sp.F) == 0)
                                         & (np.diff(sp.ci) > 0)))))
            lab = "single-turn" if turn is None else "turn 0"
            print(f"  exchange {lab}, {nhosts} hosts: {st['rows']} copies, "
                  f"{st['wire_bytes'] / 2 ** 20:.1f} MiB on the wire; count "
                  f"{1e3 * st['count']:.1f} ms, pack {1e3 * st['pack']:.1f} "
                  f"ms, route {1e3 * st['route']:.1f} ms, extract "
                  f"{1e3 * st['extract']:.1f} ms; device peak "
                  f"{peak / GiB:.3f} GiB above the products; each host's "
                  f"rows the brute-force selection: {ok}", flush=True)
            need(ok, f"exchange {lab} with {nhosts} hosts differs from the "
                 "brute-force selection")
            copies[(nhosts, turn)] = st["rows"]
            key = f"{'single' if turn is None else 'turn0'}_{nhosts}"
            out[key] = dict(st, peak_gib=peak / GiB)
            del got
    need(copies[(HOSTS, 0)] < copies[(HOSTS, None)],
         "turn 0 does not ship fewer copies than single-turn")
    kernels.reset_launches()
    t0 = time.perf_counter()
    parts = [run_fragmentation_multibox(p, d["cosmo"], fr, d["nbox"],
                                        largest_mass=d["largest"],
                                        two_turn=True,
                                        host_slice=(h, HOSTS), verbose=False)
             for h in range(HOSTS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    t = [r.timings for r in parts]
    print(f"  two-turn wire protocol, {HOSTS} hosts: {wall:.2f} s for both "
          f"hosts; turn 0 {[int(x['turn0_copies']) for x in t]} and turn 1 "
          f"{[int(x['turn1_copies']) for x in t]} copies per host against "
          f"{copies[(HOSTS, None)]} single-turn; transfer "
          f"{[round(x['transfer'], 3) for x in t]} s, quick passes "
          f"{[round(x['quick'], 3) for x in t]} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    need({k for k, v in launches.items() if v} == TWO_TURN_LAUNCH,
         "the two-turn exchange did not launch exactly K15, K16 and K17")
    need(sum(x["turn0_copies"] for x in t) < copies[(HOSTS, None)],
         "the two-turn wire carries no fewer turn-0 copies")
    united("two-turn hosts", [r.catalogs for r in parts],
           d["single"][True].catalogs)
    fr.handoff.release()
    out["two_turn"] = dict(wall_s=wall,
                           turn0=[x["turn0_copies"] for x in t],
                           turn1=[x["turn1_copies"] for x in t])
    KEPT["hosts_exchange"] = out
    return launches


def hosts_path(dev):
    """The hosts path: run_pipeline(mesh=2x2 pencil of the card,
    hosts=(h, 2)) for h = 0, 1 into one outdir, one sub-box per core, with
    the launch counts set to 0 just before and read just after (the mesh
    path's kernels and K15, K16); the chunks and no part file or staging
    directory; scripts/torch_merge_chunks.py; the union of the hosts'
    catalogs equal to the one-process multibox on the same mesh products
    (hosts_products) exactly, and the in-run mf.out to the one computed
    from those catalogs.  Returns the launches."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.io.catalogs import compute_mf
    from pinocchio_tpu_torch.run import run_pipeline
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_merge_chunks

    d = hosts_products(dev)
    p = d["p"]
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        walls, res = [], []
        for h in range(HOSTS):
            t0 = time.perf_counter()
            res.append(run_pipeline(p, outdir=out, device=dev, verbose=False,
                                    mesh=card_mesh(dev, *HOSTS_MESH),
                                    hosts=(h, HOSTS)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        files = sorted(os.listdir(out))
        for h, r in enumerate(res):
            t = r["timings"]
            print(f"  host {h}: {walls[h]:.2f} s wall; phases: " + ", ".join(
                f"{k} {v:.3f}" + ("" if k == "frag_overhead" else " s")
                for k, v in sorted(t.items())), flush=True)
        print(f"  device peak {peak / GiB:.2f} GiB; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        for z in OUTPUT_Z:
            for h in range(HOSTS):
                need(f"pinocchio.{z:6.4f}.{p.RunFlag}.catalog.out.{h}" in
                     files, f"hosts: no catalog chunk of host {h} at z={z}")
        need(not any(".part" in f or f.startswith(".host") for f in files),
             "hosts: a part file or staging directory is left")
        united("hosts", [r["frag"].catalogs for r in res],
               d["single"][None].catalogs)
        # byte-identical, or else: the columns of the bin counts (2-5)
        # equal, and those of the bin's mean mass (1, 6, 7), whose float64
        # sums run in another order over the hosts' parts, within rtol 1e-6
        nsame = 0
        with tempfile.TemporaryDirectory() as ref:
            for snap in d["single"][None].catalogs:
                name = f"pinocchio.{snap.z:6.4f}.{p.RunFlag}.mf.out"
                compute_mf(p, d["cosmo"], snap, ref, largest=d["largest"])
                with open(os.path.join(out, name), "rb") as fa, \
                        open(os.path.join(ref, name), "rb") as fb:
                    if fa.read() == fb.read():
                        nsame += 1
                        continue
                a = np.loadtxt(os.path.join(out, name))
                b = np.loadtxt(os.path.join(ref, name))
                counts = a.shape == b.shape and np.array_equal(a[:, 1:5],
                                                               b[:, 1:5])
                need(counts and np.allclose(a, b, rtol=1e-6, atol=0),
                     f"hosts: {name} differs from one process's beyond the "
                     "summation order of a bin's mean mass: counts equal "
                     f"{counts}")
                print(f"  in-run {name}: not byte-identical; counts equal, "
                      "mean masses within rtol 1e-6 (float64 summation "
                      "order)", flush=True)
        print(f"  in-run mf.out: {nsame} of {len(OUTPUT_Z)} byte-identical "
              "to one process's", flush=True)
        t0 = time.perf_counter()
        merged = torch_merge_chunks.merge(p, out)
        print(f"  merged {len(merged)} files in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        need(not any(".out." in f for f in os.listdir(out)),
             "hosts: chunks left after the merge")
    missing = sorted(k for k in HOSTS_LAUNCH if not launches[k])
    stray = sorted(k for k, v in launches.items()
                   if v and k not in HOSTS_LAUNCH)
    need(not missing and not stray, f"hosts: not launched {missing}, "
         f"launched from another path {stray}")
    KEPT["hosts_path"] = dict(walls=walls, peak_gib=peak / GiB)
    return launches


def hosts_reference_check(dev):
    """The hosts' fragmentation at REFERENCE["hosts"] on the card and on
    the CPU (the plain versions), each from one deferred fmax over a 2x2
    pencil mesh of its device: on each, the union of the two hosts'
    catalogs (the exchange, then each host's share of the sub-boxes)
    equals the one-process multibox on the same products exactly; between
    the devices, each host's catalogs by the reference tolerance.  (On the
    CPU two fmax runs may differ in the FFT's last bit, so each device's
    comparison shares one run.)"""
    import dataclasses
    import torch
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.subbox import (
        choose_nbox, run_fragmentation_multibox)
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.parallel.driver import run_fmax_distributed
    from pinocchio_tpu_torch.parallel.multihost import fetch_local_sparse
    N, over = REFERENCE["hosts"]
    p = params_for(N, **over)
    cosmo = Cosmology(p)
    largest = largest_halo_mass(p, cosmo)
    nbox = choose_nbox(p, cosmo, largest, p.subbox_tasks)
    per_dev = []
    for d in (dev, torch.device("cpu")):
        fr = run_fmax_distributed(p, cosmo, card_mesh(d, *HOSTS_MESH),
                                  defer_handoff=True)
        whole = dataclasses.replace(
            fr, host_products=fetch_local_sparse(fr), handoff=None)
        single = run_fragmentation_multibox(p, cosmo, whole, nbox,
                                            largest_mass=largest,
                                            verbose=False)
        parts = [run_fragmentation_multibox(p, cosmo, fr, nbox,
                                            largest_mass=largest,
                                            host_slice=(h, HOSTS),
                                            verbose=False)
                 for h in range(HOSTS)]
        fr.handoff.release()
        united(f"[hosts {N}^3 on {d.type}]", [r.catalogs for r in parts],
               single.catalogs)
        per_dev.append(parts)
    for h in range(HOSTS):
        same_halos(p, f"[hosts {N}^3] host {h} on the card against the CPU",
                   per_dev[0][h].catalogs, per_dev[1][h].catalogs)


# the overlapped hand-off (handoff): the watermark proof and the
# overlapped-against-blocking checks of the f(R) and out-of-core engines at
# HANDOFF_N; the per-chunk delay of the proof
HANDOFF_N = 128
HANDOFF_DELAY = 0.02
# the blocking hand-off at BIG_N measured with the code of commit d64c30c
# on an H100 80GB HBM3 at 700 W, s: one device, 4 shards (printed beside
# this run's)
HANDOFF_D64C30C = (9.98, 8.57)


def products_bytes(sp):
    """The bytes of a hand-off: cell indices (int32 on the wire) and F,
    then three float32 per row and table of every displacement set."""
    sets = sp.segments or [sp.vel]
    return 4 * len(sp.ci) * (2 + 3 * sum(len(v) for v in sets))


def same_products(what, a, b):
    """Two FmaxResults' cell indices, F, every row of every displacement
    set (float32 compared through an int32 view) and FmaxPDF counts, bit
    for bit; returns the hand-off's bytes."""
    import numpy as np
    sa, sb = a.host_products, b.host_products
    sets_a, sets_b = sa.segments or [sa.vel], sb.segments or [sb.vel]

    def bits(x):
        return np.ascontiguousarray(x, np.float32).view(np.int32)
    ok = (np.array_equal(sa.ci, sb.ci) and np.array_equal(bits(sa.F),
                                                           bits(sb.F))
          and len(sets_a) == len(sets_b)
          and np.array_equal(a.pdf_hist, b.pdf_hist)
          and all(sorted(x) == sorted(y)
                  and all(np.array_equal(bits(x[k]), bits(y[k])) for k in x)
                  for x, y in zip(sets_a, sets_b)))
    print(f"  {what}: {len(sa.ci)} needed cells, {len(sets_a)} displacement "
          f"set(s); overlapped and blocking products bit for bit: {ok}",
          flush=True)
    need(ok, f"{what}: the overlapped products differ from the blocking "
         "ones")
    return products_bytes(sa)


def same_catalogs(what, got, want):
    """Catalogs of the same products: counters, names and masses equal,
    positions within 1e-5."""
    import numpy as np
    ok = np.array_equal(got.counters, want.counters)
    for g, w in zip(got.catalogs, want.catalogs):
        og, ow = np.argsort(g.name), np.argsort(w.name)
        ok = (ok and len(w.name) > 0 and np.array_equal(g.name[og],
                                                         w.name[ow])
              and np.array_equal(g.mass[og], w.mass[ow])
              and np.allclose(g.x[og], w.x[ow], atol=1e-5))
    print(f"  {what}: catalogs at {len(got.catalogs)} outputs equal to the "
          f"blocking run's: {ok} ({[len(c.name) for c in got.catalogs]} "
          "groups)", flush=True)
    need(ok, f"{what}: the catalogs differ from the blocking run's")


def copy_overlap(run):
    """run() under torch.profiler with CPU and CUDA activities: returns
    (its result, a dict of the device time of the device-to-host copies
    into page-locked memory, ms, the part of it during which a kernel
    ran, ms, the copies' and the kernels' counts), or the dict None when
    the trace holds no such copy (then the caller has no overlap
    proof)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    copies, busy = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        # the hand-off's copies land in page-locked memory; the run's
        # small synchronous reads (the variances, the needed count) in
        # pageable memory
        if e.name.startswith("Memcpy DtoH (Device -> Pinned)"):
            copies.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            busy.append(span)
    if not copies:
        return out, None
    busy.sort()
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    import bisect
    starts = [m[0] for m in merged]
    total = over = 0.0
    for a, b in copies:
        total += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            over += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return out, dict(copy_ms=total / 1e3, overlap_ms=over / 1e3,
                     copies=len(copies), kernels=len(busy))


def handoff_timeline(what, t, nbytes, trace, stream=None):
    """One line of an overlapped hand-off's times from the end of the
    collapse cycle (FmaxResult.timings after the join) and its rates; with
    its _StreamState, when each table's host buffer was allocated and when
    its last row landed."""
    span = t["handoff_last"] - t.get("handoff_ci_F", t["handoff_return"])
    line = (f"  {what}: returned {t['handoff_return']:.4f} s after the "
            f"cycle"
            + (f", ci/F landed {t['handoff_ci_F']:.4f} s"
               if "handoff_ci_F" in t else "")
            + f", first chunk {t['handoff_first']:.4f} s, last chunk "
            f"{t['handoff_last']:.4f} s; {nbytes / 1e9:.3f} GB, "
            f"{nbytes / max(span, 1e-9) / 1e9:.2f} GB/s from the host's "
            "clock")
    if trace is not None:
        line += (f"; trace: {trace['copies']} copies into page-locked "
                 f"memory, {trace['copy_ms']:.3f} ms of device time, "
                 f"{nbytes / max(trace['copy_ms'], 1e-9) / 1e6:.2f} GB/s, "
                 f"{trace['overlap_ms']:.3f} ms of it beside one of "
                 f"{trace['kernels']} kernels")
    else:
        line += "; not traced (overlap not measured)"
    if stream is not None:
        line += ("\n    tables allocated / landed, s after the cycle: "
                 + ", ".join(f"{k}: {stream.allocated.get(k, 0.0):.3f} / "
                             f"{stream.landed.get(k, 0.0):.3f}"
                             for k in stream.keys))
    print(line, flush=True)


def handoff_phase(dev):
    """The overlapped hand-off against the blocking one (run_fmax and
    run_fmax_ooc with overlap True and False): the classic fmax at
    PIPELINE_N on one delta, bit for bit, with its timeline from the end
    of the collapse cycle and a torch.profiler trace of its copies; the
    watermark proof at HANDOFF_N (HANDOFF_DELAY seconds before each chunk
    lands, one box and 2x1x1 sub-boxes single- and two-turn: the catalogs
    of the blocking products, the sweeps waiting on the watermark, the
    run longer than the delay x N_CHUNKS / 2); f(R) with RECOMPUTE (4
    sets, traced: the copies of a set beside the next set's LPT kernels)
    and the out-of-core engine at HANDOFF_N, bit for bit, with equal
    catalogs; run_pipeline's outputs both ways (same_outputs)."""
    import torch
    from pinocchio_tpu_torch import fmax, fmax_ooc
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.driver import run_fragmentation
    from pinocchio_tpu_torch.fragment.subbox import (
        run_fragmentation_multibox)
    from pinocchio_tpu_torch.grids import Grid
    from pinocchio_tpu_torch.ic import generate_kdensity

    report = {}
    p = params_for(PIPELINE_N)
    cosmo = Cosmology(p)
    kd = generate_kdensity(Grid(PIPELINE_N, p.BoxSize_htrue), cosmo,
                           p.RandomSeed, dev)
    # a first run compiles the Triton kernel and plans the FFTs
    fmax.run_fmax(p, cosmo, dev, kdensity=kd, overlap=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocking = fmax.run_fmax(p, cosmo, dev, kdensity=kd, overlap=False)
    wall_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fmax.run_fmax(p, cosmo, dev, kdensity=kd)
    wall_r = time.perf_counter() - t0
    res.pending_fetch.join()
    nbytes = same_products(f"classic {PIPELINE_N}^3", res, blocking)
    tb = blocking.timings
    print(f"  blocking: fmax {wall_b:.3f} s; from the end of the cycle "
          f"{tb['lpt'] + tb['products']:.4f} s to its return (lpt "
          f"{tb['lpt']:.4f} s, sort + d2h + histogram {tb['products']:.4f}"
          f" s); overlapped: fmax {wall_r:.3f} s to its return", flush=True)
    del res, blocking
    res, trace = copy_overlap(lambda: fmax.run_fmax(p, cosmo, dev,
                                                    kdensity=kd))
    res.pending_fetch.join()
    handoff_timeline(f"overlapped classic {PIPELINE_N}^3 (traced)",
                     res.timings, nbytes, trace, res.pending_fetch.stream)
    report["classic"] = dict(timings=res.timings, bytes=nbytes, trace=trace,
                             blocking_s=tb["lpt"] + tb["products"])
    del res, kd

    q = params_for(HANDOFF_N)
    cosmo = Cosmology(q)
    base = fmax.run_fmax(q, cosmo, dev, overlap=False)
    for boxes in ("one box", "2x1x1 single-turn", "2x1x1 two-turn"):
        def frag(r):
            if boxes == "one box":
                return run_fragmentation(q, cosmo, r, verbose=False)
            return run_fragmentation_multibox(
                q, cosmo, r, (2, 1, 1), two_turn=boxes.endswith("two-turn"),
                verbose=False)
        want = frag(base)
        fmax._STREAM_TEST_DELAY = HANDOFF_DELAY
        try:
            t0 = time.perf_counter()
            r = fmax.run_fmax(q, cosmo, dev)
            got = frag(r)
            elapsed = time.perf_counter() - t0
            r.pending_fetch.join()
        finally:
            fmax._STREAM_TEST_DELAY = 0.0
        floor = HANDOFF_DELAY * fmax.N_CHUNKS / 2
        wait = got.timings["stream_wait"]
        print(f"  watermark, {boxes} at {HANDOFF_N}^3, {HANDOFF_DELAY} s a "
              f"chunk: fmax + fragmentation {elapsed:.3f} s (need > "
              f"{floor:.2f} s), the sweeps waited {wait:.3f} s on it (need "
              f"> 0), last row {r.timings['handoff_last']:.3f} s after the "
              f"cycle", flush=True)
        need(elapsed > floor and wait > 0.0,
             f"watermark, {boxes}: the stream did not gate the sweep")
        same_catalogs(f"watermark, {boxes}", got, want)
        report.setdefault("watermark", {})[boxes] = dict(
            elapsed_s=elapsed, stream_wait_s=wait)
        del r, got, want

    for name, kw in (("f(R) + RECOMPUTE", FR), ("out-of-core", dict(
            ooc="on"))):
        q = params_for(HANDOFF_N, **kw)
        cosmo = Cosmology(q)
        gm = scaledep_gm_for(q, cosmo)
        run = fmax_ooc.run_fmax_ooc if q.ooc == "on" else fmax.run_fmax
        blocking = run(q, cosmo, dev, scaledep_gm=gm, overlap=False)
        r = run(q, cosmo, dev, scaledep_gm=gm)
        got = run_fragmentation(q, cosmo, r, scaledep_gm=gm, verbose=False)
        (r.pending_fetch or r.ooc_pending).join()
        same_products(f"{name} {HANDOFF_N}^3, swept", r, blocking)
        del r

        def joined():
            r = run(q, cosmo, dev, scaledep_gm=gm)
            pending = r.pending_fetch or r.ooc_pending
            pending.join()
            return r, pending.stream
        (res, stream), trace = copy_overlap(joined)
        nbytes = same_products(f"{name} {HANDOFF_N}^3, traced", res,
                               blocking)
        handoff_timeline(f"overlapped {name} {HANDOFF_N}^3 (traced, "
                         "joined inside the trace)", res.timings, nbytes,
                         trace, stream)
        same_catalogs(f"{name} {HANDOFF_N}^3", got, run_fragmentation(
            q, cosmo, blocking, scaledep_gm=gm, verbose=False))
        report[name] = dict(timings=res.timings, bytes=nbytes, trace=trace)
        del res, blocking, got
    report["files"] = same_outputs(dev)
    torch.cuda.empty_cache()
    KEPT["handoff"] = report


def same_outputs(dev):
    """run_pipeline at HANDOFF_N with the past light cone (z 0.1 to 0) and
    a dump, overlap=False then True: every output file equal, byte for
    byte (a dump's npz array by array: the archive stamps its time);
    returns the count of files compared."""
    import numpy as np
    from pinocchio_tpu_torch.run import run_pipeline

    p = params_for(HANDOFF_N, DumpProducts=True, plc_enabled=True,
                   StartingzForPLC=0.1, LastzForPLC=0.0, PLCAperture=30.0,
                   PLCProvideConeData=True)
    files = []
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() \
            as b:
        for out, overlap in ((a, False), (b, True)):
            run_pipeline(p, outdir=out, device=dev, verbose=False,
                         overlap=overlap)
        for root, _, names in os.walk(a):
            for nm in names:
                rel = os.path.relpath(os.path.join(root, nm), a)
                fa, fb = os.path.join(a, rel), os.path.join(b, rel)
                if not os.path.exists(fb):
                    same = False
                elif nm.endswith(".npz"):
                    with np.load(fa) as x, np.load(fb) as y:
                        same = sorted(x.files) == sorted(y.files) and all(
                            np.array_equal(x[k], y[k]) for k in x.files)
                else:
                    with open(fa, "rb") as x, open(fb, "rb") as y:
                        same = x.read() == y.read()
                files.append((rel, same))
    bad = [rel for rel, same in files if not same]
    print(f"  run_pipeline at {HANDOFF_N}^3 with the PLC and a dump, "
          f"overlapped against blocking: {len(files)} files "
          f"{sorted(rel for rel, _ in files)}, differing: {bad}",
          flush=True)
    need(files and not bad, f"overlapped outputs differ: {bad}")
    return len(files)


def _phase_table(peaks, predicted):
    """Lines of each phase's measured peak beside the planner's (the
    out-of-core mesh's needed phase beside the larger of the planner's
    sort and hand-off)."""
    lines = []
    for ph, meas in peaks.items():
        qs = [q for q in (ph, "hand-off" if ph == "needed sort" else None)
              if q in predicted]
        pred = max(sum(predicted[q].values()) for q in qs) if qs else None
        lines.append(f"    {ph:<12s} measured {meas / GiB:8.3f} GiB, planner "
                     + ("-" if pred is None else
                        f"{pred / GiB:8.3f} GiB (measured/predicted "
                        f"{meas / pred:.3f})"))
    return "\n".join(lines)


# the engine's phases (fmax_ooc timings) -> the planner's
OOC_PHASES = {"ct_tables": "cycle", "fmax_loop": "cycle",
              "sources": "sources", "fold": "fold",
              "spectra": "fold", "products": "needed sort",
              "lpt_rows": "v-streams"}


def ooc_peaks(res):
    """The out-of-core run's per-phase peaks under the planner's names."""
    out = {}
    for ph, b in res.peaks.items():
        key = OOC_PHASES[ph]
        out[key] = max(out.get(key, 0), b)
    return out


def scaledep_gm_for(p, cosmo):
    """The per-radius effective growth of a scale-dependent run (host), as
    run_pipeline sets it up; None for scale-independent growth."""
    if not cosmo.scale_dep:
        return None
    from pinocchio_tpu_torch.fmax import Smoothing
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.scaledep import set_scaledep_gm
    return set_scaledep_gm(p, cosmo, Smoothing.build(p, cosmo),
                           largest_halo_mass(p, cosmo), verbose=False)


def ooc_dense_check(dev, name):
    """The out-of-core engine against the dense engine at the grid size
    and switches of OOC_CHECKS[name], the dense one fed the delta assembled
    from the engine's kz planes: Fmax equal on >= 99.99 % of cells,
    variances within rtol 1e-4, the same needed cells in the same order, the
    rows of every displacement set within float32 round-off (1e-5 of the
    field's maximum), halo counts equal at every output; each engine's peak
    memory beside the planner's."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax, fmax_ooc, planner
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.driver import run_fragmentation
    from pinocchio_tpu_torch.grids import Grid
    from pinocchio_tpu_torch.ic import PlaneGenerator
    from pinocchio_tpu_torch.plc import build_plc_geometry

    N, kw = OOC_CHECKS[name]
    p = params_for(N, **kw)
    cosmo = Cosmology(p)
    gm = scaledep_gm_for(p, cosmo)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kd = PlaneGenerator(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed,
                        dev).assemble()
    t0 = time.perf_counter()
    dense = fmax.run_fmax(p, cosmo, dev, kdensity=kd, scaledep_gm=gm)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    peak_dense = torch.cuda.max_memory_allocated()
    del kd
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ooc = fmax_ooc.run_fmax_ooc(p, cosmo, dev, scaledep_gm=gm,
                                trace_memory=True)
    ooc.ooc_pending.join()
    t_ooc = time.perf_counter() - t0
    frac = planner.collapsed_fraction(p, cosmo)
    pd = planner.device_peak(p, False, frac=frac)
    po = planner.device_peak(p, True, frac=frac)
    print(f"  dense fmax {t_dense:.2f} s, peak {peak_dense / GiB:.3f} GiB, "
          f"planner {pd['peak'] / GiB:.3f} GiB ({pd['phase']}; "
          f"measured/predicted {peak_dense / pd['peak']:.3f})", flush=True)
    peaks = ooc_peaks(ooc)
    print(f"  out-of-core fmax {t_ooc:.2f} s, peak "
          f"{max(peaks.values()) / GiB:.3f} GiB, planner "
          f"{po['peak'] / GiB:.3f} GiB ({po['phase']}):\n"
          + _phase_table(peaks, po["phases"]), flush=True)
    d = (ooc.products.Fmax - dense.products.Fmax).abs()
    exact = (d == 0).double().mean().item()
    rv = np.abs(ooc.smoothing.true_variance / dense.smoothing.true_variance
                - 1.0).max()
    print(f"  Fmax: equal on {100 * exact:.4f}% of cells (need >= 99.99%), "
          f"max |dF| {d.max().item():.2e}; variances rel err {rv:.2e} (need "
          f"<= 1e-4)", flush=True)
    need(exact >= 0.9999 and rv <= 1e-4,
         f"{name}: out-of-core Fmax disagrees with the dense engine")
    so, sd = ooc.host_products, dense.host_products
    same_order = np.array_equal(so.ci, sd.ci)
    print(f"  needed: {len(so.ci)} out-of-core, {len(sd.ci)} dense, the same "
          f"cells in the same order: {same_order}", flush=True)
    need(same_order, f"{name}: the needed cells or their order differ")
    sets_o = so.segments or [so.vel]
    sets_d = sd.segments or [sd.vel]
    need(len(sets_o) == len(sets_d), f"{name}: the number of displacement "
         "sets differs")
    for s, (vo, vd) in enumerate(zip(sets_o, sets_d)):
        errs = {k: float(np.abs(vo[k] - vd[k]).max()) for k in vd}
        tol = {k: 1e-5 * float(np.abs(vd[k]).max()) for k in vd}
        ok = all(errs[k] <= tol[k] for k in vd)
        print(f"  rows of set {s}: max |d| "
              + ", ".join(f"{k} {errs[k]:.2e} (tol {tol[k]:.2e})"
                          for k in vd) + f" -> {'ok' if ok else 'FAIL'}",
              flush=True)
        need(ok, f"{name}: out-of-core rows of set {s} disagree with the "
             "dense engine")
    geom = build_plc_geometry(p, cosmo, verbose=False)
    # the two sweeps run on two host threads at once (each sweep is one
    # native call on one core)
    with ThreadPoolExecutor(max_workers=2) as ex:
        fo, fd = ex.map(lambda r: run_fragmentation(
            p, cosmo, r, plc_geom=geom, scaledep_gm=gm, verbose=False),
            (ooc, dense))
    for a, b in zip(fd.catalogs, fo.catalogs):
        na = int((a.mass >= p.MinHaloMass).sum())
        nb = int((b.mass >= p.MinHaloMass).sum())
        print(f"  z={a.z:g}: {nb} halos out-of-core, {na} dense (need "
              "equal)", flush=True)
        need(na > 0 and na == nb,
             f"{name}: halo counts at z={a.z} differ between the engines")
    if geom.enabled:
        keys = ("name", "z", "mass", "x", "v", "nz")
        same = {k: np.array_equal(getattr(fo.plc, k), getattr(fd.plc, k))
                for k in keys}
        print(f"  PLC: {len(fo.plc.z)} crossings out-of-core, "
              f"{len(fd.plc.z)} dense, sweep {fo.timings['sweep']:.2f} / "
              f"{fd.timings['sweep']:.2f} s; arrays identical: {same}",
              flush=True)
        need(all(same.values()) and len(fd.plc.z) > 0
             and not (fo.plc.overflow or fd.plc.overflow),
             f"{name}: the PLC crossings differ between the engines")
    del ooc, dense, fo, fd, d
    torch.cuda.empty_cache()


def meminfo():
    """Host memory in bytes from /proc/meminfo: (MemTotal, MemAvailable)."""
    vals = {}
    with open("/proc/meminfo") as fd:
        for line in fd:
            k, v = line.split(":", 1)
            vals[k] = float(v.split()[0]) * 1024.0
    return vals.get("MemTotal", 0.0), vals.get("MemAvailable", 0.0)


def ooc_fmax_phase(dev, N, ooc, kw, own):
    """The out-of-core fmax phase at N^3 with the switches kw and the
    planner's choice under ``ooc`` ('auto' at 1024^3, where the planner must
    choose the out-of-core engine): each phase's peak beside the planner's,
    the overall peak under the card's memory, the host's memory beside the
    planner's host estimate, the launch set ``own``."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax_ooc, kernels, planner
    from pinocchio_tpu_torch.cosmology import Cosmology

    p = params_for(N, ooc=ooc, **kw)
    cosmo = Cosmology(p)
    t0 = time.perf_counter()
    gm = scaledep_gm_for(p, cosmo)
    t_gm = time.perf_counter() - t0
    rep = planner.plan(p, dev, cosmo)
    print(planner.format_memory_map(rep), flush=True)
    need(rep["use_ooc"], f"the planner chose the {rep['engine']} engine at "
         f"{N}^3 under ooc={ooc!r}")
    total, avail = meminfo()
    host_fmax = sum(rep["host"]["phases"]["fmax"].values())
    print(f"  host: MemTotal {total / GiB:.2f} GiB, MemAvailable "
          f"{avail / GiB:.2f} GiB; planner's estimate for the products "
          f"{host_fmax / GiB:.2f} GiB, for the sweep "
          f"{rep['host_bytes'] / GiB:.2f} GiB (not run here)", flush=True)
    need(host_fmax < avail, "the products would not fit the host's "
         "available memory")
    card = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with HostPeak() as host:
        res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, scaledep_gm=gm,
                                    verbose=N >= BIG_N, trace_memory=True)
        t_ret = time.perf_counter() - t0
        res.ooc_pending.join()
    wall = time.perf_counter() - t0
    peaks = ooc_peaks(res)
    peak = max(peaks.values())
    sp = res.host_products
    count = len(sp.ci)
    print(f"  overlapped: run_fmax_ooc returned after {t_ret:.2f} s "
          f"({res.timings['handoff_return']:.3f} s after the cycle), the "
          f"last row landed {res.timings['handoff_last']:.3f} s after the "
          f"cycle, joined after {wall:.2f} s; " + tables_line(res), flush=True)
    if N == BIG_N and not kw:
        # what the mesh phase at BIG_N is held to
        t0 = time.perf_counter()
        KEPT["big_classic"] = dict(
            count=count, digest=digest(sp.ci, sp.F), wall_s=wall,
            return_s=t_ret, peak_gib=peak / GiB,
            handoff_s=res.timings["handoff"],
            host_gib=(host.peak - host.base) / GiB, timings=res.timings)
        print(f"  (ci, F) digest {KEPT['big_classic']['digest'][:16]} in "
              f"{time.perf_counter() - t0:.2f} s; host peak "
              f"{(host.peak - host.base) / GiB:.2f} GiB above the start",
              flush=True)
    print(f"  {N}^3 out-of-core fmax: {wall:.2f} s wall"
          + (f" (set_scaledep_gm {t_gm:.2f} s before it)" if gm else "")
          + "; phases: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items()),
          flush=True)
    print(f"  peak device memory {peak / GiB:.3f} GiB of the card's "
          f"{card / GiB:.2f} GiB; planner {rep['device_bytes'] / GiB:.3f} "
          f"GiB:\n" + _phase_table(peaks, rep["ooc"]["phases"]), flush=True)
    print(f"  needed cells {count} of {N ** 3} "
          f"({100.0 * count / N ** 3:.2f}%, planner "
          f"{100.0 * rep['frac']:.2f}%); host after the run: MemAvailable "
          f"{meminfo()[1] / GiB:.2f} GiB", flush=True)
    print(f"  launches: { {k: v for k, v in kernels.LAUNCHES.items() if v} }",
          flush=True)
    need(peak < card, "the out-of-core peak exceeds the card's memory")
    need(0.3 < count / N ** 3 < 0.9, "implausible needed fraction")
    sv = res.smoothing.true_variance
    need(np.all(np.isfinite(sv)) and sv[-1] > 0, "non-finite grid variance")
    need(np.all(np.isfinite(sp.F[::997])) and all(
        np.all(np.isfinite(v[::997])) for v in sp.vel.values()),
        "non-finite products")
    need(np.all(np.diff(sp.F[::997]) <= 0), "products not in -F order")
    missing = sorted(k for k in own if not kernels.LAUNCHES[k])
    stray = sorted(k for k, v in kernels.LAUNCHES.items()
                   if v and k not in own)
    need(not missing and not stray, f"kernels at {N}^3: not launched "
         f"{missing}, launched from another path {stray}")
    del res, sp
    torch.cuda.empty_cache()
    if N == BIG_N and not kw:
        KEPT["big_classic"]["blocking"] = blocking_big(
            dev, p, cosmo, None, KEPT["big_classic"], HANDOFF_D64C30C[0])


def tables_line(res):
    """When each table's host buffer of an out-of-core run's joined
    streams was allocated and when its last row landed, s after the
    cycle."""
    st = res.ooc_pending.stream
    return "tables allocated / landed, s after the cycle: " + ", ".join(
        f"{k}: {st.allocated.get(k, 0.0):.3f} / {st.landed.get(k, 0.0):.3f}"
        for k in st.keys)


def blocking_big(dev, p, cosmo, mesh, over, earlier):
    """One blocking run (overlap=False) of the fmax phase at BIG_N beside
    the overlapped one ``over`` (its digest, times and host peak): the
    same needed cells and F, its wall, hand-off and host peak, and the
    blocking hand-off of commit d64c30c, ``earlier`` seconds."""
    import gc

    import torch
    from pinocchio_tpu_torch import fmax_ooc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with HostPeak() as host:
        res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, mesh=mesh, overlap=False)
    wall = time.perf_counter() - t0
    sp = res.host_products
    same = digest(sp.ci, sp.F) == over["digest"]
    grew = (host.peak - host.base) / GiB
    t = over["timings"]
    print("  blocking: phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in res.timings.items()), flush=True)
    print(f"  blocking: {wall:.2f} s to its return with every row landed "
          f"(hand-off {res.timings['handoff']:.3f} s, d64c30c's {earlier} s; "
          f"lpt_rows {res.timings['lpt_rows']:.3f} s), host peak "
          f"{grew:.2f} GiB above the start; overlapped: returned after "
          f"{over['return_s']:.2f} s, last row {t['handoff_last']:.3f} s "
          f"after the cycle, joined after {over['wall_s']:.2f} s, host "
          f"peak {over['host_gib']:.2f} GiB; the same (ci, F): {same}",
          flush=True)
    need(same, "the blocking run's needed cells or F differ from the "
         "overlapped run's")
    out = dict(wall_s=wall, handoff_s=res.timings["handoff"],
               lpt_rows_s=res.timings["lpt_rows"], host_gib=grew)
    del res, sp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def big_refusal(dev):
    """run_pipeline at BIG_N with f(R) growth and RECOMPUTE_DISPLACEMENTS
    under ooc='auto': the planner must refuse it on host memory (four sets
    of rows) with its map, before any device allocation."""
    import torch
    from pinocchio_tpu_torch import planner
    from pinocchio_tpu_torch.run import run_pipeline

    p = params_for(BIG_N, ooc="auto", **FR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as out:
        try:
            run_pipeline(p, outdir=out, device=dev, verbose=False)
        except planner.MemoryPlanError as err:
            msg = str(err)
        else:
            raise CheckFailed(f"the planner accepted {BIG_N}^3 f(R) growth "
                              "with RECOMPUTE")
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    print(msg, flush=True)
    print(f"  device memory allocated by the refused run: {grew} bytes",
          flush=True)
    need("host memory of the run" in msg and "device peak" not in msg,
         "the refusal is not on host memory alone")
    need(grew == 0, "the refused run allocated device memory")


def digest(*arrays):
    """SHA-256 of the arrays' bytes: 64 MiB pieces hashed on a thread pool
    (hashlib releases the interpreter lock), then their digests in
    order."""
    import hashlib

    import numpy as np
    size = 64 << 20
    pieces = []
    for a in arrays:
        b = memoryview(np.ascontiguousarray(a)).cast("B")
        pieces += [b[i:i + size] for i in range(0, len(b), size)]
    with ThreadPoolExecutor(max_workers=CORES) as ex:
        hs = list(ex.map(lambda m: hashlib.sha256(m).digest(), pieces))
    return hashlib.sha256(b"".join(hs)).hexdigest()


def ooc_held_to_one_device(what, got, want):
    """An out-of-core mesh run's Fmax, variances, needed cells, F and rows
    (got, want: (Fmax host array, variances, SparseProducts)) against the
    single-device engine's: bit for bit, or within the JAX package's own
    mesh tolerance (tests/test_ooc.py:395-423: |dF| > 0.01 on fewer than
    0.1 % of cells, median |dF| < 1e-4, variances within rtol 1e-4, the
    needed sets differing on at most max(4, 0.1 %) cells, the rows of the
    common cells within rtol = atol = 3e-3).  Returns whether every array
    was bit-equal."""
    import numpy as np
    (F, sv, sp), (F1, sv1, sp1) = got, want
    sets, sets1 = sp.segments or [sp.vel], sp1.segments or [sp1.vel]
    same = dict(Fmax=np.array_equal(F, F1), variances=np.array_equal(sv, sv1),
                cells=np.array_equal(sp.ci, sp1.ci),
                F=np.array_equal(sp.F, sp1.F),
                rows=len(sets) == len(sets1) and all(
                    np.array_equal(a[k], b[k])
                    for a, b in zip(sets, sets1) for k in b))
    exact = all(same.values())
    d = np.abs(F - F1)
    rv = float(np.abs(sv / sv1 - 1.0).max())
    nx = len(np.setxor1d(sp.ci, sp1.ci)) if not same["cells"] else 0
    print(f"  {what}: bit-equal to one device: {same}; Fmax equal on "
          f"{100 * float(np.mean(d == 0)):.4f}% of cells, max |dF| "
          f"{float(d.max()):.3e}, variances rel err {rv:.2e}, needed "
          f"{len(sp.ci)} / {len(sp1.ci)}, {nx} cells in one set only",
          flush=True)
    if exact:
        return True
    need((d > 0.01).mean() < 1e-3 and np.median(d) < 1e-4 and rv <= 1e-4
         and nx <= max(4, 1e-3 * len(sp1.ci)) and len(sets) == len(sets1),
         f"{what}: Fmax, variances or the needed set differ from one "
         "device beyond the JAX mesh tolerance")
    _, ia, ib = np.intersect1d(sp.ci, sp1.ci, return_indices=True)
    for s, (a, b) in enumerate(zip(sets, sets1)):
        for k in b:
            need(np.allclose(a[k][ia], b[k][ib], rtol=3e-3, atol=3e-3),
                 f"{what}: rows {k} of set {s} differ from one device")
    return False


def ooc_mesh_checks(dev, p, res):
    """The ooc_mesh path's run ``res`` against the ooc path's (run first if
    this process has not): the products by ooc_held_to_one_device; the
    catalogs identical when the products are, else the halo counts per
    output within the JAX package's tolerance max(10, 6 sqrt(n) + 5 %)."""
    import numpy as np
    if "ooc" not in KEPT:
        run_path(dev, "ooc")
    F1, sv1, sp1, cats = KEPT["ooc"]
    fr = res["fmax"]
    exact = ooc_held_to_one_device(
        "ooc_mesh", (fr.products.gather()[0], fr.smoothing.true_variance,
                     fr.host_products), (F1, sv1, sp1))
    for got, want in zip(res["frag"].catalogs, cats):
        ng = int((got.mass >= p.MinHaloMass).sum())
        nw = int((want.mass >= p.MinHaloMass).sum())
        same = all(np.array_equal(getattr(got, k), getattr(want, k))
                   for k in ("name", "mass", "q", "x", "v"))
        print(f"  ooc_mesh z={got.z:g}: {ng} halos, ooc path {nw}; "
              f"catalog identical: {same}", flush=True)
        need(nw > 0 and (same if exact else
                         abs(ng - nw) <= max(10, 6 * nw ** 0.5 + 0.05 * nw)),
             f"ooc_mesh: the catalog at z={got.z} differs from the ooc path")
    KEPT["ooc_mesh_path"]["bit_equal"] = exact


def ooc_mesh_fmax_phase(dev, name):
    """The out-of-core fmax phase alone at PIPELINE_N over the shards of
    OOC_MESH_FMAX[name] on the card, with the launch counts set to 0 just
    before it: its wall, phases and peaks beside the planner's per-device
    map, held to the single-device engine's run of the same switches (run
    once per model) by ooc_held_to_one_device, with its launch set and one
    displacement set per output under RECOMPUTE.  Returns the launches."""
    import torch
    from pinocchio_tpu_torch import fmax_ooc, kernels, planner
    from pinocchio_tpu_torch.cosmology import Cosmology

    shards, kw, own = OOC_MESH_FMAX[name]
    p = params_for(PIPELINE_N, ooc="on", **kw)
    cosmo = Cosmology(p)
    gm = scaledep_gm_for(p, cosmo)
    ones = KEPT.setdefault("ooc_one", {})
    model = name.rstrip("0123456789")
    if model not in ones:
        t0 = time.perf_counter()
        one = fmax_ooc.run_fmax_ooc(p, cosmo, dev, scaledep_gm=gm)
        one.ooc_pending.join()
        ones[model] = ((one.products.Fmax.cpu().numpy(),
                        one.smoothing.true_variance, one.host_products),
                       time.perf_counter() - t0, one.timings["handoff"])
        del one
    ref, wall1, handoff1 = ones[model]
    mesh = card_mesh(dev, "slab", (shards,))
    rep = planner.plan(p, dev, cosmo, shards=shards)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, scaledep_gm=gm, mesh=mesh,
                                trace_memory=True)
    res.ooc_pending.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peaks = ooc_peaks(res)
    print(f"  {name}: {shards} shards of the card, fmax {wall:.2f} s wall "
          f"(one device {wall1:.2f} s), hand-off {res.timings['handoff']:.3f}"
          f" s (one device {handoff1:.3f} s); phases: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items())
          + f"\n  peak {max(peaks.values()) / GiB:.3f} GiB, planner "
          f"{rep['ooc']['peak'] / GiB:.3f} GiB ({rep['ooc']['phase']}):\n"
          + _phase_table(peaks, rep["ooc"]["phases"]), flush=True)
    sp = res.host_products
    exact = ooc_held_to_one_device(
        name, (res.products.gather()[0], res.smoothing.true_variance, sp),
        ref)
    nsets = len(sp.segments) if sp.segments else 1
    need(nsets == (len(OUTPUT_Z) if p.recompute_displacements else 1),
         f"{name}: {nsets} displacement sets")
    print(f"  launches: { {k: v for k, v in launches.items() if v} }",
          flush=True)
    missing = sorted(k for k in own if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in own)
    need(not missing and not stray, f"{name}: not launched {missing}, "
         f"launched from another path {stray}")
    KEPT.setdefault("ooc_mesh_fmax", {})[name] = dict(
        wall_s=wall, one_device_wall_s=wall1, bit_equal=exact,
        peak_gib=max(peaks.values()) / GiB,
        planner_gib=rep["ooc"]["peak"] / GiB, timings=res.timings)
    del res, sp
    torch.cuda.empty_cache()
    return launches


def ooc_mesh_big(dev):
    """The fmax phase at BIG_N, classic, under ooc='auto' over OOC_MESH_BIG
    shards of the card: the planner's per-device map must choose the
    out-of-core engine; the needed count and a digest of (ci, F) equal the
    single-device run's (ooc_fmax_phase at BIG_N, run first if this process
    has not); each phase's time and peak beside the planner's, the
    hand-off's seconds beside the single device's and the host peak beside
    the planner's host estimate of the products; the launch set OOC."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax_ooc, kernels, planner
    from pinocchio_tpu_torch.cosmology import Cosmology

    if "big_classic" not in KEPT:
        ooc_fmax_phase(dev, BIG_N, "auto", {}, OOC)
    one = KEPT["big_classic"]
    p = params_for(BIG_N, ooc="auto")
    cosmo = Cosmology(p)
    rep = planner.plan(p, dev, cosmo, shards=OOC_MESH_BIG)
    print(planner.format_memory_map(rep), flush=True)
    need(rep["use_ooc"], f"the planner chose the {rep['engine']} engine at "
         f"{BIG_N}^3 over {OOC_MESH_BIG} shards")
    host_fmax = sum(rep["host"]["phases"]["fmax"].values())
    mesh = card_mesh(dev, "slab", (OOC_MESH_BIG,))
    card = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with HostPeak() as host:
        res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, mesh=mesh, verbose=True,
                                    trace_memory=True)
        t_ret = time.perf_counter() - t0
        res.ooc_pending.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peaks = ooc_peaks(res)
    peak = max(peaks.values())
    sp = res.host_products
    count = len(sp.ci)
    t0 = time.perf_counter()
    dig = digest(sp.ci, sp.F)
    t_dig = time.perf_counter() - t0
    grew = host.peak - host.base
    print(f"  {BIG_N}^3 out-of-core fmax over {OOC_MESH_BIG} shards: "
          f"{wall:.2f} s wall (one device {one['wall_s']:.2f} s); phases: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items()),
          flush=True)
    print(f"  peak device memory {peak / GiB:.3f} GiB of the card's "
          f"{card / GiB:.2f} GiB (one device {one['peak_gib']:.3f} GiB); "
          f"planner {rep['device_bytes'] / GiB:.3f} GiB:\n"
          + _phase_table(peaks, rep["ooc"]["phases"]), flush=True)
    print(f"  overlapped: returned after {t_ret:.2f} s, the last row "
          f"landed {res.timings['handoff_last']:.3f} s after the cycle (one "
          f"device {one['timings']['handoff_last']:.3f} s); "
          + tables_line(res), flush=True)
    print(f"  hand-off (merge on the card and d2h enqueued) "
          f"{res.timings['handoff']:.3f}"
          f" s, one device (d2h) {one['handoff_s']:.3f} s; host peak "
          f"{grew / GiB:.2f} GiB above the start (one device "
          f"{one['host_gib']:.2f} GiB), planner's products "
          f"{host_fmax / GiB:.2f} GiB", flush=True)
    print(f"  needed cells {count} (one device {one['count']}); (ci, F) "
          f"digest {dig[:16]} (one device {one['digest'][:16]}, {t_dig:.2f}"
          " s)", flush=True)
    print(f"  launches: { {k: v for k, v in launches.items() if v} }",
          flush=True)
    need(count == one["count"] and dig == one["digest"],
         f"the {BIG_N}^3 mesh's needed cells or their F differ from one "
         "device's")
    need(peak < card, "the out-of-core mesh's peak exceeds the card's memory")
    sv = res.smoothing.true_variance
    need(np.all(np.isfinite(sv)) and sv[-1] > 0, "non-finite grid variance")
    need(all(np.all(np.isfinite(v[::997])) for v in sp.vel.values()),
         "non-finite products")
    missing = sorted(k for k in OOC if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in OOC)
    need(not missing and not stray, f"kernels of the {BIG_N}^3 mesh: not "
         f"launched {missing}, launched from another path {stray}")
    KEPT["ooc_mesh_big"] = dict(
        wall_s=wall, return_s=t_ret, peak_gib=peak / GiB,
        planner_gib=rep["device_bytes"] / GiB,
        handoff_s=res.timings["handoff"], host_gib=grew / GiB,
        one_device=dict((k, v) for k, v in one.items() if k != "timings"),
        count=count, timings=res.timings, digest=dig)
    del res, sp
    torch.cuda.empty_cache()
    KEPT["ooc_mesh_big"]["blocking"] = blocking_big(
        dev, p, cosmo, mesh, KEPT["ooc_mesh_big"], HANDOFF_D64C30C[1])
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (kernels, "
                    "density_field, a path's name, mesh_fmax, "
                    "mesh_c2r, ooc_mesh_fmax or one of its names, "
                    "hosts_exchange, "
                    "hosts, modes, subbox_turns, reference:<path>, "
                    "ooc_dense:<name>, ooc_fmax, big, ooc_mesh_big, "
                    "refusal, handoff); no JSON line is printed")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))

    def wanted(phase):
        return only is None or phase in only

    if not os.path.isdir(os.path.join(HERE, "pinocchio_tpu_torch")):
        print("chip_smoke.py: pinocchio_tpu_torch not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    device_kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{device_kind}",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pinocchio_tpu_torch import kernels, native
    t0 = time.perf_counter()
    kernels.lib()
    print(f"kernels built with nvcc in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the host C libraries too, so that no path's timings hold their build
    t0 = time.perf_counter()
    for name in ("groupsweep", "fastio"):
        native.load(name)
    print(f"host C libraries built with cc in {time.perf_counter() - t0:.1f} "
          "s", flush=True)

    t_start = time.perf_counter()

    def section(title):
        print(f"{title} [{time.perf_counter() - t_start:.0f} s]", flush=True)

    try:
        report = {}
        if wanted("kernels"):
            section("compiled kernels and the cube root's proof:")
            report["compiled"] = compiled_report(dev)
        for N in KERNEL_SIZES:
            if wanted("kernels"):
                section(f"kernel phases at {N}^3:")
                kernel_phases(N, dev, report)
                shard_kernel_phases(N, dev, report)
            if wanted("kernels") or wanted("exchange_kernels"):
                exchange_kernel_phases(N, dev, report)
            if wanted("kernels") or wanted("density_field"):
                density_field_phase(N, dev, report)
        if wanted("kernels"):
            c2r_check(dev)
        paths = {}
        for path in PATHS:
            if wanted(path):
                section(f"{path} path at {PATHS[path][0]}^3:")
                paths[path] = run_path(dev, path)[0]
        if wanted("handoff"):
            section(f"the overlapped hand-off against the blocking one at "
                    f"{PIPELINE_N}^3 and {HANDOFF_N}^3:")
            handoff_phase(dev)
        mesh_report = {}
        if wanted("mesh_fmax"):
            section(f"delta over three meshes of the card at {PIPELINE_N}^3:")
            mesh_deltas(dev)
            for name, (mkind, mshape, _, _, mN) in MESH_FMAX.items():
                section(f"fmax over a {mkind} {mshape} mesh of the card at "
                        f"{mN}^3 ({name}):")
                paths[name] = mesh_fmax_phase(dev, name)
            section(f"the distributed c2r and its transposes at "
                    f"{PIPELINE_N}^3:")
            mesh_report = dict(transposes=mesh_transposes(dev),
                               fmax=KEPT["mesh_fmax"])
        if wanted("mesh_fmax") or wanted("mesh_c2r"):
            section("the distributed c2r against one device's, in ulps:")
            mesh_report["c2r_ulps"] = mesh_c2r_ulps(dev)
            if "mesh_peak" in KEPT:
                mesh_report["mesh_path_peak_gib"] = KEPT["mesh_peak"][0] / GiB
                mesh_report["mesh_path_planner_gib"] = (KEPT["mesh_peak"][1]
                                                        / GiB)
        for name in OOC_MESH_FMAX:
            if wanted("ooc_mesh_fmax") or wanted(name):
                section(f"out-of-core fmax over {OOC_MESH_FMAX[name][0]} "
                        f"shards of the card at {PIPELINE_N}^3 ({name}):")
                paths[name] = ooc_mesh_fmax_phase(dev, name)
        if wanted("hosts_exchange"):
            section(f"the exchange over a 2x2 pencil mesh of the card at "
                    f"{PIPELINE_N}^3, mocked hosts:")
            paths["hosts_exchange"] = hosts_exchange(dev)
        if wanted("hosts"):
            section(f"hosts path at {PIPELINE_N}^3: {HOSTS} mocked hosts "
                    f"over a 2x2 pencil mesh of the card, {CORES} sub-boxes:")
            paths["hosts"] = hosts_path(dev)
        if wanted("modes"):
            section(f"special modes 1, 2, 3 at {PIPELINE_N}^3:")
            density_calls, _ = special_modes(dev)
        if wanted("subbox_turns"):
            section(f"sub-box sweeps of the classic path's products at "
                    f"{PIPELINE_N}^3, {CORES} sub-boxes:")
            subbox_turns(dev)
        for path in REFERENCE:
            if wanted(f"reference:{path}"):
                section(f"{path} path at {REFERENCE[path][0]}^3 on the card "
                        "and on the CPU:")
                if path == "hosts":
                    hosts_reference_check(dev)
                else:
                    reference_check(dev, path)
        for name in OOC_CHECKS:
            if wanted(f"ooc_dense:{name}"):
                section(f"out-of-core against dense at "
                        f"{OOC_CHECKS[name][0]}^3, "
                        f"{name}:")
                ooc_dense_check(dev, name)
        if wanted("ooc_fmax"):
            section(f"out-of-core fmax phase at {OOC_N}^3, phase by phase:")
            ooc_fmax_phase(dev, OOC_N, "on", {}, OOC)
        if wanted("big"):
            for name, (bN, ooc, kw, own) in BIG.items():
                section(f"fmax phase at {bN}^3 under ooc={ooc!r}, {name}:")
                ooc_fmax_phase(dev, bN, ooc, kw, own)
        if wanted("ooc_mesh_big"):
            section(f"fmax phase at {BIG_N}^3 under ooc='auto' over "
                    f"{OOC_MESH_BIG} shards of the card, classic:")
            paths["ooc_mesh_big"] = ooc_mesh_big(dev)
        if wanted("refusal"):
            section(f"the planner at {BIG_N}^3 with f(R) growth and "
                    "RECOMPUTE:")
            big_refusal(dev)
        jaxish = sorted(m for m in sys.modules if m == "jax"
                        or m.startswith("jax.") or m == "pinocchio_tpu"
                        or m.startswith("pinocchio_tpu."))
        need(not jaxish, f"modules of jax or the JAX package imported: "
             f"{jaxish[:5]}")
        section("no module of jax or of the JAX package was imported; done")
    except CheckFailed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    if only is not None:
        return 0

    # each kernel's launches: on the first path (in PATHS order) that owns
    # it; the shared kernels on the main path
    rows = []
    owners = {nm: own for nm, (_, _, own) in PATHS.items()}
    owners.update({nm: v[3] for nm, v in MESH_FMAX.items()})
    owners.update(hosts=HOSTS_LAUNCH, hosts_exchange=TWO_TURN_LAUNCH)
    for kname, (route, source, replaces) in kernels.KERNELS.items():
        owner = next(nm for nm, own in owners.items() if kname in own)
        r = report[PIPELINE_N][kname]
        big = report[max(KERNEL_SIZES)][kname]
        rows.append(dict(name=kname, route=route, source=source,
                         replaces=replaces, launches=paths[owner][kname],
                         path=owner, max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"],
                         shape=f"{PIPELINE_N}^3",
                         ms_512=big["ms"], plain_ms_512=big["plain_ms"],
                         bound_ms_512=big["bound_ms"],
                         library_ms_512=big["library_ms"],
                         max_abs_err_512=big["max_abs_err"],
                         **{k: r[k] for k in ("pair_ms", "pair_plain_ms",
                                              "pair_bound_ms") if k in r}))
    # the library call of special mode 2 (no kernel of the port's own)
    dfs = {N: report[N]["density_field"] for N in KERNEL_SIZES}
    library = [dict(name="density_field", route="library (cuFFT)",
                    source="pinocchio_tpu_torch/ops/derivatives.py",
                    replaces="pinocchio_tpu/ops/derivatives.py:188",
                    calls=density_calls, path="mode 2",
                    ms=dfs[PIPELINE_N]["ms"],
                    bound_ms=dfs[PIPELINE_N]["bound_ms"],
                    bound_by="bytes",
                    library_ms=dfs[PIPELINE_N]["library_ms"],
                    ms_512=dfs[max(KERNEL_SIZES)]["ms"],
                    bound_ms_512=dfs[max(KERNEL_SIZES)]["bound_ms"],
                    library_ms_512=dfs[max(KERNEL_SIZES)]["library_ms"])]
    print(json.dumps({"kernels": rows, "library": library, "card": card,
                      "compiled": report.get("compiled"),
                      "mesh": mesh_report,
                      "ooc_mesh": dict(path=KEPT.get("ooc_mesh_path"),
                                       fmax=KEPT.get("ooc_mesh_fmax"),
                                       big=KEPT.get("ooc_mesh_big")),
                      "hosts": dict(path=KEPT.get("hosts_path"),
                                    exchange=KEPT.get("hosts_exchange")),
                      "handoff": dict(KEPT.get("handoff", {}),
                                      big=KEPT.get("big_classic", {}).get(
                                          "blocking"),
                                      big_mesh=KEPT.get(
                                          "ooc_mesh_big", {}).get(
                                          "blocking"))}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
