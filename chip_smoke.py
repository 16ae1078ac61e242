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
   K11 and K13 exactly; K1, K1s, K2, K2s, K5, K5s, K8, K8s, K9, K10 and
   K14 bit for bit, signed zeros included, K1 also with FixedIC and
   PairedIC, K1s also on a ragged window, K9 also on the batch that ends
   at Nh, K10's three modes in their forms on the first, a middle and the
   last kz batch; K6b also on adversarial F), and times the
   kernel, the plain
   version and, where one exists, the one PyTorch call that computes the
   same function (median of 5, CUDA events); each kernel's bound is the
   larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s
   (float32 outside the tensor cores); the shard kernels K1s, K2s, K5s and
   K8s on the (1, 1) shard of a 2x2 pencil mesh's k layout, and the
   exchange's K15, K16 and K17 on the (1, 1) shard of its real layout (2
   hosts with the main path's sub-box boxes, timed; 16 hosts with wrapped
   boxes, a host with none, spheres across edges), exactly; K14 and K17
   also as their first call, 20 calls back to back and the host's enqueue
   (K14 on the kz schedule's one-plane batch too, K17 with its plan's host
   time), K10 and K16 as one call, 20 back to back and the host's enqueue
   (the gradient and pair modes' rows form back to back; K16 beside its sector floor and a
   gather of its payload by perm alone);
   in the big phase, K10's and K14's calls by mode, form and planes with
   their device time estimated from the back-to-back times; times special
   mode 2's density_field (a library c2r) beside its bound and irfftn;
   holds the 16-bit storage kernels K18 (store) and K19 (load) bit for bit
   to their plain versions in bfloat16 and float16 at the shapes of the
   ooc_bf16 path at 256^3 and 512^3 and of big_bf16 at 1024^3 (a Hessian
   kz batch into a stack, the kz schedule's one-plane batch and a z-rfft
   slab into a spectrum; an x-slab of a stack and a spectrum's kz batch
   widened; at plane 33, over a 3-shard kz window and from its column),
   with their times one call and back to back beside copy_ and
   .to(float32), their bounds, the host's enqueue a call beside the
   library call's, and the stack layout's ceiling for the transposing
   forms: the larger of the bound and its 64-byte runs alone, stored or
   read a word a thread, beside K18's own runs alone (storage_kernels);
4. drives each path through run_pipeline (the rows stream to the host
   while the sweep starts on their watermark), with the launch counters
   reset just before it and read just after, and checks its outputs
   (catalogs and mass functions at 4 redshifts with halos, FmaxPDF,
   histories, the cosmology table), its own launch set (every kernel of the path launched,
   none of another path's) and the planner's predicted peak against the
   measured one:
     classic     the main path: classic ellipsoid, 256^3, 1 Mpc/h cells;
     tabulated   TABULATED_CT with the bicubic lookup, 128^3;
     scaledep    f(R) scale-dependent growth with RECOMPUTE_DISPLACEMENTS,
                 256^3;
     tabulated_trilinear, tabulated_bilinear   the other two lookups, 128^3;
     ooc         the out-of-core engine (ooc='on'), 256^3;
     ooc_bf16    the out-of-core engine with bfloat16 stacks and spectra
                 (K18, K19 with K9-K12), 256^3: its Fmax against the ooc
                 path's float32 run of the same delta (median |dF|, the
                 share above 0.01, F >= Flast changed), the needed count,
                 halo counts per output within max(10, 6 sqrt(n) + 5 %);
                 the fmax phase alone with each phase's peak beside the
                 planner's 16-bit map;
     ooc_tabulated   the out-of-core engine with the bicubic lookup, 128^3;
     ooc_tabulated_trilinear, ooc_tabulated_bilinear   the other two, 128^3;
     ooc_scaledep    the out-of-core engine with f(R) growth, RECOMPUTE
                 and DumpProducts, 128^3, then a ReadProductsFromDumps run
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
     camb        the CAMB-table configuration (FileWithInputSpectrum
                 CAMBTable: READ_PK_TABLE, SCALE_DEPENDENT and
                 RECOMPUTE_DISPLACEMENTS, with HubbleTableFile), 128^3, on
                 the file set scripts/torch_make_camb_inputs.py writes at
                 run time: K8 with four displacement sets;
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
   peaks beside the planner's per-device map (ooc_mesh_fmax); the fmax
   phase with float16 storage at 128^3 against float32 (ooc_f16) and with
   bfloat16 storage over 4 shards of the card at 256^3, bit for bit the
   ooc_bf16 path's (ooc_mesh_bf16); then the exchange
   (hosts_exchange) on one deferred fmax over a 2x2 pencil mesh of the card
   at 128^3: single-turn and turn 0 for 2 and 4 mocked hosts, each host's
   rows held to the brute-force selection, with the count, pack, route and
   extract times, wire bytes and device peak, and the two-turn wire
   protocol for 2 hosts (K15, K16, K17 launched; the spheres K17 paints
   counted by radius; the union of the hosts' catalogs equal to the
   one-process two-turn multibox); the hosts path:
   run_pipeline(hosts=(h, 2)) for h = 0, 1 over that mesh, one sub-box per
   core, into one outdir (the mesh kernels, K15 and K16 launched; the
   chunks, no part file; the union of the catalogs equal to the one-process
   multibox on the same products exactly; mf.out byte-identical, or equal
   in counts with the bins' mean masses within rtol 1e-6;
   scripts/torch_merge_chunks.py); then the hosts as two processes of
   the CLI (python -m pinocchio_tpu_torch.run --hosts 2 --shard-devices
   cuda:0,cuda:0, gloo through page-locked host buffers), all their runs
   in one launch of the two processes, each run with its own group (a
   fresh process spends seconds before it reaches the card): the
   ooc_procs phase, the out-of-core engine's hosts (--ooc on, with
   DumpProducts) at 256^3 over 4 shards, each process holding two shards'
   kz windows and x-blocks and landing the whole products, every file and
   the dump byte for byte those of run_pipeline(hosts=(h, 2)) over the
   same mesh in this process, each process's line (with the host peak
   beside the planner's estimate for the node, within 25 % either way,
   and the bytes and seconds of the x-slab gathers, spectrum pieces and
   hand-off) and launch set (K9-K12, K4, K6b and no other); the procs
   phase, the dense engine's hosts over the 2x2 pencil: at 128^3
   single-turn every chunk and in-run file byte for byte the hosts path's
   and the merge its merge; at 128^3 two-turn (the CLI's main with the
   memory-driven default forced to two-turn: K17 and the spheres across
   processes) every file byte for byte that of the mocked hosts in this
   process; each process's line (wall, phases, launches, device peak,
   bytes and seconds through the group) and launch set (the mesh path's
   kernels, K15, K16, and K17 when two-turn); ooc_procs_bf16: the fmax
   phase alone with bfloat16 storage in the same two processes over the
   same 4 shards, each process's products (Fmax, variances, FmaxPDF
   counts, needed cells, F, rows) bit for bit the ooc_mesh_bf16 phase's by
   SHA-256, K18 and K19 launched; no module of jax imported in either
   process; then the special
   modes at 256^3 through run_special_mode: 1 (the CT
   table, no kernel), 2 (the linear density: K1 and one c2r, its mean 0
   and its variance the classic path's R=0 grid variance), 3 (the LPT
   snapshot: the classic launch set, POS equal to q + the classic path's
   displacement rows at the needed cells); and the sub-box sweeps of the
   classic path's products, single-turn and two-turn (subbox_turns), each
   with its wall, quick-pass seconds, boundary particles requested and
   beyond-boundary count, held to the classic path's one-box catalogs;
   then the hand-off (handoff): the products read through the views
   before the join against a joined run's on the classic fmax at 256^3 on
   one delta, the cell indices, F, rows and FmaxPDF counts bit for bit,
   its timeline
   from the end of the collapse cycle (return, ci/F landed, first and last
   chunk, each table's host buffer allocated and landed), its rate on the
   host's clock and, from a torch.profiler trace, the copies' device time,
   rate and the part of it beside a kernel; the
   watermark proof at 128^3 (0.02 s before each chunk lands; one box and
   2x1x1 sub-boxes single- and two-turn: the catalogs of a run joined
   before its sweep, the sweeps waiting on the watermark, the run longer
   than 0.02 x 16 / 2 s); f(R) with RECOMPUTE (4 sets, traced) and the
   out-of-core engine at 128^3, bit for bit, with the joined run's
   catalogs; run_pipeline at 128^3 with the PLC and a dump written after
   the join, and a restart from the dump, every output file equal;
5. runs the classic path at 48^3, the tabulated and scaledep paths at 64^3
   and the plc path at 64^3 (z 0.1), also over 4 sub-boxes, the mesh path
   at 48^3, the hosts path at 48^3 (each device's hosts united equal to
   its one-process run) and the camb path at 48^3, on the card and on the
   CPU (the plain versions) and holds the halo catalogs and the PLC
   crossings to each other;
6. holds the out-of-core engine to the dense engine, the dense one fed the
   delta assembled from the engine's kz planes (Fmax, variances, the needed
   set and its order, the rows of every displacement set, halo counts,
   each engine's launch set), for the classic ellipsoid with the PLC at
   256^3 (the crossings must be identical), the bicubic lookup, f(R)
   growth with RECOMPUTE and the CAMB-table configuration (K14 on its
   growth tables) at 128^3, with each engine's peak memory beside the
   planner's;
7. runs the out-of-core fmax phase at 512^3 (ooc='on'; classic, and the
   bicubic lookup) and at 1024^3 under ooc='auto' (classic, f(R) growth),
   where the planner must choose the out-of-core engine; prints its map,
   each phase's measured peak beside the predicted one, the host's free
   memory beside the planner's host estimate, the needed count and the
   phase times, when run_fmax_ooc returned, when each table's host buffer
   was allocated and when its last row landed;
   at 1024^3 classic also a second run, joined at its return, with the
   same (ci, F), its wall and host peak; then the classic fmax phase
   at 1024^3 under ooc='auto'
   over 4 shards of the card (ooc_mesh_big): the planner's per-device map
   must choose the out-of-core engine, the needed count and a SHA-256 of
   (ci, F) must equal the single-device run's, each phase's time and peak
   beside the planner's, the hand-off's seconds, the last row's time and
   the host peak beside the single device's; and the planner's map of f(R)
   growth with
   RECOMPUTE at 1024^3, which must refuse the run on host memory before
   any allocation; the fmax phase at 1024^3 with bfloat16 storage
   (big_bf16): its peak within 5 % of the planner's, its wall and needed
   count beside the float32 run's, K18's and K19's calls by shape and
   their device time estimated from the storage phase's times; the planner's
   CLI (its main, in this process) on the card's memory (planner_cli); the
   classic path's catalogs and
   histories through scripts/torch_pinocchio2fits.py and
   scripts/torch_validate_fits.py (fits); the classic path's mass functions
   through scripts/torch_hmf_validation.py's validate_run (the residual of
   each output, z=0's beside the reference's 0.206) and its files through
   scripts/torch_plot_example.py (mf.png, lss.png) (scripts);
8. checks that neither jax nor any module of the JAX package was imported,
   and prints the script's seconds, the builds included;
9. prints one JSON line of the kernels (with the hand-off's timelines and
   traces under "handoff"), then {"ok": true, "device": ...} as the last
   line.  Any failed check exits non-zero before that.

    python3 chip_smoke.py --only subbox,subbox_turns,reference:subbox

runs only the named phases (kernels, density_field, a path's name,
mesh_fmax, mesh_c2r, ooc_mesh_fmax or one of its names, modes,
subbox_turns, reference:<path>, ooc_dense:<name>, ooc_fmax, big,
ooc_mesh_big, refusal, handoff, exchange_kernels, hosts_exchange, hosts,
procs, ooc_procs, ooc_procs_bf16, storage_kernels, ooc_f16, ooc_mesh_bf16,
big_bf16, planner_cli, fits, scripts) and prints no JSON line, e.g. the
CAMB-table configuration and the user scripts' twins:

    python3 chip_smoke.py --only camb,ooc_dense:camb,reference:camb,scripts
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
# a 12-step table search; K2/K5/K8/K10/K14: the mode's k, one exponential
# or table read, a complex product by a real or imaginary factor, four
# multiplies and two adds, per output), a cell (K3/K7/K11: the
# eigenvalues with acos and cos, the ellipsoid root, the growth fit, the
# running max; K4: the products of its expression) or a row (K6a, K12)
OPS = {"ic_kdensity": 380, "ic_kdensity_planes": 380, "kspace_hessian": 68,
       "kspace_gradient": 40, "kspace_gradient_tab": 60,
       "ooc_factors_hessian": 68, "ooc_factors_gradient": 40,
       "ooc_factors_pair": 36, "collapse_update": 400,
       "collapse_update_slab": 400, "collapse_update_table_trilinear": 330,
       "collapse_update_table_bilinear": 450,
       "collapse_update_table_bicubic": 900, "lpt_sources_pointwise": 35,
       "lpt_src32_accumulate": 18, "needed_rank": 0, "gather_rows": 0,
       "pdf_hist": 5,
       "vrows_slab": 1, "collapse_update_slab_table_trilinear": 330,
       "collapse_update_slab_table_bilinear": 450,
       "collapse_update_slab_table_bicubic": 900,
       "ooc_factors_gradient_tab": 60, "ic_kdensity_shard": 380,
       "kspace_hessian_shard": 68, "kspace_gradient_shard": 40,
       "kspace_gradient_tab_shard": 60, "exchange_count": 12,
       "exchange_pack": 4, "exchange_paint": 20, "storage_store": 0,
       "storage_load": 0}
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
# the CAMB-table configuration (FileWithInputSpectrum CAMBTable: READ_PK_TABLE,
# SCALE_DEPENDENT and RECOMPUTE_DISPLACEMENTS, with the Hubble table of
# READ_HUBBLE_TABLE) on the file set scripts/torch_make_camb_inputs.py
# writes at run time into this run's scratch directory (params_for adds the
# files' absolute paths; camb_files)
CAMB = dict(FileWithInputSpectrum="CAMBTable", MaxMemPerParticle=400)
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
# the dense engine's hosts phases (hosts_exchange, hosts, procs) run at
# 128^3 since the out-of-core hosts as processes (ooc_procs) joined at
# 256^3, to keep the whole run inside its time budget
HOSTS_N = 128
HOSTS_LAUNCH = MESH | {"exchange_count", "exchange_pack"}
TWO_TURN_LAUNCH = {"exchange_count", "exchange_pack", "exchange_paint"}
# the hosts as processes (procs): the two-turn run's grid, and the process
# group's timeout, s
PROCS_TWO_TURN_N = 128
PROCS_GROUP_TIMEOUT = 300


def ooc_tab(interp):
    """The out-of-core launch set with the lookup ``interp``."""
    return OOC_COMMON | {f"collapse_update_slab_table_{interp}",
                         "ooc_factors_gradient"}


# the out-of-core engine with 16-bit stacks and spectra: K18 and K19 beside
# the float32 engine's kernels; the grid of its float16 fmax phase and the
# 4 shards of the card of its mesh phase
STORAGE = {"storage_store", "storage_load"}
OOC16 = OOC | STORAGE
OOC_F16_N = 128
OOC_MESH16 = 4


OOC_N = 512
BIG_N = 1024
# out-of-core against dense: name -> (grid size, switches, the out-of-core
# run's launch set; the dense run's is its path's without K1, as it takes
# the engine's delta); the bicubic, f(R) and CAMB-table checks run at 128^3
# to keep the whole run inside its time budget (the ooc_mesh_fmax phases
# hold the first two models' out-of-core runs at 256^3)
OOC_CHECKS = {"classic": (256, PLC, OOC),
              "tabulated": (128, TAB, ooc_tab("bicubic")),
              "scaledep": (128, FR, OOC_FR), "camb": (128, CAMB, OOC_FR)}
# the big out-of-core fmax phases: name -> (grid size, ooc, switches,
# launch set); at BIG_N under ooc='auto', where the planner must choose the
# out-of-core engine; the bicubic lookup runs at OOC_N with ooc='on' (cut
# from BIG_N to keep the whole run inside its time budget: K13 is timed at
# 512^3 in the kernel phases)
BIG = {"classic": (BIG_N, "auto", {}, OOC),
       "tabulated": (OOC_N, "on", TAB, ooc_tab("bicubic")),
       "scaledep": (BIG_N, "auto", dict(FR, recompute_displacements=False),
                    OOC_FR)}
# name -> (grid size, Params switches, the path's launch set); the
# out-of-core bicubic path runs at 128^3 to keep the whole run inside its
# time budget (the ooc_mesh_fmax phases run its out-of-core fmax at 256^3,
# K13 is timed at 256^3 and 512^3 in the kernel phases)
PATHS = {
    "classic": (PIPELINE_N, {}, CLASSIC),
    "tabulated": (128, dict(ell_model="tabulated", ct_interp="bicubic"),
                  DENSE | {"collapse_update_table_bicubic",
                           "kspace_gradient"}),
    "scaledep": (PIPELINE_N, FR, DENSE | {"collapse_update",
                                          "kspace_gradient_tab"}),
    # the CAMB-table configuration: K8 with four RECOMPUTE sets
    "camb": (128, CAMB, DENSE | {"collapse_update", "kspace_gradient_tab"}),
    "tabulated_trilinear": (128, dict(ell_model="tabulated",
                                      ct_interp="trilinear"),
                            DENSE | {"collapse_update_table_trilinear",
                                     "kspace_gradient"}),
    "tabulated_bilinear": (128, dict(ell_model="tabulated",
                                     ct_interp="bilinear"),
                           DENSE | {"collapse_update_table_bilinear",
                                    "kspace_gradient"}),
    "ooc": (PIPELINE_N, dict(ooc="on"), OOC),
    "ooc_bf16": (PIPELINE_N, dict(ooc="on", ooc_dtype="bfloat16"), OOC16),
    "ooc_tabulated": (128, dict(TAB, ooc="on"), ooc_tab("bicubic")),
    "ooc_tabulated_trilinear": (128, dict(ooc="on", ell_model="tabulated",
                                          ct_interp="trilinear"),
                                ooc_tab("trilinear")),
    "ooc_tabulated_bilinear": (128, dict(ooc="on", ell_model="tabulated",
                                         ct_interp="bilinear"),
                               ooc_tab("bilinear")),
    # at 128^3 since the CAMB-table phases joined, to keep the whole run
    # inside its time budget: at 256^3 its two sweeps (the run and the
    # restart) took 58 s; the ooc_mesh_fmax phases run its out-of-core fmax
    # at 256^3 and K14 is timed at 256^3 and 512^3 in the kernel phases
    "ooc_scaledep": (128, dict(FR, ooc="on", DumpProducts=True),
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
             "mesh": (48, {}), "hosts": (48, dict(subbox_tasks=4)),
             "camb": (48, {})}
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
    if args.get("FileWithInputSpectrum") == "CAMBTable":
        args.update(camb_files())
        p = Params(**args)
        # CAMBTable implies READ_PK_TABLE, SCALE_DEPENDENT and
        # RECOMPUTE_DISPLACEMENTS, as a parameter file's reader sets them
        p.validate()
        return p
    return Params(**args)


def script_module(name):
    """The module of scripts/<name>.py, loaded from its file."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def camb_files():
    """The CAMB-table keys (absolute paths) of the file set that
    scripts/torch_make_camb_inputs.py writes, on this run's first call,
    into the scratch directory: 100 spectra uniform in 1/(1+z) to z 99, the
    redshifts and the Hubble table, from the default cosmology with no
    radiation (the paths' own)."""
    import contextlib
    import io
    if "camb_files" not in KEPT:
        d = scratch_dir("camb_inputs")
        pf = write_parameter_file(d, PIPELINE_N)
        out = os.path.join(d, "CAMBFiles")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = script_module("torch_make_camb_inputs").main(
                [pf, "--outdir", out, "--norad"])
        need(code == 0 and len(os.listdir(out)) == 102,
             f"the CAMB inputs were not written: {buf.getvalue()}")
        print(f"  scripts/torch_make_camb_inputs.py wrote "
              f"{len(os.listdir(out))} files in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        KEPT["camb_files"] = dict(
            CAMBMatterFile=os.path.join(out, "pk_cb"),
            CAMBRedshiftsFile=os.path.join(out, "redshifts.dat"),
            HubbleTableFile=os.path.join(out, "hubble.dat"))
    return KEPT["camb_files"]


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
            r"quad_kernelI\w*9Pointwise": "lpt pointwise",
            r"quad_kernelI\w*13AccumulateOne": "lpt one pair",
            r"quad_kernelI\w*10Accumulate": "lpt six pairs",
            r"count_kernelILb0ELi1E": "count box masks",
            r"count_kernelILb0ELi0E": "count box loop",
            r"count_kernelILb0ELi2E": "count maps",
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
    from pinocchio_tpu_torch.ops import collapse, compact, lpt
    from pinocchio_tpu_torch.ops import exchange as xops
    lib = kernels.library_path()
    ptx = _ptxas_report(kernels.ptxas_path(lib))
    sass = _sass_report(lib)
    runtime = dict(compact.kernel_info())
    runtime.update(ic.kernel_info())
    runtime.update(lpt.kernel_info())
    runtime.update(xops.kernel_info())
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


def k10_cases(derivatives, kz0, R, growth, N):
    """K10's three modes as (launch name, call(f, src0, src), kernel,
    plain): the Hessian and gradient modes on src, the pair mode (component
    xy) on (src0, src), each at the batch's first plane kz0."""
    return (("ooc_factors_hessian", lambda f, s0, s: f(s, kz0, R, N),
             derivatives.ooc_hessian, derivatives.ooc_hessian_plain),
            ("ooc_factors_gradient", lambda f, s0, s: f(s, kz0, growth, N),
             derivatives.ooc_gradient, derivatives.ooc_gradient_plain),
            ("ooc_factors_pair", lambda f, s0, s: f(s0, s, kz0, 0, 1, N),
             derivatives.ooc_pair, derivatives.ooc_pair_plain))


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

    # ---- K2: Hessian multiply (a mid radius and R=0), bit for bit its
    # plain version (an int32 view: signed zeros count) ----
    R_mid = float(np.float32(sm.radii[sm.n // 2] / grid.CellSize))
    for R in (R_mid, 0.0):
        got = derivatives.hessian_kspace(delta, R, N)
        ref = derivatives.hessian_kspace_plain(delta, R, N)
        err = (got - ref).abs().max().item()
        need(same_bits(got, ref), f"kspace_hessian at {N}^3, R={R}, is not "
             "bit for bit its plain version")
        if R == 0.0:
            def k2():
                return derivatives.hessian_kspace(delta, R, N)
            batch = batch_ms(k2)
            phase("kspace_hessian", err, 0.0, time_ms(k2),
                  time_ms(lambda: derivatives.hessian_kspace_plain(
                      delta, R, N)), 56 * modes, modes,
                  extra=f"bit for bit (and at R={R_mid:.4f}), R={R:g}, 20 "
                  f"calls back to back {batch:.4f} ms a call, ")
            rec["kspace_hessian"].update(batch_ms=batch)
        del got, ref

    # ---- K5: gradient multiply, bit for bit ----
    D1 = float(cosmo.GrowingMode(0.0))
    got = derivatives.gradient_kspace(delta, D1, N)
    ref = derivatives.gradient_kspace_plain(delta, D1, N)
    need(same_bits(got, ref), f"kspace_gradient at {N}^3 is not bit for bit "
         "its plain version")
    def k5():
        return derivatives.gradient_kspace(delta, D1, N)
    batch = batch_ms(k5)
    phase("kspace_gradient", (got - ref).abs().max().item(), 0.0, time_ms(k5),
          time_ms(lambda: derivatives.gradient_kspace_plain(delta, D1, N)),
          32 * modes, modes, extra=f"bit for bit, 20 calls back to back "
          f"{batch:.4f} ms a call, ")
    rec["kspace_gradient"].update(batch_ms=batch)
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
    # ---- K10: each mode bit for bit its plain version in every form and
    # source layout, on the first, a middle and the last batch of the kz
    # schedule (the last one plane, kz = N/2): gradient on a resident
    # spectrum's window (the kz-fastest form) and on a contiguous copy of
    # its planes (the rows form), Hessian on the planes (its one form), pair
    # on (planes, window) and (planes, planes); timed on the path's sources
    # (Hessian on K9's planes, gradient on the window, pair on (K9's
    # planes, the window): one call, 20 back to back, the host's enqueue),
    # the rows form of the other two back to back ----
    sched = fmax_ooc.kz_schedule(Nh, fmax_ooc.KZ_BATCH)
    for kz0, nb in (sched[0], sched[len(sched) // 2], sched[-1]):
        window = delta[:, :, kz0:kz0 + nb].permute(2, 0, 1)
        flat = window.contiguous()
        for name, call, kern, plain in k10_cases(derivatives, kz0, R_mid, D1,
                                                 N):
            for what, srcs in (("window", (flat, window)),
                               ("planes", (flat, flat))):
                if what == "window" and name.endswith("hessian"):
                    continue
                got, ref = call(kern, *srcs), call(plain, *srcs)
                need(same_bits(got, ref), f"{name} on the {what} "
                     f"[{nb}, {N}, {N}] at kz {kz0} at {N}^3 is not bit "
                     "for bit its plain version")
        del window, flat, got, ref
    spec = delta[:, :, 1:1 + B].permute(2, 0, 1)      # a strided batch
    forms_ms = KEPT.setdefault("factors", {}).setdefault(N, {})
    for name, call, kern, plain in k10_cases(derivatives, 1, R_mid, D1, N):
        srcs = (planes, planes if name.endswith("hessian") else spec)
        per_mode = {"ooc_factors_hessian": 56, "ooc_factors_gradient": 32,
                    "ooc_factors_pair": 32}[name]
        got, ref = call(kern, *srcs), call(plain, *srcs)
        need(same_bits(got, ref), f"{name} at {N}^3 is not bit for bit its "
             "plain version")

        def k10():
            return call(kern, *srcs)
        ms, batch, host = time_ms(k10), batch_ms(k10), host_ms(k10)
        mode = name[len("ooc_factors_"):]
        form = "rows" if mode == "hessian" else "kz"
        forms_ms[(mode, form)] = batch
        other = ""
        if mode != "hessian":
            forms_ms[(mode, "rows")] = other_ms = batch_ms(
                lambda: call(kern, planes, planes))
            other = f"the rows form back to back {other_ms:.4f} ms; "
        phase(name, (got - ref).abs().max().item(), 0.0, ms,
              time_ms(lambda: call(plain, *srcs)), per_mode * B * N * N,
              B * N * N, extra=f"bit for bit in its forms (first, middle "
              f"and last kz batch); [{B}, {N}, {N}] {form} form: 20 calls "
              f"back to back {batch:.4f} ms a call, the host's enqueue "
              f"{host:.4f} ms; {other}")
        rec[name].update(batch_ms=batch, host_ms=host)
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

    # K12: the needed rows of the first, a middle and the last x-slab of a
    # displacement-like stack, into the rows buffer of all needed cells;
    # then slab views off the 16-byte grid: rank and components one cell
    # past it (the head and tail cells beside the quads) and rank alone
    # (one cell a thread)
    rank = compact.needed_rank(idx, cells)
    n_slab = Bx * N * N
    nsl = N // Bx
    got = torch.zeros((count, 3), device=dev)
    want = torch.zeros((count, 3), device=dev)

    def slab(j):
        return (rank[j * n_slab:(j + 1) * n_slab],
                sd[:3, j * Bx:(j + 1) * Bx].reshape(3, -1).contiguous())

    for j in (0, nsl // 2, nsl - 1):
        compact.vrows_slab(*slab(j), got)
        compact.vrows_slab_plain(*slab(j), want)
        need(torch.equal(got, want), f"vrows_slab at {N}^3 on slab {j} of "
             f"{nsl} is not identical to its plain version")
    rk_off = rank[1:1 + n_slab]
    comps_off = misaligned(sd[:3].reshape(3, -1)[:, 1:1 + n_slab])
    for r_, c_ in ((rk_off, comps_off), (rk_off, slab(0)[1])):
        compact.vrows_slab(r_, c_, got)
        compact.vrows_slab_plain(r_, c_, want)
        need(torch.equal(got, want), f"vrows_slab at {N}^3 on a slab view "
             "off the 16-byte grid is not identical to its plain version")
    err = (got - want).abs().max().item()
    del rk_off, comps_off, want
    # timed on the path's share: the out-of-core path needs about two
    # thirds of the cells (0.66 N^3 rows of 12 B, past L2 from 256^3 on;
    # the state above needs fewer, whose rows L2 holds at 256^3), in the
    # sweep's order, which is random in the cells; both timed
    gen = torch.Generator(device=dev)
    gen.manual_seed(N)
    need_path = torch.randperm(cells, generator=gen,
                               device=dev)[:2 * cells // 3]
    rank_path = compact.needed_rank(need_path, cells)
    rows_path = torch.zeros((need_path.numel(), 3), device=dev)
    del need_path
    comps = slab(0)[1]
    times = {}
    for what, rk, rows in (("state", slab(0)[0], got),
                           ("path", rank_path[:n_slab], rows_path)):
        r64 = rk[rk >= 0].long()
        # the sector floor: each 32-byte sector that the slab's needed
        # rows touch read and written once, beside the slab's coalesced
        # 16 B a cell
        sectors = torch.unique(torch.cat([(12 * r64) // 32,
                                          (12 * r64 + 11) // 32])).numel()

        def k12():
            return compact.vrows_slab(rk, comps, rows)
        times[what] = dict(rows=r64.numel(), count=rows.shape[0],
                           sectors=sectors,
                           floor=1e3 * (64 * sectors + 16 * n_slab)
                           / PEAK_BYTES, ms=time_ms(k12), batch=batch_ms(k12),
                           host=host_ms(k12))
        del r64
    rk = rank_path[:n_slab]
    in_slab = times["path"]["rows"]

    def by_library():
        # no one PyTorch call scatters by a rank that skips cells: the
        # selection, its gather and index_copy_ together
        sel = rk >= 0
        rows_path.index_copy_(0, rk[sel].long(), comps[:, sel].T)

    lib_ms = time_ms(by_library)
    t = times["path"]
    ms, batch, host = t["ms"], t["batch"], t["host"]
    parts = [f"{w}: {t['rows']} rows of {t['count']} touching "
             f"{t['sectors']} sectors, sector floor {t['floor']:.4f} ms, one "
             f"call {t['ms']:.4f}, 20 back to back {t['batch']:.4f} ms a call "
             f"({t['batch'] / t['floor']:.2f}x the floor), host "
             f"{1e3 * t['host']:.1f} us" for w, t in times.items()]
    phase("vrows_slab", err, 0.0, ms,
          time_ms(lambda: compact.vrows_slab_plain(rk, comps, rows_path)),
          16 * n_slab + 12 * in_slab, n_slab,
          extra=f"identical on slabs 0, {nsl // 2}, {nsl - 1} and off the "
          f"16-byte grid; a [3, {Bx}, {N}, {N}] slab, timed on the path's "
          f"share (2/3 of the cells needed, random order) and on the "
          f"state's: {'; '.join(parts)}; the plain version and, as no one "
          f"library call scatters by a rank that skips cells, the mask, "
          f"gather and index_copy_ ({lib_ms:.3f} ms) on the path's; ")
    del rank_path, rows_path
    rec["vrows_slab"].update(batch_ms=batch, host_ms=host)
    del got, rank, rk, comps, sd_slab, idx, F0, R0

    k6a_path_phase(N, dev, rec, p, cosmo, grid, sm, delta)
    rec["gather_rows"].update({f"mid_{k}": v for k, v in mid.items()})

    # ---- K8: tabulated growth (an f(R) cosmology, so that the growth
    # varies with k) on delta ----
    cosmo_fr = Cosmology(params_for(N, **FR))
    gtabs, glo, gdx = fmax.growth_k_tables(cosmo_fr, 0.0, N, dev)
    got = derivatives.gradient_kspace_tab(delta, gtabs[0], glo, gdx, N)
    ref = derivatives.gradient_kspace_tab_plain(delta, gtabs[0], glo, gdx, N)
    need(same_bits(got, ref), f"kspace_gradient_tab at {N}^3 is not bit for "
         "bit its plain version")
    def k8():
        return derivatives.gradient_kspace_tab(delta, gtabs[0], glo, gdx, N)
    batch = batch_ms(k8)
    phase("kspace_gradient_tab", (got - ref).abs().max().item(), 0.0,
          time_ms(k8),
          time_ms(lambda: derivatives.gradient_kspace_tab_plain(
              delta, gtabs[0], glo, gdx, N)),
          32 * modes + 4 * gtabs[0].numel(), modes,
          extra=f"bit for bit, 20 calls back to back {batch:.4f} ms a call, ")
    rec["kspace_gradient_tab"].update(batch_ms=batch)

    # ---- K14: the same growth table on a [B, N, N] kz batch of delta, as a
    # contiguous copy of its planes (the contiguous form) and as a strided
    # view (a resident spectrum's batch: the kz-fastest form), and on the
    # one-plane batch kz = N/2 that ends the kz schedule, both ways, against
    # its plain version and K8's values; timed on the strided batch (its
    # first call, one call, 20 back to back, the host's enqueue) and on the
    # strided one-plane batch ----
    table = derivatives.GrowthTable(gtabs[0], glo, gdx)
    last = fmax_ooc.kz_schedule(Nh, fmax_ooc.KZ_BATCH)[-1]
    views = {}
    for kz0, nb in ((1, B), last):
        view = delta[:, :, kz0:kz0 + nb].permute(2, 0, 1)
        views[nb] = view
        k8 = got[..., kz0:kz0 + nb].permute(0, 3, 1, 2)
        for what, src in (("contiguous", view.contiguous()),
                          ("strided", view)):
            if nb == B and what == "strided":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                derivatives.ooc_gradient_tab(src, kz0, table, N)
                torch.cuda.synchronize()
                first = 1e3 * (time.perf_counter() - t0)
            g14 = derivatives.ooc_gradient_tab(src, kz0, table, N)
            ref = derivatives.ooc_gradient_tab_plain(src, kz0, table, N)
            need(same_bits(g14, ref) and same_bits(g14, k8.contiguous()),
                 f"ooc_factors_gradient_tab ({what}, [{nb}, {N}, {N}] at "
                 f"kz {kz0}) at {N}^3 is not bit for bit its plain version "
                 "and K8")

    def k14(nb=B):
        return derivatives.ooc_gradient_tab(views[nb], 1 if nb == B
                                            else last[0], table, N)
    ms, batch, host = time_ms(k14), batch_ms(k14), host_ms(k14)
    rows_src = views[B].contiguous()
    forms_ms = KEPT["factors"][N]
    forms_ms[("gradient_tab", "kz")] = batch
    forms_ms[("gradient_tab", "rows")] = batch_ms(
        lambda: derivatives.ooc_gradient_tab(rows_src, 1, table, N))
    one = dict(ms=time_ms(lambda: k14(last[1])),
               batch_ms=batch_ms(lambda: k14(last[1])),
               plain_ms=time_ms(lambda: derivatives.ooc_gradient_tab_plain(
                   views[last[1]], last[0], table, N)),
               bound_ms=bound("ooc_factors_gradient_tab",
                              32 * N * N + 4 * gtabs[0].numel(), N * N)[0])
    phase("ooc_factors_gradient_tab", 0.0, 0.0, ms,
          time_ms(lambda: derivatives.ooc_gradient_tab_plain(
              views[B], 1, table, N)),
          32 * B * N * N + 4 * gtabs[0].numel(), B * N * N,
          extra=f"bit for bit its plain version and K8, contiguous and "
          f"strided [{B}, {N}, {N}] and the last batch [1, {N}, {N}] at kz "
          f"{last[0]}; strided: first call {first:.3f} ms, 20 calls back to "
          f"back {batch:.4f} ms a call, the host's enqueue {host:.4f} ms; "
          f"one plane {one['ms']:.4f} ms, back to back "
          f"{one['batch_ms']:.4f}, plain {one['plain_ms']:.3f}, bound "
          f"{one['bound_ms']:.4f}; contiguous back to back "
          f"{forms_ms[('gradient_tab', 'rows')]:.4f} ms; ")
    rec["ooc_factors_gradient_tab"].update(first_ms=first, batch_ms=batch,
                                           host_ms=host, one_plane=one)
    del got, ref, g14, k8, views, rows_src

    # ---- K4: the sources and the six-pair accumulation on the R=0 stack,
    # the sources on an x-slab and one component pair on an x-slab of a
    # field (the out-of-core engine's sources and fold), each bit for bit
    # its plain version; one call, 20 back to back and the host's enqueue
    # of every form, torch.addcmul_ beside the pair ----
    sd = derivatives.second_derivatives(delta, 0.0, N)
    ref = lpt.sources_pointwise_plain(sd)
    phi2 = irfft3(derivatives.hessian_kspace(rfft3(ref[0]), 0.0, N), N)
    src32 = ref[2]
    n_slab = Bx * N * N
    sd_slab = sd[:, Bx:2 * Bx].contiguous()
    # the fold's pair: u = (sd, phi2) of one component on an x-slab, the
    # accumulator a slab view of the field (fmax_ooc: src32[o][x:x + Bx])
    u = torch.stack([sd[3, Bx:2 * Bx], phi2[3, Bx:2 * Bx]])
    w = (lpt.PHI2_WEIGHTS[3],)
    field = src32.clone()
    out = field[Bx:2 * Bx]
    forms = {}

    def k4_form(name, kernel, plain, check, nbytes, nelem, extra=None):
        """Time one form (kernel and plain version are callables), after
        check() held its bits; extra: (library call, its name)."""
        need(check(), f"K4 {name} at {N}^3 is not bit for bit its plain "
             "version")
        kname = ("lpt_sources_pointwise" if name.startswith("sources")
                 else "lpt_src32_accumulate")
        f = dict(ms=time_ms(kernel), batch_ms=batch_ms(kernel),
                 host_ms=host_ms(kernel), plain_ms=time_ms(plain),
                 bound_ms=bound(kname, nbytes, nelem)[0])
        lib = ""
        if extra is not None:
            f.update(library_ms=time_ms(extra[0]),
                     library_batch_ms=batch_ms(extra[0]))
            lib = (f", {extra[1]} {f['library_ms']:.4f} ms one call, "
                   f"{f['library_batch_ms']:.4f} back to back")
        print(f"  [{N}^3] K4 {name:<28s} bit for bit; one call "
              f"{f['ms']:.4f} ms, back to back {f['batch_ms']:.4f} "
              f"({f['batch_ms'] / f['bound_ms']:.2f}x the bound "
              f"{f['bound_ms']:.4f}), host {1e3 * f['host_ms']:.1f} us, "
              f"plain {f['plain_ms']:.4f}{lib}", flush=True)
        forms[name] = f
        return f

    def sources_equal(stack):
        return all(same_bits(g, r) for g, r in zip(
            lpt.sources_pointwise(stack), lpt.sources_pointwise_plain(stack)))
    dense = k4_form("sources [6, N, N, N]",
                    lambda: lpt.sources_pointwise(sd),
                    lambda: lpt.sources_pointwise_plain(sd),
                    lambda: sources_equal(sd), 36 * cells, cells)
    phase("lpt_sources_pointwise", 0.0, 0.0, dense["ms"], dense["plain_ms"],
          36 * cells, cells, extra="bit for bit (an int32 view), ")
    k4_form(f"sources [6, {Bx}, N, N] slab",
            lambda: lpt.sources_pointwise(sd_slab),
            lambda: lpt.sources_pointwise_plain(sd_slab),
            lambda: sources_equal(sd_slab), 36 * n_slab, n_slab)
    want = lpt.src32_accumulate_plain(phi2, sd, src32)
    scratch = src32.clone()
    six = k4_form("six pairs [6, N, N, N]",
                  lambda: lpt.src32_accumulate(phi2, sd, scratch),
                  lambda: lpt.src32_accumulate_plain(phi2, sd, src32),
                  lambda: same_bits(lpt.src32_accumulate(
                      phi2, sd, src32.clone()), want), 56 * cells, cells)
    phase("lpt_src32_accumulate", 0.0, 0.0, six["ms"], six["plain_ms"],
          56 * cells, cells, extra="bit for bit (an int32 view), ")
    p1, s1 = u[1:2], u[0:1]
    want = lpt.src32_accumulate_plain(p1, s1, out, w)
    value = -2.0 * w[0]

    def pair_check():
        # in place on the card; the plain version (a CPU rehearsal) is not
        got = lpt.src32_accumulate(p1, s1, out, weights=w)
        return same_bits(got, want) and (got is out or not out.is_cuda)
    # one pair: 16 B and 3 of the six-pair pass's 18 operations per cell
    pair = k4_form(f"one pair on a [{Bx}, N, N] slab",
                   lambda: lpt.src32_accumulate(p1, s1, out, weights=w),
                   lambda: lpt.src32_accumulate_plain(p1, s1, out, w),
                   pair_check, 16 * n_slab, n_slab / 6,
                   extra=(lambda: out.addcmul_(u[1], u[0], value=value),
                          "torch.addcmul_"))
    rec["lpt_sources_pointwise"].update(
        batch_ms=dense["batch_ms"], host_ms=dense["host_ms"],
        forms={k: v for k, v in forms.items() if k.startswith("sources")})
    rec["lpt_src32_accumulate"].update(
        batch_ms=six["batch_ms"], host_ms=six["host_ms"],
        pair_ms=pair["ms"], pair_plain_ms=pair["plain_ms"],
        pair_bound_ms=pair["bound_ms"],
        forms={k: v for k, v in forms.items()
               if not k.startswith("sources")})
    del sd, phi2, src32, want, scratch, delta, u, p1, s1, field, out, sd_slab
    del ref
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
    # K8s as the mesh path calls it: one GrowthTable for the shards of a
    # device (its scalars made on the first launch)
    table = derivatives.GrowthTable(gtabs[0], glo, gdx)
    D1 = float(cosmo.GrowingMode(0.0))
    ragged = ic.kdensity_shard(*odd)
    cases = (
        ("kspace_hessian_shard", derivatives.hessian_kspace_shard,
         derivatives.hessian_kspace_shard_plain, (R_mid,), (R_mid,), 56,
         False),
        ("kspace_hessian_shard", derivatives.hessian_kspace_shard,
         derivatives.hessian_kspace_shard_plain, (0.0,), (0.0,), 56, True),
        ("kspace_gradient_shard", derivatives.gradient_kspace_shard,
         derivatives.gradient_kspace_shard_plain, (D1,), (D1,), 32, True),
        ("kspace_gradient_tab_shard", derivatives.gradient_kspace_tab_shard,
         derivatives.gradient_kspace_tab_shard_plain, (table, glo, gdx),
         (gtabs[0], glo, gdx), 32, True))
    for name, kern, plain, extra, plain_extra, per_mode, timed in cases:
        def call(f, src=shard, at=(y0, z0), args=extra):
            return f(src, *args, N, *at)
        got, ref = call(kern), call(plain, args=plain_extra)
        need(same_bits(got, ref), f"{name} at {N}^3 {plain_extra[:1]} is "
             "not bit for bit its plain version")
        # the ragged window (odd y0 and ny, reaching into the padded
        # planes) and the table handed over as a tensor
        got = call(kern, ragged, (odd[9], odd[11]), plain_extra)
        ref = call(plain, ragged, (odd[9], odd[11]), plain_extra)
        need(same_bits(got, ref), f"{name} at {N}^3 {plain_extra[:1]} on "
             f"the window {odd[9:]} is not bit for bit its plain version")
        if timed:
            tab = 4 * gtabs[0].numel() if "tab" in name else 0

            def k():
                return call(kern)
            ms, batch, host = time_ms(k), batch_ms(k), host_ms(k)
            record_phase(rec, N, name, 0.0, 0.0, ms,
                         time_ms(lambda: call(plain, args=plain_extra)),
                         per_mode * modes + tab, modes,
                         extra=f"bit for bit (and on the window {odd[9:]}), "
                         f"20 calls back to back {batch:.4f} ms a call, the "
                         f"host's enqueue {1e3 * host:.1f} us, " + win)
            rec[name].update(batch_ms=batch, host_ms=host)
        del got, ref
    del shard, ragged
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


def _device_split(fn, calls=3):
    """Device ms a call of fn by kind of kernel, from torch.profiler over
    ``calls`` calls: cuFFT's ("fft" in the name), PyTorch's multiplies
    (MulFunctor, AUnaryFunctor), fills, copies (any other elementwise
    kernel), and the rest; and the kernels' names with their ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kinds, names = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if not us or ev.key.startswith(("aten::", "cuda", "cudaLaunch")):
            continue
        name = ev.key
        low = name.lower()
        kind = ("cufft" if "fft" in low else
                "multiply" if ("mulfunctor" in low or "aunaryfunctor" in low)
                else "fill" if "fill" in low else
                "copy" if ("elementwise" in low or "copy" in low)
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3 / calls
        names[name[:90]] = us / 1e3 / calls
    return kinds, names


def loaded_libraries(part):
    """The files mapped into this process whose name holds ``part``."""
    with open("/proc/self/maps") as fd:
        return sorted({ln.split()[-1] for ln in fd if part in ln
                       and "/" in ln})


def strided_geometry(N, c):
    """The plans of the layout that the port did not take, timed here
    alone (grids.plan_geometry's form): the spectrum [c, N, N, N/2+1] as K2
    wrote it before the port's plans, its 2-D c2c over (x, y) in place at
    element stride N/2+1 and batch distance 1, a call a component; the c2r
    over z contiguous, one call."""
    Nh = N // 2 + 1
    c2c = dict(rank=2, n=(N, N), inembed=(N, N), istride=Nh, idist=1,
               onembed=(N, N), ostride=Nh, odist=1, batch=Nh, calls=c,
               step_in=N * N * Nh, step_out=N * N * Nh)
    z = dict(rank=1, n=(N,), inembed=(Nh,), istride=1, idist=Nh,
             onembed=(N,), ostride=1, odist=N, batch=c * N * N, calls=1,
             step_in=0, step_out=0)
    return dict(c2c=c2c, z=z)


def grid_fft_phase(dev, report):
    """The dense engine's 3-D transforms at 512^3 for c = 6 and c = 3: the
    torch.fft two-step c2r (the grids.irfft3 of before the port's plans)
    split into its copies, multiplies and cuFFT by the profiler
    (library_ms, its whole time); the port's plans (grids.irfft3_ on a
    spectrum kz outermost, [c, N/2+1, N, N]): the contiguous 2-D c2c, the
    zeroing of the kz = 0, N/2 imaginary parts, the c2r reading z at stride
    N^2, and the whole; the other candidate layout, K2's former [c, N, N,
    N/2+1]: its strided in-place 2-D c2c and its contiguous c2r; the forward
    (grids.rfft3) against torch.fft's.  Each direct result against
    torch.fft's (max |diff| over max, share of equal values); K2 (the
    kz-fastest tiles, with its scale 2^-27) against its plain twin bit for
    bit and its time beside the window kernel's on the whole grid (K2s at
    the window (0, 0)); K2 scaled then irfft3_ against the window kernel's
    K2 then the torch.fft c2r; the device peak of one inverse against
    spectrum + output + the plans' work area.  Bound: the spectrum read and
    written by the in-place c2c and read by the c2r, and the real stack
    written once, over 3.35 TB/s."""
    import torch
    from pinocchio_tpu_torch import grids, kernels
    from pinocchio_tpu_torch.ops import derivatives
    N = 512
    Nh = N // 2 + 1
    print(f"  libcufft mapped: {loaded_libraries('libcufft')}", flush=True)
    out = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)

    def stream():
        return kernels.stream_ptr(dev)

    def torch_c2r(k):
        return grids.irfft_z(torch.fft.ifft2(k, dim=(-3, -2)), N)

    def torch_r2c(x):
        return torch.fft.fft2(torch.fft.rfft(x, dim=-1),
                              dim=(-3, -2)).contiguous()

    def compare(a, b):
        a, b = (torch.view_as_real(t) if t.is_complex() else t
                for t in (a, b))
        err = ((a - b).abs().max() / b.abs().max()).item()
        return err, (a == b).float().mean().item()

    def plans(g):
        xy = grids.PLANS.get(0, grids.CUFFT_C2C, g["c2c"])
        z = grids.PLANS.get(0, grids.CUFFT_C2R, g["z"])
        return g, xy, z, grids._work((xy, z), dev)

    for c in (6, 3):
        spec = torch.randn((c, N, N, Nh), dtype=torch.complex64,
                           device=dev, generator=gen)
        ref = torch_c2r(spec)
        kz = spec.permute(0, 3, 1, 2).contiguous()       # [c, Nh, N, N]
        scaled = torch.view_as_complex(torch.view_as_real(kz).mul(
            grids.irfft3_scale(spec, N)))
        got = grids.irfft3_(scaled.permute(0, 2, 3, 1), N)
        err, same = compare(got, ref)
        del got, scaled
        got = grids.irfft3(spec, N)                     # a contiguous input
        need(compare(got, ref)[0] <= 1e-5, f"grid_fft c={c}: irfft3 of a "
             "contiguous spectrum disagrees with torch.fft")
        del got, ref
        split, names = _device_split(lambda: torch_c2r(spec))
        rec = dict(max_rel_err=err, equal_share=same, torch_split=split,
                   torch_kernels=names,
                   library_ms=time_ms(lambda: torch_c2r(spec)))
        real = torch.empty((c, N, N, N), dtype=torch.float32, device=dev)
        g, xy, z, wa = plans(grids.plan_geometry(N, c))
        rec["work_bytes"] = max(xy[1], z[1])
        rec["c2c_ms"] = time_ms(lambda: grids._run(
            xy, grids.CUFFT_C2C, grids.INVERSE, g["c2c"], kz, kz, wa,
            stream()))
        rec["zero_ms"] = time_ms(lambda: grids._zero_real_planes(kz, N, 1))
        rec["c2r_ms"] = time_ms(lambda: grids._run(
            z, grids.CUFFT_C2R, 0, g["z"], kz, real, wa, stream()))
        rec["direct_ms"] = time_ms(lambda: grids.irfft3_(
            kz.permute(0, 2, 3, 1), N))
        del kz, wa
        gs, sxy, sz, ws = plans(strided_geometry(N, c))
        buf = spec.clone()
        rec["strided_c2c_ms"] = time_ms(lambda: grids._run(
            sxy, grids.CUFFT_C2C, grids.INVERSE, gs["c2c"], buf, buf, ws,
            stream()))
        rec["strided_c2r_ms"] = time_ms(lambda: grids._run(
            sz, grids.CUFFT_C2R, 0, gs["z"], buf, real, ws, stream()))
        rec["strided_work_bytes"] = max(sxy[1], sz[1])
        del buf, ws, spec
        # the forward way
        x = torch.randn((c, N, N, N), dtype=torch.float32, device=dev,
                        generator=gen)
        xk = x.clone()
        fwd = grids.rfft3(x)
        need(torch.equal(x, xk), f"grid_fft c={c}: rfft3 changed its input")
        rec["rfft3_max_rel_err"], rec["rfft3_equal_share"] = compare(
            fwd, torch_r2c(x))
        del fwd, xk
        rec["rfft3_ms"] = time_ms(lambda: grids.rfft3(x))
        rec["rfft3_library_ms"] = time_ms(lambda: torch_r2c(x))
        rec["rfft3_split"] = _device_split(lambda: grids.rfft3(x))[0]
        rec["rfft3_torch_split"] = _device_split(lambda: torch_r2c(x))[0]
        del x, real
        nbytes = 3 * 8 * c * N * N * Nh + 4 * c * N ** 3
        rec["bound_ms"] = 1e3 * nbytes / PEAK_BYTES
        # the device peak of one inverse
        spec = torch.randn((c, Nh, N, N), dtype=torch.complex64, device=dev,
                           generator=gen)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = grids.irfft3_(spec.permute(0, 2, 3, 1), N)
        torch.cuda.synchronize()
        rec["peak_over_spectrum_bytes"] = (
            torch.cuda.max_memory_allocated(dev) - base)
        # the caching allocator rounds a block up to 512 bytes
        rec["allowed_bytes"] = (got.numel() * 4
                                + -(-rec["work_bytes"] // 512) * 512)
        del spec, got
        print(f"  [512^3, c={c}] irfft3_ (kz outermost) {rec['direct_ms']:.3f}"
              f" ms: c2c {rec['c2c_ms']:.3f}, zero {rec['zero_ms']:.3f}, c2r "
              f"{rec['c2r_ms']:.3f}; strided layout c2c "
              f"{rec['strided_c2c_ms']:.3f}, c2r {rec['strided_c2r_ms']:.3f};"
              f" torch.fft {rec['library_ms']:.3f} ms split {split}; bound "
              f"{rec['bound_ms']:.3f} ms; vs torch max rel {err:.2e}, equal "
              f"{same:.4f}; rfft3 direct {rec['rfft3_ms']:.3f} ms split "
              f"{rec['rfft3_split']}, torch {rec['rfft3_library_ms']:.3f} ms "
              f"split {rec['rfft3_torch_split']}, max rel "
              f"{rec['rfft3_max_rel_err']:.2e}, equal "
              f"{rec['rfft3_equal_share']:.4f}; work {rec['work_bytes']} B "
              f"(strided {rec['strided_work_bytes']} B), peak over the "
              f"spectrum {rec['peak_over_spectrum_bytes']} B (output + work "
              f"{rec['allowed_bytes']} B)", flush=True)
        print(f"    torch.fft kernels (ms a call): {names}", flush=True)
        need(rec["peak_over_spectrum_bytes"] <= rec["allowed_bytes"],
             f"grid_fft c={c}: the inverse's peak over its spectrum exceeds "
             "output + work area")
        need(err <= 1e-5 and rec["rfft3_max_rel_err"] <= 1e-5,
             f"grid_fft c={c}: the direct transforms disagree with torch.fft")
        torch.cuda.empty_cache()
        out[c] = rec
    # K2 with its scale: the plain twin's bits; its time beside the window
    # kernel's; K2 scaled + irfft3_ against the window kernel + torch.fft
    from pinocchio_tpu_torch import ic
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.grids import Grid
    p = params_for(N)
    delta = ic.generate_kdensity(Grid(N, p.BoxSize_htrue), Cosmology(p),
                                 p.RandomSeed, dev)
    scale = grids.irfft3_scale(delta, N)
    for R in (0.0, 2.0):
        hk = derivatives.hessian_kspace(delta, R, N, scale)
        need(same_bits(hk, derivatives.hessian_kspace_plain(delta, R, N,
                                                            scale)),
             f"K2 with scale at R={R}: not its plain twin's bits")
        new = grids.irfft3_(hk, N)
        del hk
        old = torch_c2r(derivatives.hessian_kspace_shard(delta, R, N, 0, 0))
        err, same = compare(new, old)
        rec = dict(max_rel_err=err, equal_share=same,
                   k2_ms=time_ms(lambda: derivatives.hessian_kspace(
                       delta, R, N, scale)),
                   window_ms=time_ms(lambda: derivatives.hessian_kspace_shard(
                       delta, R, N, 0, 0)))
        out[f"k2_R{R}"] = rec
        print(f"  [512^3] K2 (R={R}) kz tiles {rec['k2_ms']:.3f} ms, the flat "
              f"window kernel (K2s at (0, 0)) {rec['window_ms']:.3f} ms; "
              f"scaled + irfft3_ vs the flat one + torch.fft: max rel {err:.2e}, equal "
              f"{same:.4f}", flush=True)
        del new, old
    del delta
    torch.cuda.empty_cache()
    report["grid_fft"] = out
    KEPT["grid_fft"] = out


# each phase's host peak: this process's resident set sampled every 5 ms
HOST_PERIOD = 0.005


def host_peak():
    """A multihost.ResidentPeak sampling every HOST_PERIOD seconds."""
    from pinocchio_tpu_torch.parallel.multihost import ResidentPeak
    return ResidentPeak(HOST_PERIOD)


def host_line(host, report):
    """A run's host peak (host_peak()) beside the planner's estimate of its
    largest host phase."""
    grew, pred = (host.peak - host.start) * GiB, report["host_bytes"]
    return (f"host peak {grew / GiB:.2f} GiB above the start (VmRSS "
            f"sampled every {1000 * HOST_PERIOD:g} ms), planner "
            f"{pred / GiB:.2f} GiB ({report['host']['phase']}; "
            f"measured/predicted {grew / pred:.3f})")


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
        with host_peak() as host:
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
              + host_line(host, res["plan"]), flush=True)
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
        if name == "ooc_bf16":
            KEPT["ooc_bf16"] = (res["fmax"].products.Fmax.cpu().numpy(),
                                sv.copy(), res["fmax"].host_products)
            ooc16_checks(dev, p, res, wall)
        if name == "classic":
            # what the fits phase converts
            KEPT["classic_out"] = scratch_dir("classic_out")
            keep_files(out, KEPT["classic_out"])
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
    need((host.peak - host.start) * GiB <= 1.25 * plan["host_bytes"],
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
                with host_peak() as host:
                    path = run_special_mode(p, mode, out, device=dev,
                                            verbose=False)
            finally:
                derivatives.density_field = real_density_field
            torch.cuda.synchronize()
            walls[mode] = time.perf_counter() - t0
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            hline = ""
            if mode == 3:
                hline = ", " + host_line(host, planner.plan(
                    p, dev, dense_products=True))
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
    spheres of radius 0 to 40 centred anywhere (numpy, as the exchange
    holds them), so that some cross the shard's edge and the periodic wrap,
    and one of radius N/2; a 4-channel
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
                spheres=sph,
                owner=rng.integers(0, nhosts, len(sph)).astype(np.int32),
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
        # K15 one call, back to back and the host's enqueue: 8 B of cell
        # read and the bitmask written a row, the counts written
        rowbytes = n * (8 + 4 * W) + 4 * counts.numel()
        form = k15_times(lambda: count(xops.count), rowbytes,
                         n * case["nboxes"])
        if timed:
            record_phase(rec, N, "exchange_count", 0.0, 0.0, form["ms"],
                         time_ms(lambda: count(xops.count_plain), reps=2),
                         rowbytes, n * case["nboxes"],
                         extra=f"identical, {shard}{members} memberships "
                         f"of {n} rows; 20 calls back to back "
                         f"{form['batch_ms']:.4f} ms a call, the host's "
                         f"enqueue {form['host_ms']:.4f} ms; ")
            rec["exchange_count"].update(batch_ms=form["batch_ms"],
                                         host_ms=form["host_ms"], forms={})
        else:
            k15_line(N, f"boxes, {shard}{members} memberships of {n} rows",
                     form)
        rec["exchange_count"]["forms"][f"boxes, {nhosts} hosts"] = form
        sph, owner = case["spheres"], case["owner"]
        plan = xops.PaintSpheres(sph, owner, N).plan(block)
        if timed:
            # the first call of a plan uploads it (page-locked, no wait)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xops.paint(plan, pb, po, tb, to, nhosts)
            torch.cuda.synchronize()
            first = 1e3 * (time.perf_counter() - t0)
        paint_args = (plan, pb, po, tb, to, nhosts)
        hmap = xops.paint(*paint_args)
        need(torch.equal(hmap, xops.paint_plain(*paint_args)),
             f"exchange_paint at {N}^3 ({nhosts} hosts) differs")
        need(all(torch.equal(g, w) for g, w in zip(
            count(xops.count, hmap), count(xops.count_plain, hmap))),
            f"exchange_count with request maps at {N}^3 differs")
        painted = int(hmap.sum())
        if timed:
            # the map form's floor: each 32-byte sector of the maps that a
            # row and host reads, beside the rows' own bytes
            ncell = hmap[0].numel()
            sectors = sum(int(torch.unique((h * ncell + cells) // 32).numel())
                          for h in range(nhosts))
            form = k15_times(lambda: count(xops.count, hmap),
                             rowbytes + 32 * sectors, n * nhosts)
            form.update(sectors=sectors)
            k15_line(N, f"request maps, {shard}{sectors} map sectors read "
                     f"(a floor of {form['bound_ms']:.4f} ms with the rows)",
                     form)
            rec["exchange_count"]["forms"][f"map, {nhosts} hosts"] = form
        if timed:
            # the cells of each sphere that fall in the shard, each tested
            # once (the rest of the cube needs no box test)
            h2 = N // 2
            inside = cube = 0
            for cx, cy, cz, r in sph.tolist():
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

            def k17():
                return xops.paint(*paint_args)
            # the caller's host work: the spheres' shared part once per
            # exchange, then the shard's plan
            set_reps, plan_reps = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                balls = xops.PaintSpheres(sph, owner, N)
                t1 = time.perf_counter()
                balls.plan(block)
                set_reps.append(1e3 * (t1 - t0))
                plan_reps.append(1e3 * (time.perf_counter() - t1))
            set_ms = statistics.median(set_reps)
            plan_ms = statistics.median(plan_reps)
            ms, batch, host = time_ms(k17), batch_ms(k17), host_ms(k17)
            record_phase(rec, N, "exchange_paint", 0.0, 0.0, ms,
                         time_ms(lambda: xops.paint_plain(*paint_args),
                                 reps=2),
                         hmap.numel() + sph.size * 4, inside,
                         extra=f"identical, {shard}{sph.shape[0]} spheres "
                         f"(radii {int(sph[:, 3].min())}-"
                         f"{int(sph[:, 3].max())}), {plan.ncols} columns "
                         f"in {plan.nrows} rows, {painted} cells painted of "
                         f"{inside} in the spheres ({cube} in their cubes);"
                         f" on the host the spheres' set {set_ms:.3f} ms "
                         f"once per exchange and the shard's plan "
                         f"{plan_ms:.3f} ms, so plan and call "
                         f"{plan_ms + ms:.3f} ms for the caller; the first "
                         f"call {first:.3f} ms, 20 calls back to back "
                         f"{batch:.4f} ms a call, the host's enqueue "
                         f"{host:.4f} ms; ")
            rec["exchange_paint"].update(first_ms=first, batch_ms=batch,
                                         host_ms=host, set_ms=set_ms,
                                         plan_ms=plan_ms,
                                         plan_call_ms=plan_ms + ms,
                                         painted=painted, inside=inside,
                                         cube=cube)
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
            def k16():
                return xops.pack(*args, out_k)
            ms, batch, host = time_ms(k16), batch_ms(k16), host_ms(k16)
            floor = pack_sector_floor(case, bits, n, W, rowf, members)
            # a yardstick, not K16's function: the payload's arrays (cell
            # bits, F, 3 floats a channel) gathered by perm alone, each by
            # its own index_select into a contiguous copy
            buf, perm = case["buf"], case["perm"]
            arrays = [buf[:n], buf[n:2 * n]] + [
                buf[(2 + 3 * c) * n:(5 + 3 * c) * n].view(n, 3)
                for c in range(case["nch"])]
            copies = [torch.empty_like(a) for a in arrays]

            def gather():
                for a, o in zip(arrays, copies):
                    torch.index_select(a, 0, perm, out=o)
            gather_ms = batch_ms(gather)
            del arrays, copies
            record_phase(rec, N, "exchange_pack", 0.0, 0.0, ms,
                         time_ms(lambda: xops.pack_plain(*args, out_p)),
                         n * (8 + 4 * W + 4 * rowf) + 8 * counts.numel()
                         + 4 * rowf * members, members,
                         extra=f"identical, {shard}{members} memberships "
                         f"of {n} rows of {4 * rowf} B packed; 20 calls "
                         f"back to back {batch:.4f} ms a call, the host's "
                         f"enqueue {host:.4f} ms; the sector floor "
                         f"{floor[0]:.4f} ms "
                         f"({floor[1] / 1e9:.3f} GB: {floor[2]} sectors of "
                         f"the rows' payloads read once); the payload's "
                         f"arrays gathered by perm alone (index_select "
                         f"each, back to back) {gather_ms:.4f} ms, ")
            rec["exchange_pack"].update(batch_ms=batch, host_ms=host)
        else:
            print(f"  [{N}^3] exchange_count, exchange_pack, exchange_paint:"
                  f" identical with {shard}{members} memberships, "
                  f"{painted} cells painted", flush=True)
        del case, got, want, bits, counts, hmap, args, out_k, out_p
        torch.cuda.empty_cache()


def k15_times(fn, nbytes, nelem):
    """K15's times of fn on the card: one call, 20 back to back and the
    host's enqueue, beside its bound for nbytes and nelem box tests."""
    return dict(ms=time_ms(fn), batch_ms=batch_ms(fn), host_ms=host_ms(fn),
                bound_ms=bound("exchange_count", nbytes, nelem)[0])


def k15_line(N, what, form):
    print(f"  [{N}^3] exchange_count, {what}: identical; one call "
          f"{form['ms']:.4f} ms, back to back {form['batch_ms']:.4f} "
          f"({form['batch_ms'] / form['bound_ms']:.2f}x the bound "
          f"{form['bound_ms']:.4f}), host {1e3 * form['host_ms']:.1f} us",
          flush=True)


def pack_sector_floor(case, bits, n, W, rowf, members):
    """K16's sector floor for the rows of an exchange case: each member
    row's payload read once in whole 32-byte sectors where it lies in the
    hand-off buffer (its cell bits and F one each, its 3 floats a channel
    one or two), the memberships' rows written once, perm and the bitmask
    words read once: (ms at PEAK_BYTES, bytes, payload sectors).  Byte
    offsets count from the buffer's start, which the allocator puts on a
    whole sector."""
    rows = case["perm"][(bits != 0).any(1)]
    sectors = 2 * rows.numel()
    for ch in range(case["nch"]):
        start = 4 * (2 * n + 3 * n * ch) + 12 * rows
        sectors += int(((start + 11) // 32 - start // 32 + 1).sum())
    nbytes = 32 * sectors + 4 * rowf * members + n * (8 + 4 * W)
    return 1e3 * nbytes / PEAK_BYTES, nbytes, sectors


def hosts_products(dev):
    """The hosts phases' shared products: the classic fmax at HOSTS_N
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
    p = params_for(HOSTS_N, subbox_tasks=CORES)
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
    """The exchange on the deferred HOSTS_N^3 mesh products (hosts_products):
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
    from pinocchio_tpu_torch.parallel import exchange as xchg
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
    # the spheres each turn-1 exchange paints (K17's real workload) and
    # the time of its maps, plans included (the card synchronized around)
    painted, paint_ms = [], []
    build = xchg.build_turn1_maps

    def recorded(spheres, *a, **kw):
        painted.append({h: np.asarray(v) for h, v in spheres.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = build(spheres, *a, **kw)
        torch.cuda.synchronize()
        paint_ms.append(1e3 * (time.perf_counter() - t0))
        return maps
    xchg.build_turn1_maps = recorded
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        parts = [run_fragmentation_multibox(
            p, d["cosmo"], fr, d["nbox"], largest_mass=d["largest"],
            two_turn=True, host_slice=(h, HOSTS), verbose=False)
            for h in range(HOSTS)]
        torch.cuda.synchronize()
    finally:
        xchg.build_turn1_maps = build
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    radii = np.concatenate([v[:, 3] for x in painted for v in x.values()]
                           or [np.zeros(0)]).astype(int)
    print(f"  K17's spheres in the two-turn run: {len(painted)} paints of "
          f"{[sum(len(v) for v in x.values()) for x in painted]} spheres; "
          f"radii (cells) min {radii.min() if radii.size else '-'}, median "
          f"{int(np.median(radii)) if radii.size else '-'}, max "
          f"{radii.max() if radii.size else '-'}, {int((radii <= 0).sum())} "
          f"of radius 0; K17 launches {launches['exchange_paint']}; "
          f"build_turn1_maps (plans, uploads and paints of every shard) "
          f"{[round(x, 3) for x in paint_ms]} ms", flush=True)
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
                           turn1=[x["turn1_copies"] for x in t],
                           paint_spheres=[sum(len(v) for v in x.values())
                                          for x in painted],
                           paint_ms=paint_ms,
                           paint_radii=np.bincount(
                               np.maximum(radii, 0)).tolist())
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
    out = scratch_dir("hosts")
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
    # the files before the merge, for the procs phase
    keep_files(out, scratch_dir("hosts_chunks"))
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


def scratch_dir(name):
    """A fresh directory ``name`` under this run's scratch directory (made
    on first use, removed when the script ends)."""
    import shutil
    if "scratch" not in KEPT:
        KEPT["scratch"] = tempfile.mkdtemp(prefix="chip_smoke_")
    d = os.path.join(KEPT["scratch"], name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def keep_files(src, dst):
    """Copy the files of ``src`` (not its directories) into ``dst``."""
    import shutil
    for f in os.listdir(src):
        if os.path.isfile(os.path.join(src, f)):
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))


def same_files(what, got, want):
    """The two directories hold the same file names and every file byte
    for byte."""
    import filecmp
    a = sorted(f for f in os.listdir(got) if os.path.isfile(
        os.path.join(got, f)))
    b = sorted(f for f in os.listdir(want) if os.path.isfile(
        os.path.join(want, f)))
    need(a == b, f"{what}: the files differ in name: "
         f"{sorted(set(a) ^ set(b))}")
    differ = [f for f in a if not filecmp.cmp(os.path.join(got, f),
                                              os.path.join(want, f),
                                              shallow=False)]
    print(f"  {what}: {len(a) - len(differ)} of {len(a)} files "
          f"byte-identical", flush=True)
    need(not differ, f"{what}: not byte-identical: {differ}")


def write_parameter_file(d, N, **flags):
    """The parameter file of params_for(N, **flags)'s run (GridSize,
    BoxSize, the outputs file and each true flag; the CLI's --norad for no
    radiation; no StartingzForPLC, so no past light cone) in ``d``."""
    with open(os.path.join(d, "outputs"), "w") as fd:
        fd.write("".join(f"{z}\n" for z in OUTPUT_Z))
    pf = os.path.join(d, "parameter_file")
    with open(pf, "w") as fd:
        fd.write(f"GridSize {N}\nBoxSize {float(N)}\nOutputList outputs\n"
                 + "".join(f"{k}\n" for k, v in flags.items() if v))
    return pf


def cli_argv(pf, out, port, extra=()):
    """The arguments of the CLI (python -m pinocchio_tpu_torch.run; each
    process adds its --host-id) of HOSTS processes over a 2x2 pencil mesh
    of the card, two shards each on cuda:0, one sub-box per core, its group
    at localhost:<port>, ``extra`` added."""
    return [pf, "--norad", "--device", "cuda", "--chips", "4", "--decomp",
            HOSTS_MESH[0], "--shard-devices", "cuda:0,cuda:0", "--hosts",
            str(HOSTS), "--coordinator", f"localhost:{port}", "--subboxes",
            str(CORES), "--outdir", out, "--group-timeout",
            str(PROCS_GROUP_TIMEOUT)] + list(extra)


# one process of the processes phase (argv: its host id and the JSON list
# of its runs; process_runs)
PROCS_MAIN = ("import json, sys\n"
              "import chip_smoke\n"
              "chip_smoke.process_runs(int(sys.argv[1]), "
              "json.loads(sys.argv[2]))\n")


def process_runs(h, runs):
    """Process h's runs of the processes phase, one after another, each
    with the launch counts, the bytes through the group and the card's
    peak set to 0 just before it, and each bringing its group up at a port
    of its own and down again: "cli", the CLI's main on the run's argv with
    --host-id h (``two_turn``: the fragmentation's memory-driven default,
    which picks single-turn on this host, forced to two-turn, as on a host
    short of memory), which prints its "[cluster] {...}" line; "bf16",
    fmax16_process.  Then a "[jax] [...]" line: the modules of jax or of
    the JAX package imported (none)."""
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.fragment import subbox
    from pinocchio_tpu_torch.parallel import multihost
    from pinocchio_tpu_torch.run import main as cli_main
    for run in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        for rec in multihost.TRAFFIC.values():
            rec.update(bytes=0, seconds=0.0, calls=0)
        if run["kind"] == "bf16":
            fmax16_process(h, run["port"])
            continue
        default = subbox.default_two_turn
        if run.get("two_turn"):
            subbox.default_two_turn = lambda *args: True
        try:
            cli_main(run["argv"] + ["--host-id", str(h)])
        finally:
            subbox.default_two_turn = default
    print("[jax] " + json.dumps(sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "pinocchio_tpu"))),
        flush=True)


def fmax16_process(h, port):
    """Process h's out-of-core fmax phase alone at PIPELINE_N with bfloat16
    storage over OOC_MESH16 shards split over the HOSTS processes (its own
    on cuda:0), its group at localhost:<port>; prints its "[cluster]
    {...}" line with its fmax peaks and the digest of its products."""
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fmax_ooc import run_fmax_ooc
    from pinocchio_tpu_torch.parallel import multihost, pfft
    procs = multihost.initialize_cluster(HOSTS, f"localhost:{port}", h,
                                         timeout=PROCS_GROUP_TIMEOUT)
    try:
        p = params_for(PIPELINE_N, ooc="on", ooc_dtype="bfloat16")
        mesh = pfft.mesh_for(OOC_MESH16, "slab", procs=procs,
                             devices=["cuda:0"] * (OOC_MESH16 // procs[1]))
        cosmo = Cosmology(p)
        t0 = time.perf_counter()
        with multihost.ResidentPeak() as resident:
            res = run_fmax_ooc(p, cosmo, "cuda:0", mesh=mesh,
                               trace_memory=True)
            res.pending_fetch.join()
        wall = time.perf_counter() - t0
        rep = multihost.process_report(mesh, res.timings, wall,
                                       resident=resident)
        rep.update(peaks=res.peaks, digest=products_digest(
            res.products.gather()[0], res.smoothing.true_variance,
            res.pdf_hist, res.host_products))
        print("[cluster] " + json.dumps(rep), flush=True)
    finally:
        multihost.shutdown_cluster()


def run_procs(out, runs):
    """HOSTS processes of PROCS_MAIN, each making ``runs`` (process_runs;
    each run's "port" filled with a free localhost port); returns each
    run's reports (one per process, as each printed it: wall, phase
    timings, launches, device peak, host peak, bytes and seconds through
    the group) and the wall from the launch to the last exit.  Every
    process is stopped before this returns."""
    import socket
    socks = [socket.socket() for _ in runs]
    try:
        for sk in socks:
            sk.bind(("localhost", 0))
        ports = [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()
    runs = [dict(r, port=port, argv=[a.replace("{port}", str(port))
                                      for a in r.get("argv", [])])
            for r, port in zip(runs, ports)]
    logs, procs = [], []
    t0 = time.perf_counter()
    try:
        for h in range(HOSTS):
            logs.append(open(os.path.join(out, f".log{h}"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", PROCS_MAIN, str(h), json.dumps(runs)],
                cwd=HERE, stdout=logs[h], stderr=subprocess.STDOUT))
        rcs = [pr.wait(timeout=2 * PROCS_GROUP_TIMEOUT) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    wall = time.perf_counter() - t0
    reports = [[] for _ in runs]
    for h, (rc, log) in enumerate(zip(rcs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        os.remove(log.name)
        lines = text.splitlines()
        got = [json.loads(ln[len("[cluster] "):]) for ln in lines
               if ln.startswith("[cluster] {")]
        jax = [json.loads(ln[len("[jax] "):]) for ln in lines
               if ln.startswith("[jax] ")]
        if rc != 0 or len(got) != len(runs) or not jax:
            print(text[-4000:], flush=True)
        need(rc == 0 and len(got) == len(runs) and jax,
             f"process {h} exited with {rc} after {len(got)} of "
             f"{len(runs)} runs")
        need(not jax[0], f"process {h} imported {jax[0][:5]}")
        for r, (run, rep) in enumerate(zip(runs, got)):
            print(f"  {run['what']} process {h}: {json.dumps(rep)}",
                  flush=True)
            reports[r].append(rep)
    print(f"  {HOSTS} processes made {len(runs)} runs each in {wall:.2f} s "
          f"(launch to exit); no module of jax imported", flush=True)
    return reports, wall


def procs_launch_sets(what, reports, own):
    for h, rep in enumerate(reports):
        got = set(rep["launches"])
        need(got == own, f"{what} process {h}: not launched "
             f"{sorted(own - got)}, launched from another path "
             f"{sorted(got - own)}")


def traffic_line(rep):
    """One process's bytes (GB), seconds and calls through the group, by
    kind, and its host peak beside the planner's node estimate."""
    kinds = ", ".join(f"{k} {v['bytes'] / 1e9:.3f} GB {v['seconds']:.2f} s "
                      f"{v['calls']} calls"
                      for k, v in rep["traffic"].items() if v["calls"])
    host = (f"; host {rep['host_start_gib']:.2f} GiB at the run's start, "
            f"peak {rep['host_peak_gib']:.2f} GiB (VmRSS every 10 ms)")
    if rep.get("planned_host_gib") is not None:
        host += (f"; planner {rep['planned_host_gib']:.2f} GiB for the "
                 f"node's {rep['node_processes']} processes")
    return f"process {rep['host']}: {kinds}{host}"


def products_digest(F, sv, hist, sp):
    """SHA-256 of each array of an out-of-core run's products: Fmax, the
    variances, the FmaxPDF counts, the needed cells, F and every row of
    every set."""
    import hashlib

    import numpy as np
    arrays = dict(Fmax=F, variances=sv, pdf_hist=hist, ci=sp.ci, F=sp.F)
    for s, rows in enumerate(sp.segments or [sp.vel]):
        arrays.update({f"set{s}/{k}": v for k, v in rows.items()})
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in sorted(arrays.items())}


def mocked_ooc_hosts(dev):
    """run_pipeline(hosts=(h, HOSTS)) with ooc on and DumpProducts over a
    2x2 pencil mesh of the card at PIPELINE_N, one sub-box per core, for
    each h in this process, with the launch counts set to 0 just before
    and read just after (the OOC set: each mocked host repeats the whole
    fmax phase): (the output directory, the launches, each host's wall)."""
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.run import run_pipeline
    N = PIPELINE_N
    p = params_for(N, subbox_tasks=CORES, ooc="on", DumpProducts=True)
    mocked = scratch_dir("ooc_procs_mocked")
    torch.cuda.synchronize()
    kernels.reset_launches()
    walls = []
    for h in range(HOSTS):
        t0 = time.perf_counter()
        run_pipeline(p, outdir=mocked, device=dev, verbose=False,
                     mesh=card_mesh(dev, *HOSTS_MESH), hosts=(h, HOSTS))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    print(f"  {N}^3 out-of-core mocked hosts: "
          f"{[round(w, 2) for w in walls]} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    missing = sorted(k for k in OOC if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in OOC)
    need(not missing and not stray, f"ooc_procs mocked hosts: not launched "
         f"{missing}, launched from another path {stray}")
    return mocked, launches, walls


def mocked_two_turn_hosts(dev):
    """run_pipeline(hosts=(h, HOSTS)) at PROCS_TWO_TURN_N over the 2x2
    pencil mesh of the card, one sub-box per core, with the memory-driven
    default forced to two-turn, for each h in this process: (the output
    directory, each host's wall)."""
    import torch
    from pinocchio_tpu_torch.fragment import subbox
    from pinocchio_tpu_torch.run import run_pipeline
    N = PROCS_TWO_TURN_N
    p = params_for(N, subbox_tasks=CORES)
    mocked = scratch_dir("procs_mocked")
    default = subbox.default_two_turn
    subbox.default_two_turn = lambda *args: True
    try:
        walls = []
        for h in range(HOSTS):
            t0 = time.perf_counter()
            r = run_pipeline(p, outdir=mocked, device=dev, verbose=False,
                             mesh=card_mesh(dev, *HOSTS_MESH),
                             hosts=(h, HOSTS))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            need(r["frag"].timings.get("turn1_copies", 0) > 0,
                 f"the mocked two-turn host {h} shipped no turn-1 copies")
    finally:
        subbox.default_two_turn = default
    print(f"  {N}^3 two-turn mocked hosts: {[round(w, 2) for w in walls]} s",
          flush=True)
    return mocked, walls


def processes_phase(dev, which):
    """The hosts as HOSTS processes on the one card (gloo, through
    page-locked host buffers), each holding two shards of a 4-shard mesh
    on cuda:0: every run of ``which`` in one launch of the processes
    (PROCS_MAIN; a fresh process costs seconds before it reaches the card),
    the out-of-core run first, each run's references made first in this
    process.
      ooc_procs: the out-of-core engine's hosts (the CLI with --ooc on and
        DumpProducts) at PIPELINE_N over a 2x2 pencil mesh, one sub-box per
        core, each process holding two shards' kz windows and x-blocks and
        landing the whole products: every file and the dump byte for byte
        those of run_pipeline(hosts=(h, HOSTS)) in this process over the
        same mesh (mocked_ooc_hosts), each process's launch set OOC, its
        planner counting both processes of the node, and their resident
        sets' growth within 25 % of that estimate either way.
      procs: the dense engine's hosts (the CLI) over the 2x2 pencil mesh,
        one sub-box per core: at HOSTS_N single-turn, each host's chunks,
        the in-run mass functions and FmaxPDF byte for byte the hosts
        path's (run first if this process has not), and
        scripts/torch_merge_chunks.py's files byte for byte its merge; at
        PROCS_TWO_TURN_N two-turn (K17 and the spheres across processes),
        every file byte for byte that of run_pipeline(hosts=(h, HOSTS)) in
        this process over the same mesh with the same default; each
        process's launches the mesh path's kernels, K15 and K16 (and K17
        when two-turn), and none other.
      ooc_procs_bf16: the fmax phase alone with bfloat16 storage over
        OOC_MESH16 shards (fmax16_process): each process's products, which
        it lands whole, bit for bit (by SHA-256) the one process's
        ooc_mesh_bf16 phase (run first if this process has not), its
        launch set OOC16 (K18 and K19 with the out-of-core kernels).
    No process imports a module of jax.  Returns the mocked out-of-core
    hosts' launches (None without ooc_procs)."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import torch_merge_chunks

    runs, launches = [], None
    if "ooc_procs" in which:
        mocked_ooc, launches, ooc_walls = mocked_ooc_hosts(dev)
        out_ooc = scratch_dir("ooc_procs")
        pf = write_parameter_file(scratch_dir("ooc_procs_pf"), PIPELINE_N,
                                  DumpProducts=True)
        runs.append(dict(what="ooc", kind="cli", argv=cli_argv(
            pf, out_ooc, "{port}", ["--ooc", "on"])))
    if "procs" in which:
        if "hosts_path" not in KEPT:
            hosts_path(dev)
        mocked_two, two_walls = mocked_two_turn_hosts(dev)
        out_one, out_two = scratch_dir("procs"), scratch_dir("procs_two_turn")
        runs.append(dict(what="single-turn", kind="cli", argv=cli_argv(
            write_parameter_file(scratch_dir("procs_pf"), HOSTS_N), out_one,
            "{port}")))
        runs.append(dict(what="two-turn", kind="cli", two_turn=True,
                         argv=cli_argv(write_parameter_file(
                             scratch_dir("procs_two_turn_pf"),
                             PROCS_TWO_TURN_N),
                             out_two, "{port}")))
    if "ooc_procs_bf16" in which:
        if "ooc_mesh_bf16" not in KEPT:
            ooc_mesh16_phase(dev)
        runs.append(dict(what="bf16", kind="bf16"))
    torch.cuda.synchronize()
    reports, wall = run_procs(scratch_dir("procs_logs"), runs)
    got = {run["what"]: rep for run, rep in zip(runs, reports)}

    if "ooc" in got:
        reps = got["ooc"]
        procs_launch_sets("ooc", reps, OOC)
        for rep in reps:
            print(f"  ooc {traffic_line(rep)}", flush=True)
            need(rep["node_processes"] == HOSTS, "ooc_procs: the planner "
                 f"did not count the node's {HOSTS} processes")
        # each process lands the whole products and sweeps its share of the
        # sub-boxes: the node's growth against the planner's estimate for
        # its processes, within the 25 % of the other host checks
        grew = sum(r["host_peak_gib"] - r["host_start_gib"] for r in reps)
        plan = reps[0]["planned_host_gib"]
        print(f"  the node's {HOSTS} processes grew {grew:.2f} GiB in all "
              f"during their runs, planner {plan:.2f} GiB (measured/"
              f"predicted {grew / plan:.3f}, need 0.75 to 1.25)", flush=True)
        need(0.75 * plan <= grew <= 1.25 * plan, "ooc_procs: the processes' "
             "host memory is not within 25 % of the planner's estimate for "
             "the node")
        same_files(f"{PIPELINE_N}^3 out-of-core processes against the "
                   "mocked hosts", out_ooc, mocked_ooc)
        same_files(f"{PIPELINE_N}^3 out-of-core processes' dump against the "
                   "mocked hosts'", os.path.join(out_ooc, "DumpProducts"),
                   os.path.join(mocked_ooc, "DumpProducts"))
        KEPT["ooc_procs"] = dict(wall_s=wall, reports=reps,
                                 mocked_walls=ooc_walls)
    if "single-turn" in got:
        procs_launch_sets("single-turn", got["single-turn"], HOSTS_LAUNCH)
        same_files(f"{HOSTS_N}^3 processes against the mocked hosts", out_one,
                   os.path.join(KEPT["scratch"], "hosts_chunks"))
        torch_merge_chunks.merge(params_for(HOSTS_N, subbox_tasks=CORES),
                                 out_one)
        same_files(f"{HOSTS_N}^3 merge against the mocked hosts' merge",
                   out_one, os.path.join(KEPT["scratch"], "hosts"))
        procs_launch_sets("two-turn", got["two-turn"],
                          HOSTS_LAUNCH | {"exchange_paint"})
        same_files(f"{PROCS_TWO_TURN_N}^3 two-turn processes against the "
                   "mocked hosts", out_two, mocked_two)
        KEPT["procs"] = dict(
            launch_s=wall,
            single_turn=dict(reports=got["single-turn"],
                             mocked_walls=KEPT["hosts_path"]["walls"]),
            two_turn=dict(reports=got["two-turn"], mocked_walls=two_walls))
    if "bf16" in got:
        want = KEPT["ooc_mesh_bf16"]
        procs_launch_sets("bf16", got["bf16"], OOC16)
        for rep in got["bf16"]:
            print(f"  bf16 {traffic_line(rep)}; fmax {rep['wall_s']:.2f} s "
                  f"(one process over the same shards "
                  f"{KEPT['storage16']['mesh']['wall_s']:.2f} s), device "
                  f"peak {rep['device_peak_gib']:.3f} GiB", flush=True)
            differ = sorted(k for k in want
                            if rep["digest"].get(k) != want[k])
            need(not differ and sorted(rep["digest"]) == sorted(want),
                 f"bf16 process {rep['host']}: not bit for bit the "
                 f"one-process run: {differ}")
        print(f"  {PIPELINE_N}^3 bfloat16 fmax over {HOSTS} processes: bit "
              f"for bit the one-process run ({len(want)} arrays)", flush=True)
        KEPT.setdefault("storage16", {})["procs"] = dict(
            launch_s=wall, reports=got["bf16"])
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


# the hand-off (handoff): the watermark proof and the views-against-joined
# checks of the f(R) and out-of-core engines at HANDOFF_N; the per-chunk
# delay of the proof, long enough that rows are still landing when the
# sweeps start (at 0.02 s the last row of a 128^3 run landed 1.36 s after
# the cycle, before the 2x1x1 sweeps started on an H100's host)
HANDOFF_N = 128
HANDOFF_DELAY = 0.1


def products_bytes(sp):
    """The bytes of a hand-off: cell indices (int32 on the wire) and F,
    then three float32 per row and table of every displacement set."""
    sets = sp.segments or [sp.vel]
    return 4 * len(sp.ci) * (2 + 3 * sum(len(v) for v in sets))


def same_products(what, a, b):
    """Two FmaxResults' cell indices, F, every row of every displacement
    set (float32 compared through an int32 view) and FmaxPDF counts, bit
    for bit: a's read through its views (before its join, where it has
    not been joined), b's those of a joined run; returns the hand-off's
    bytes."""
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
          f"set(s); the views and the joined run's products bit for bit: "
          f"{ok}", flush=True)
    need(ok, f"{what}: the products read through the views differ from "
         "the joined run's")
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
          f"joined run's: {ok} ({[len(c.name) for c in got.catalogs]} "
          "groups)", flush=True)
    need(ok, f"{what}: the catalogs differ from the joined run's")


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
    """One line of a hand-off's times from the end of the collapse cycle
    (FmaxResult.timings after the join) and its rates; with its
    handoff.StreamState, when each table's host buffer was allocated and
    when its last row landed."""
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


def joined_run(run, *args, **kw):
    """run(*args, **kw), its hand-off joined before it is read."""
    res = run(*args, **kw)
    res.pending_fetch.join()
    return res


def handoff_phase(dev):
    """The hand-off of run_fmax and run_fmax_ooc: the classic fmax at
    PIPELINE_N on one delta, its products read through the views before
    the join against a joined run's, bit for bit, with its timeline from
    the end of the collapse cycle and a torch.profiler trace of its
    copies; the watermark proof at HANDOFF_N (HANDOFF_DELAY seconds before
    each chunk lands, one box and 2x1x1 sub-boxes single- and two-turn:
    the catalogs of a run joined before its sweep, the sweeps waiting on
    the watermark, the run longer than the delay x N_CHUNKS / 2); f(R)
    with RECOMPUTE (4 sets, traced: the copies of a set beside the next
    set's LPT kernels) and the out-of-core engine at HANDOFF_N, bit for
    bit, with equal catalogs; run_pipeline's outputs against a restart
    from its dump (same_outputs)."""
    import torch
    from pinocchio_tpu_torch import fmax, fmax_ooc, handoff
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
    # a first run builds the kernels and plans the FFTs
    joined_run(fmax.run_fmax, p, cosmo, dev, kdensity=kd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    joined = joined_run(fmax.run_fmax, p, cosmo, dev, kdensity=kd)
    wall_j = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = fmax.run_fmax(p, cosmo, dev, kdensity=kd)
    wall_r = time.perf_counter() - t0
    nbytes = same_products(f"classic {PIPELINE_N}^3", res, joined)
    res.pending_fetch.join()
    tj = joined.timings
    print(f"  joined at once: fmax {wall_j:.3f} s, the last row "
          f"{tj['handoff_last']:.4f} s after the cycle (lpt "
          f"{tj['lpt']:.4f} s on the device); read through the views: fmax "
          f"{wall_r:.3f} s to its return", flush=True)
    del res, joined
    res, trace = copy_overlap(lambda: fmax.run_fmax(p, cosmo, dev,
                                                    kdensity=kd))
    res.pending_fetch.join()
    handoff_timeline(f"classic {PIPELINE_N}^3 (traced)", res.timings,
                     nbytes, trace, res.pending_fetch.stream)
    report["classic"] = dict(timings=res.timings, bytes=nbytes, trace=trace,
                             joined_s=wall_j)
    del res, kd

    q = params_for(HANDOFF_N)
    cosmo = Cosmology(q)
    base = joined_run(fmax.run_fmax, q, cosmo, dev)
    for boxes in ("one box", "2x1x1 single-turn", "2x1x1 two-turn"):
        def frag(r):
            if boxes == "one box":
                return run_fragmentation(q, cosmo, r, verbose=False)
            return run_fragmentation_multibox(
                q, cosmo, r, (2, 1, 1), two_turn=boxes.endswith("two-turn"),
                verbose=False)
        want = frag(base)
        handoff._STREAM_TEST_DELAY = HANDOFF_DELAY
        try:
            t0 = time.perf_counter()
            r = fmax.run_fmax(q, cosmo, dev)
            got = frag(r)
            elapsed = time.perf_counter() - t0
            r.pending_fetch.join()
        finally:
            handoff._STREAM_TEST_DELAY = 0.0
        floor = HANDOFF_DELAY * handoff.N_CHUNKS / 2
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
        joined = joined_run(run, q, cosmo, dev, scaledep_gm=gm)
        r = run(q, cosmo, dev, scaledep_gm=gm)
        got = run_fragmentation(q, cosmo, r, scaledep_gm=gm, verbose=False)
        same_products(f"{name} {HANDOFF_N}^3, swept", r, joined)
        r.pending_fetch.join()
        del r
        res, trace = copy_overlap(
            lambda: joined_run(run, q, cosmo, dev, scaledep_gm=gm))
        nbytes = same_products(f"{name} {HANDOFF_N}^3, traced", res, joined)
        handoff_timeline(f"{name} {HANDOFF_N}^3 (traced, joined inside the "
                         "trace)", res.timings, nbytes, trace,
                         res.pending_fetch.stream)
        same_catalogs(f"{name} {HANDOFF_N}^3", got, run_fragmentation(
            q, cosmo, joined, scaledep_gm=gm, verbose=False))
        report[name] = dict(timings=res.timings, bytes=nbytes, trace=trace)
        del res, joined, got
    report["files"] = same_outputs(dev)
    torch.cuda.empty_cache()
    KEPT["handoff"] = report


def same_outputs(dev):
    """run_pipeline at HANDOFF_N with the past light cone (z 0.1 to 0) and
    a dump, written after the hand-off's join, then a restart from the dump
    (ReadProductsFromDumps): every file the restart writes equal to the
    first run's, byte for byte (the FmaxPDF is the dumping run's alone);
    returns the count of files compared."""
    import dataclasses
    import shutil
    from pinocchio_tpu_torch.run import run_pipeline

    p = params_for(HANDOFF_N, DumpProducts=True, plc_enabled=True,
                   StartingzForPLC=0.1, LastzForPLC=0.0, PLCAperture=30.0,
                   PLCProvideConeData=True)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() \
            as b:
        run_pipeline(p, outdir=a, device=dev, verbose=False)
        shutil.copytree(os.path.join(a, "DumpProducts"),
                        os.path.join(b, "DumpProducts"))
        run_pipeline(dataclasses.replace(p, DumpProducts=False,
                                         ReadProductsFromDumps=True),
                     outdir=b, device=dev, verbose=False)
        names = sorted(nm for nm in os.listdir(a)
                       if os.path.isfile(os.path.join(a, nm))
                       and not nm.endswith(".FmaxPDF.out"))
        files = []
        for nm in names:
            fa, fb = os.path.join(a, nm), os.path.join(b, nm)
            same = os.path.exists(fb)
            if same:
                with open(fa, "rb") as x, open(fb, "rb") as y:
                    same = x.read() == y.read()
            files.append((nm, same))
        extra = sorted(set(nm for nm in os.listdir(b)
                           if os.path.isfile(os.path.join(b, nm)))
                       - set(names))
    bad = [nm for nm, same in files if not same] + extra
    print(f"  run_pipeline at {HANDOFF_N}^3 with the PLC and a dump, against "
          f"a restart from the dump: {len(files)} files {names}, differing "
          f"or extra: {bad}", flush=True)
    need(files and not bad, f"the restart's outputs differ: {bad}")
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
    from pinocchio_tpu_torch import fmax, fmax_ooc, kernels, planner
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.driver import run_fragmentation
    from pinocchio_tpu_torch.grids import Grid
    from pinocchio_tpu_torch.ic import PlaneGenerator
    from pinocchio_tpu_torch.plc import build_plc_geometry

    N, kw, own = OOC_CHECKS[name]
    p = params_for(N, **kw)
    cosmo = Cosmology(p)
    gm = scaledep_gm_for(p, cosmo)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kd = PlaneGenerator(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed,
                        dev).assemble()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    dense = fmax.run_fmax(p, cosmo, dev, kdensity=kd, scaledep_gm=gm)
    if dense.pending_fetch is not None:
        dense.pending_fetch.join()
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    launched = {"dense": dict(kernels.LAUNCHES)}
    peak_dense = torch.cuda.max_memory_allocated()
    del kd
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ooc = fmax_ooc.run_fmax_ooc(p, cosmo, dev, scaledep_gm=gm,
                                trace_memory=True)
    ooc.pending_fetch.join()
    t_ooc = time.perf_counter() - t0
    launched["out-of-core"] = dict(kernels.LAUNCHES)
    for engine, want in (("dense", PATHS[name][2] - {"ic_kdensity"}),
                         ("out-of-core", own)):
        got = {k: v for k, v in launched[engine].items() if v}
        print(f"  launches of the {engine} engine: {got}", flush=True)
        need(set(got) == want, f"{name}: the {engine} engine's launch set "
             f"{sorted(got)} is not {sorted(want)}")
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

    def run():
        res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, scaledep_gm=gm,
                                    verbose=N >= BIG_N, trace_memory=True)
        t_ret = time.perf_counter() - t0
        res.pending_fetch.join()
        return res, t_ret
    with host_peak() as host:
        (res, t_ret), tally = factors_tallied(run)
    wall = time.perf_counter() - t0
    print(factors_line(tally, N, res), flush=True)
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
            host_gib=host.peak - host.start, timings=res.timings)
        print(f"  (ci, F) digest {KEPT['big_classic']['digest'][:16]} in "
              f"{time.perf_counter() - t0:.2f} s; host peak "
              f"{(host.peak - host.start):.2f} GiB above the start",
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
        KEPT["big_classic"]["joined"] = joined_big(
            dev, p, cosmo, None, KEPT["big_classic"])


def factors_tallied(run):
    """run() with K10's and K14's launches (derivatives.launch_factors)
    tallied by mode, form and batch planes: returns (its result,
    {(mode, form, B): calls})."""
    import threading

    from pinocchio_tpu_torch.ops import derivatives
    tally, lock = {}, threading.Lock()
    launch = derivatives.launch_factors

    def counted(mode, src, *rest):
        key = (mode, "rows" if src.stride(2) == 1 else "kz", src.shape[0])
        with lock:
            tally[key] = tally.get(key, 0) + 1
        return launch(mode, src, *rest)

    derivatives.launch_factors = counted
    try:
        out = run()
    finally:
        derivatives.launch_factors = launch
    return out, tally


def factors_line(tally, N, res):
    """K10's and K14's calls in a run at N^3 by mode, form and batch
    planes, and their device time estimated: each call at the back-to-back
    time of its mode and form on the [16, n, n] batch of the kernel phases
    at their largest n (KEPT["factors"], when they ran first), scaled by
    its modes (a one-plane batch, whose fixed costs do not shrink, is
    underestimated)."""
    from pinocchio_tpu_torch import fmax_ooc
    forms = KEPT.get("factors", {})
    n = max(forms) if forms else None
    est = {}
    for (mode, form, B), calls in tally.items():
        t = forms[n].get((mode, form)) if n else None
        if t is not None:
            est[(mode, form, B)] = calls * t * B * N * N / (
                fmax_ooc.KZ_BATCH * n * n)
    line = (f"  K10 and K14 calls at {N}^3 by mode, form and planes"
            + (f" (device ms estimated from the {n}^3 back-to-back times)"
               if est else "") + ": " + ", ".join(
                f"{mode} {form} [{B}] x{calls}"
                + (f" {est[(mode, form, B)]:.1f} ms"
                   if (mode, form, B) in est else "")
                for (mode, form, B), calls in sorted(tally.items())))
    if est:
        spent = {k: 1e3 * res.timings.get(k, float("nan"))
                 for k in ("fmax_loop", "fold", "lpt_rows")}
        line += (f"; in all {sum(est.values()):.1f} ms against "
                 + ", ".join(f"{k} {v:.1f} ms" for k, v in spent.items()))
    return line


def tables_line(res):
    """When each table's host buffer of an out-of-core run's joined
    streams was allocated and when its last row landed, s after the
    cycle."""
    st = res.pending_fetch.stream
    return "tables allocated / landed, s after the cycle: " + ", ".join(
        f"{k}: {st.allocated.get(k, 0.0):.3f} / {st.landed.get(k, 0.0):.3f}"
        for k in st.keys)


def joined_big(dev, p, cosmo, mesh, over):
    """A second run of the fmax phase at BIG_N, joined at its return,
    beside the first ``over`` (its digest, times and host peak): the same
    needed cells and F, its wall to the join and its host peak."""
    import gc

    import torch
    from pinocchio_tpu_torch import fmax_ooc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with host_peak() as host:
        res = joined_run(fmax_ooc.run_fmax_ooc, p, cosmo, dev, mesh=mesh)
    wall = time.perf_counter() - t0
    sp = res.host_products
    same = digest(sp.ci, sp.F) == over["digest"]
    grew = host.peak - host.start
    t = over["timings"]
    print("  joined at once: phases " + ", ".join(
        f"{k} {v:.3f} s" for k, v in res.timings.items()), flush=True)
    print(f"  joined at once: {wall:.2f} s to the join (last row "
          f"{res.timings['handoff_last']:.3f} s after the cycle; lpt_rows "
          f"{res.timings['lpt_rows']:.3f} s), host peak {grew:.2f} GiB "
          f"above the start; the first run: returned after "
          f"{over['return_s']:.2f} s, last row {t['handoff_last']:.3f} s "
          f"after the cycle, joined after {over['wall_s']:.2f} s, host "
          f"peak {over['host_gib']:.2f} GiB; the same (ci, F): {same}",
          flush=True)
    need(same, "the second run's needed cells or F differ from the first "
         "run's")
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
        one.pending_fetch.join()
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
    res.pending_fetch.join()
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
    with host_peak() as host:
        res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, mesh=mesh, verbose=True,
                                    trace_memory=True)
        t_ret = time.perf_counter() - t0
        res.pending_fetch.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peaks = ooc_peaks(res)
    peak = max(peaks.values())
    sp = res.host_products
    count = len(sp.ci)
    t0 = time.perf_counter()
    dig = digest(sp.ci, sp.F)
    t_dig = time.perf_counter() - t0
    grew = (host.peak - host.start) * GiB
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
    return launches


def host_us(fns, chunks=20, calls=50):
    """The host's time to enqueue one call of each fn of fns, us: for each,
    chunks x calls calls, each chunk's calls back to back with no sync
    between them and timed on the host's clock, the fns' chunks taken in
    turns; the card drained between chunks (untimed), so that no call waits
    for room in the launch queue.  The median over the chunks."""
    import torch
    times = [[] for _ in fns]
    for fn in fns:
        fn()
    for _ in range(chunks):
        for fn, ts in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return [1e6 * statistics.median(ts) / calls for ts in times]


def storage_kernel_phases(N, dev, report):
    """K18 and K19 at N^3 at the shapes of the ooc_bf16 path (big_bf16's at
    BIG_N), bit for bit their plain versions in both 16-bit types: K18
    rounding a Hessian kz batch [6, 16, N, N] into the planes k..k+15 of a
    [6, N, N, Nh, 2] stack (the JSON row), the kz schedule's last batch of
    one plane, and a z-rfft slab [Bx, N, Nh] into a spectrum's x window
    (rows); K19 widening an x-slab [6, Bx, N, Nh, 2] of the stack (the
    row), a spectrum's kz batch [1, 16, N, N] and its one-plane batch; then
    the same at plane 33 (not a multiple of 4: every run 4 bytes past a
    16-byte boundary), over the kz window of the middle shard of three (43
    planes at 256^3: its whole kz schedule stored and loaded, its x-slab
    widened) and rows from that window's column (col0 43 at 256^3).  Each
    form with its time, one call and a call of 20 back to back (one call's
    time holds the host's enqueue, which these short kernels do not hide),
    the plain version's, the one PyTorch call's that does the same work
    (copy_ with the conversion into the window; .to(float32)) one call and
    back to back, its bound (12 bytes a complex value, 8 read and 4
    written or 4 and 8, over 3.35 TB/s), the host's enqueue a call beside
    the library call's (host_us), and for the transposing forms the
    layout's ceiling: the larger of the bound and the time of the stack's
    runs alone, stored or read plainly, a word a thread
    (storage_runs_probe), beside (stores) the time of K18's own runs alone
    (its tile, sector fetch and lanes, with no kz batch to read)."""
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.fmax_ooc import (KZ_BATCH, kz_schedule,
                                              slab_width, split)
    from pinocchio_tpu_torch.ops import storage

    rec = report.setdefault(N, {})
    Nh, B, Bx, M = N // 2 + 1, KZ_BATCH, slab_width(N), N * N
    k, k_odd = min(32, Nh - B), min(33, Nh - B)
    k0, nkz = split(Nh, 3)[1]
    gen = torch.Generator(device=dev).manual_seed(N)

    def values(shape):
        # Gaussian values over some 25 binary orders of magnitude
        x = torch.randn(shape + (2,), device=dev, generator=gen)
        x *= torch.exp(4.0 * torch.randn(shape + (2,), device=dev,
                                         generator=gen))
        return torch.view_as_complex(x)

    def bits(t):
        if t.is_complex():
            return torch.view_as_real(t).view(torch.int32)
        return t.view(torch.int16)

    w, w1, r = values((6, B, N, N)), values((6, 1, N, N)), values((Bx, N, Nh))
    window = kz_schedule(nkz, B)
    batches = {b: values((6, b, N, N)) for _, b in window if b != B}
    batches[B] = w
    def stored(batch, kk, got, want):
        storage.store_kz(batch, got, kk)
        storage.store_kz_plain(batch, want, kk)
        return torch.equal(bits(got), bits(want))

    def loaded(stack, kk, b):
        return torch.equal(bits(storage.load_kz(stack, kk, b)),
                           bits(storage.load_kz_plain(stack, kk, b)))

    def rows(dst_k, dst_p, col0):
        storage.store_rows(r, dst_k, col0)
        storage.store_rows_plain(r, dst_p, col0)
        return torch.equal(bits(dst_k), bits(dst_p))

    def slab(stack):
        return torch.equal(bits(storage.load_rows(stack, Bx, Bx)),
                           bits(storage.load_rows_plain(stack, Bx, Bx)))

    for name in ("float16", "bfloat16"):
        dtype = storage.DTYPES[name]
        sk = torch.zeros((6, N, N, Nh, 2), dtype=dtype, device=dev)
        sp = torch.zeros_like(sk)
        ok = {f"K18 kz batch at plane {k}": stored(w, k, sk, sp),
              f"K18 kz batch at plane {k_odd}": stored(w, k_odd, sk, sp),
              f"K18 one-plane batch at plane {Nh - 1}": stored(
                  w1, Nh - 1, sk, sp),
              "K18 rows": rows(sk[0, :Bx], sp[0, :Bx], 0),
              "K19 x-slab": slab(sp),
              f"K19 kz batch at plane {k}": loaded(sp[:1], k, B),
              f"K19 kz batch at plane {k_odd}": loaded(sp[:1], k_odd, B),
              f"K19 one-plane batch at plane {Nh - 1}": loaded(
                  sp[:1], Nh - 1, 1)}
        wk = torch.zeros((6, N, N, nkz, 2), dtype=dtype, device=dev)
        wp = torch.zeros_like(wk)
        ok[f"K18 the {nkz}-plane window's batches "
           f"{[b for _, b in window]}"] = all(
               stored(batches[b], a, wk, wp) for a, b in window)
        ok[f"K19 the {nkz}-plane window's batches"] = all(
            loaded(wp[:1], a, b) for a, b in window)
        ok[f"K19 the {nkz}-plane window's x-slab"] = slab(wp)
        ok[f"K18 rows from column {k0} into {nkz} planes"] = rows(
            wk[0, :Bx], wp[0, :Bx], k0)
        del wk, wp
        inf = sum(int(torch.isinf(x).sum()) for x in sp)
        print(f"  [{N}^3] {name}: bit for bit the plain versions: "
              + ", ".join(f"{lab} {v}" for lab, v in ok.items())
              + f" ({inf} values rounded to inf)", flush=True)
        need(all(ok.values()), f"K18 or K19 ({name}) at {N}^3 differ from "
             "their plain versions")
        if name != "bfloat16":
            del sk, sp
            torch.cuda.empty_cache()
    spec, half = sp[:1], sp[:, Bx:2 * Bx]
    ck, cp = sk[0, :Bx], sp[0, :Bx]
    probe = kernels.lib().storage_runs_probe

    def runs_ms(stack, load, form):
        return batch_ms(lambda: kernels.check("storage_runs_probe", probe(
            stack.data_ptr(), load, form, stack.shape[0], M, B, Nh, k,
            kernels.stream_ptr(dev))))

    def kz_library(batch, kk):
        view = sp[:, :, :, kk:kk + batch.shape[1]]
        src = torch.view_as_real(batch).permute(0, 2, 3, 1, 4)
        return lambda: view.copy_(src)

    def kz_widen(kk, b):
        view = spec[:, :, :, kk:kk + b].permute(0, 3, 1, 2, 4)
        return lambda: view.to(torch.float32,
                               memory_format=torch.contiguous_format)

    # name, form, kernel, plain, library, complex values, the stack of the
    # runs of 16 planes (None for no such runs)
    forms = [
        ("storage_store", "kz batch [6, 16, N, N]",
         lambda: storage.store_kz(w, sk, k),
         lambda: storage.store_kz_plain(w, sp, k), kz_library(w, k),
         w.numel(), sk),
        ("storage_store", "rows [Bx, N, Nh]",
         lambda: storage.store_rows(r, ck, 0),
         lambda: storage.store_rows_plain(r, cp, 0),
         lambda: cp.copy_(torch.view_as_real(r)), r.numel(), None),
        ("storage_store", "one plane [6, 1, N, N]",
         lambda: storage.store_kz(w1, sk, Nh - 1),
         lambda: storage.store_kz_plain(w1, sp, Nh - 1),
         kz_library(w1, Nh - 1), w1.numel(), None),
        ("storage_load", "x-slab [6, Bx, N, Nh]",
         lambda: storage.load_rows(sk, Bx, Bx),
         lambda: storage.load_rows_plain(sk, Bx, Bx),
         lambda: half.to(torch.float32), half.numel() // 2, None),
        ("storage_load", "kz batch [1, 16, N, N]",
         lambda: storage.load_kz(spec, k, B),
         lambda: storage.load_kz_plain(spec, k, B), kz_widen(k, B), B * M,
         spec),
        ("storage_load", "one plane [1, 1, N, N]",
         lambda: storage.load_kz(spec, Nh - 1, 1),
         lambda: storage.load_kz_plain(spec, Nh - 1, 1), kz_widen(Nh - 1, 1),
         M, None),
    ]
    out = {}
    for name, form, fn, plain, library, nelem, runs in forms:
        host, host_lib = host_us((fn, library))
        t = dict(nelem=nelem, ms=time_ms(fn), batch_ms=batch_ms(fn),
                 plain_ms=time_ms(plain), library_ms=time_ms(library),
                 library_batch_ms=batch_ms(library),
                 bound_ms=bound(name, 12.0 * nelem, nelem)[0],
                 host_us=host, library_host_us=host_lib)
        line = ""
        if runs is not None:
            load = name == "storage_load"
            t["runs_ms"] = runs_ms(runs, int(load), 0)
            t["ceiling_ms"] = max(t["runs_ms"], t["bound_ms"])
            line = (f"; the layout's ceiling {t['ceiling_ms']:.3f} ms (the "
                    f"runs alone, {'read' if load else 'stored'} a word a "
                    f"thread, back to back {t['runs_ms']:.3f} ms; back to "
                    f"back {t['batch_ms'] / t['ceiling_ms']:.2f}x it)")
            if not load:
                t["own_runs_ms"] = runs_ms(runs, 0, 1)
                line += (f"; K18's own runs alone {t['own_runs_ms']:.3f} "
                         f"ms (back to back "
                         f"{t['batch_ms'] / t['own_runs_ms']:.2f}x them)")
        print(f"  [{N}^3] {'K18' if name == 'storage_store' else 'K19'} "
              f"{form}: one call {t['ms']:.3f} ms, back to back "
              f"{t['batch_ms']:.3f}; library {t['library_ms']:.3f}, back to "
              f"back {t['library_batch_ms']:.3f}; plain {t['plain_ms']:.3f};"
              f" bound {t['bound_ms']:.4f} ms (bytes; back to back "
              f"{t['batch_ms'] / t['bound_ms']:.2f}x){line}; host "
              f"{t['host_us']:.1f} us a call, library "
              f"{t['library_host_us']:.1f} us", flush=True)
        out[f"{name} {form}"] = t
    for name, form in (("storage_store", "kz batch [6, 16, N, N]"),
                       ("storage_load", "x-slab [6, Bx, N, Nh]")):
        t = out[f"{name} {form}"]
        record_phase(rec, N, name, 0.0, 0.0, t["ms"], t["plain_ms"],
                     12.0 * t["nelem"], t["nelem"],
                     library_ms=t["library_ms"], extra=f"bit for bit, {form}"
                     f" (back to back {t['batch_ms']:.3f} ms a call), ")
        rec[name]["forms"] = {f: v for f, v in out.items()
                              if f.startswith(name)}
    KEPT.setdefault("storage16", {}).setdefault("kernels", {})[N] = out
    del sk, sp, w, w1, r, batches, half, spec, ck, cp, forms
    torch.cuda.empty_cache()


def fmax_stats(what, F, F32, Flast):
    """|dF| of a 16-bit run's Fmax against the float32 run's on the same
    delta: the median, the share above 0.01, the share of cells whose
    F >= Flast changed; printed and returned."""
    import numpy as np
    d = np.abs(F - F32)
    st = dict(median_dF=float(np.median(d)),
              above_0_01=float((d > 0.01).mean()),
              flips=float(((F >= Flast) != (F32 >= Flast)).mean()),
              max_dF=float(d.max()))
    print(f"  {what} Fmax against float32: median |dF| "
          f"{st['median_dF']:.3e}, |dF| > 0.01 on {100 * st['above_0_01']:.3f}"
          f"% of cells, F >= Flast changed on {100 * st['flips']:.4f}%, max "
          f"{st['max_dF']:.3e} (at 32^3 on the CPU, tests/test_torch_ooc_"
          "bf16.py: the JAX package's bfloat16 run against its float32 run "
          "2.04e-3, 2.81 %)",
          flush=True)
    need(np.all(np.isfinite(F)) and st["median_dF"] < 1e-2,
         f"{what}: Fmax far from the float32 run's")
    return st


def ooc16_checks(dev, p, res, wall):
    """The ooc_bf16 path's run against the ooc path's float32 run of the
    same delta (run first if this process has not): Fmax statistics, the
    needed count within 1e-3 N^3, the halo counts per output within
    max(10, 6 sqrt(n) + 5 % n) (the JAX package's tolerance,
    tests/test_ooc.py); then the fmax phase alone with its peaks traced,
    each phase beside the planner's 16-bit map."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax_ooc, planner
    if "ooc" not in KEPT:
        run_path(dev, "ooc")
    F32, _, sp32, cats32 = KEPT["ooc"]
    F, _, sp = KEPT["ooc_bf16"]
    N = p.GridSize
    st = fmax_stats("ooc_bf16", F, F32, p.Flast)
    dn = len(sp.ci) - len(sp32.ci)
    print(f"  needed cells {len(sp.ci)}, float32 {len(sp32.ci)} (difference "
          f"{dn}, need <= {1e-3 * N ** 3:.0f})", flush=True)
    need(abs(dn) <= 1e-3 * N ** 3, "ooc_bf16: the needed count moved")
    halos = []
    for got, want in zip(res["frag"].catalogs, cats32):
        ng = int((got.mass >= p.MinHaloMass).sum())
        nw = int((want.mass >= p.MinHaloMass).sum())
        tol = max(10, 6 * nw ** 0.5 + 0.05 * nw)
        print(f"  ooc_bf16 z={got.z:g}: {ng} halos, float32 ooc path {nw} "
              f"(need within {tol:.0f})", flush=True)
        need(nw > 0 and abs(ng - nw) <= tol,
             f"ooc_bf16: the halo count at z={got.z} is off the float32 "
             "run's")
        halos.append((ng, nw))
    cosmo = res["cosmo"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = fmax_ooc.run_fmax_ooc(p, cosmo, dev, trace_memory=True)
    one.pending_fetch.join()
    t_fmax = time.perf_counter() - t0
    same = np.array_equal(one.products.Fmax.cpu().numpy(), F)
    po = planner.device_peak(p, True, frac=planner.collapsed_fraction(
        p, cosmo))
    peaks = ooc_peaks(one)
    print(f"  the fmax phase alone {t_fmax:.2f} s (Fmax equal to the path's:"
          f" {same}), peak {max(peaks.values()) / GiB:.3f} GiB, planner "
          f"{po['peak'] / GiB:.3f} GiB ({po['phase']}):\n"
          + _phase_table(peaks, po["phases"]), flush=True)
    need(same, "ooc_bf16: the fmax phase alone gave another Fmax")
    KEPT.setdefault("storage16", {})["path"] = dict(
        wall_s=wall, fmax_s=t_fmax, halos=halos, needed=len(sp.ci),
        needed_f32=len(sp32.ci), peaks_gib={k: v / GiB
                                            for k, v in peaks.items()},
        planner_gib={k: sum(v.values()) / GiB
                     for k, v in po["phases"].items()}, **st)
    del one


def ooc_f16_phase(dev):
    """The fmax phase alone at OOC_F16_N^3 with float16 storage against a
    float32 run of the same delta, with the launch counts set to 0 just
    before the float16 run: Fmax statistics, the needed count within
    1e-3 N^3, finite v1 rows (the rows of each field with a value that
    overflowed are counted); the launch set OOC16.  Returns the
    launches."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax_ooc, kernels
    from pinocchio_tpu_torch.cosmology import Cosmology

    N = OOC_F16_N
    p32 = params_for(N, ooc="on")
    p16 = params_for(N, ooc="on", ooc_dtype="float16")
    cosmo = Cosmology(p32)
    r32 = joined_run(fmax_ooc.run_fmax_ooc, p32, cosmo, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    r16 = joined_run(fmax_ooc.run_fmax_ooc, p16, cosmo, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    st = fmax_stats("ooc_f16", r16.products.Fmax.cpu().numpy(),
                    r32.products.Fmax.cpu().numpy(), p16.Flast)
    sp, sp32 = r16.host_products, r32.host_products
    dn = len(sp.ci) - len(sp32.ci)
    print(f"  float16 fmax {wall:.2f} s; needed cells {len(sp.ci)}, float32 "
          f"{len(sp32.ci)}; launches: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    need(abs(dn) <= 1e-3 * N ** 3, "ooc_f16: the needed count moved")
    # the source spectra are unnormalized forward transforms: in float16
    # they overflow to inf as the JAX engine's do (no clamp), and so do the
    # rows built from them; v1 comes from delta's planes
    bad = {k: int((~np.isfinite(v)).any(axis=1).sum())
           for k, v in sp.vel.items()}
    print(f"  rows with a non-finite value per field: {bad}", flush=True)
    need(bad["v1"] == 0, "ooc_f16: non-finite v1 rows")
    missing = sorted(k for k in OOC16 if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in OOC16)
    need(not missing and not stray, f"ooc_f16: not launched {missing}, "
         f"launched from another path {stray}")
    KEPT.setdefault("storage16", {})["f16"] = dict(wall_s=wall,
                                                   nonfinite_rows=bad, **st)
    del r16, r32
    torch.cuda.empty_cache()
    return launches


def ooc_mesh16_phase(dev):
    """The fmax phase alone at PIPELINE_N with bfloat16 storage over
    OOC_MESH16 shards of the card, with the launch counts set to 0 just
    before it: bit for bit the ooc_bf16 path's single-device products
    (run first if this process has not), its phases' peaks beside the
    planner's per-device map; the launch set OOC16.  Returns the
    launches."""
    import torch
    from pinocchio_tpu_torch import fmax_ooc, kernels, planner
    from pinocchio_tpu_torch.cosmology import Cosmology

    if "ooc_bf16" not in KEPT:
        run_path(dev, "ooc_bf16")
    p = params_for(PIPELINE_N, ooc="on", ooc_dtype="bfloat16")
    cosmo = Cosmology(p)
    mesh = card_mesh(dev, "slab", (OOC_MESH16,))
    rep = planner.plan(p, dev, cosmo, shards=OOC_MESH16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, mesh=mesh, trace_memory=True)
    res.pending_fetch.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peaks = ooc_peaks(res)
    print(f"  {OOC_MESH16} shards of the card, bfloat16: fmax {wall:.2f} s; "
          f"peak {max(peaks.values()) / GiB:.3f} GiB, planner "
          f"{rep['ooc']['peak'] / GiB:.3f} GiB ({rep['ooc']['phase']}):\n"
          + _phase_table(peaks, rep["ooc"]["phases"]), flush=True)
    exact = ooc_held_to_one_device(
        "ooc_mesh_bf16", (res.products.gather()[0],
                          res.smoothing.true_variance, res.host_products),
        KEPT["ooc_bf16"])
    need(exact, "ooc_mesh_bf16: not bit for bit the single-device run")
    KEPT["ooc_mesh_bf16"] = products_digest(
        res.products.gather()[0], res.smoothing.true_variance, res.pdf_hist,
        res.host_products)
    print(f"  launches: { {k: v for k, v in launches.items() if v} }; "
          "SHA-256 of the products: " + ", ".join(
              f"{k} {v[:16]}" for k, v in KEPT["ooc_mesh_bf16"].items()),
          flush=True)
    missing = sorted(k for k in OOC16 if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in OOC16)
    need(not missing and not stray, f"ooc_mesh_bf16: not launched {missing},"
         f" launched from another path {stray}")
    KEPT.setdefault("storage16", {})["mesh"] = dict(
        wall_s=wall, bit_equal=exact, peak_gib=max(peaks.values()) / GiB,
        planner_gib=rep["ooc"]["peak"] / GiB)
    del res
    torch.cuda.empty_cache()
    return launches


# K18's and K19's wrappers (ops/storage.py): the shape each call moves
STORAGE_SHAPES = {
    "store_kz": lambda batch, stack, k: tuple(batch.shape),
    "store_rows": lambda src, dst, col0: tuple(dst.shape[:-1]),
    "load_kz": lambda stack, k, B: (stack.shape[0], B)
    + tuple(stack.shape[1:3]),
    "load_rows": lambda src, x0, Bx: (src.shape[0], Bx)
    + tuple(src.shape[2:-1])}


def storage_tallied(run):
    """run() with K18's and K19's wrappers tallied by form and shape:
    returns (its result, {(form, shape): calls})."""
    import threading

    from pinocchio_tpu_torch.ops import storage
    tally, lock, saved = {}, threading.Lock(), {}

    def counted(form, fn):
        def call(*a):
            key = (form, STORAGE_SHAPES[form](*a))
            with lock:
                tally[key] = tally.get(key, 0) + 1
            return fn(*a)
        return call

    for form in STORAGE_SHAPES:
        saved[form] = getattr(storage, form)
        setattr(storage, form, counted(form, saved[form]))
    try:
        out = run()
    finally:
        for form, fn in saved.items():
            setattr(storage, form, fn)
    return out, tally


def storage_estimate(tally, forms):
    """K18's and K19's device time in a run, estimated, ms: each tallied
    call at the back-to-back time of the storage phase's form of its kind
    (forms: KEPT["storage16"]["kernels"][N]), scaled by its complex
    values; {(form, shape): (calls, ms)}."""
    def measured(form, shape):
        if form == "store_kz":
            return forms["storage_store kz batch [6, 16, N, N]" if shape[1] > 1
                         else "storage_store one plane [6, 1, N, N]"]
        if form == "store_rows":
            return forms["storage_store rows [Bx, N, Nh]"]
        if form == "load_rows":
            return forms["storage_load x-slab [6, Bx, N, Nh]"]
        return forms["storage_load kz batch [1, 16, N, N]" if shape[1] > 1
                     else "storage_load one plane [1, 1, N, N]"]
    out = {}
    for (form, shape), n in tally.items():
        t = measured(form, shape)
        out[(form, shape)] = (n, n * t["batch_ms"] * math.prod(shape)
                              / t["nelem"])
    return out


def big16(dev):
    """The fmax phase at BIG_N with bfloat16 storage (ooc='on'): each
    phase's peak beside the planner's 16-bit map, the overall peak within
    5 % of the planner's (the needed sort), the wall and the needed count
    beside the float32 big run's (ooc_fmax_phase at BIG_N, when it ran
    first; within 1e-3 N^3); the launch set OOC16; K18's and K19's calls
    by form and shape (storage_tallied), and their device time estimated
    from the storage phase's times at BIG_N when it ran first
    (storage_estimate)."""
    import gc

    import numpy as np
    import torch
    from pinocchio_tpu_torch import fmax_ooc, kernels, planner
    from pinocchio_tpu_torch.cosmology import Cosmology

    p = params_for(BIG_N, ooc="on", ooc_dtype="bfloat16")
    cosmo = Cosmology(p)
    rep = planner.plan(p, dev, cosmo)
    print(planner.format_memory_map(rep), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launches()

    def run():
        t0 = time.perf_counter()
        res = fmax_ooc.run_fmax_ooc(p, cosmo, dev, verbose=True,
                                    trace_memory=True)
        t_ret = time.perf_counter() - t0
        res.pending_fetch.join()
        return res, t_ret, time.perf_counter() - t0

    with host_peak() as host:
        (res, t_ret, wall), tally = storage_tallied(run)
    launches = dict(kernels.LAUNCHES)
    peaks = ooc_peaks(res)
    peak, pred = max(peaks.values()), rep["device_bytes"]
    sp = res.host_products
    count = len(sp.ci)
    f32 = KEPT.get("big_classic")
    forms = KEPT.get("storage16", {}).get("kernels", {}).get(BIG_N)
    est = storage_estimate(tally, forms) if forms else {}
    line = "  K18 and K19 calls by form and shape"
    if est:
        line += " (device ms estimated at the storage phase's back-to-back "
        line += "times)"
    line += ": " + ", ".join(
        f"{form} {list(shape)} x{n}"
        + (f" {est[(form, shape)][1]:.1f} ms" if est else "")
        for (form, shape), n in sorted(tally.items()))
    if est:
        ms = {kind: sum(v[1] for (form, _), v in est.items()
                        if form.startswith(kind)) for kind in ("store", "load")}
        line += (f"; in all K18 {ms['store']:.1f} ms and K19 "
                 f"{ms['load']:.1f} ms against fmax_loop "
                 f"{1e3 * res.timings.get('fmax_loop', float('nan')):.1f} ms")
    print(line, flush=True)
    print(f"  {BIG_N}^3 bfloat16 out-of-core fmax: {wall:.2f} s wall "
          f"(returned after {t_ret:.2f} s)"
          + (f", float32 {f32['wall_s']:.2f} s" if f32 else "")
          + "; phases: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res.timings.items()),
          flush=True)
    print(f"  peak device memory {peak / GiB:.3f} GiB, planner "
          f"{pred / GiB:.3f} GiB ({rep['ooc']['phase']}; measured/predicted "
          f"{peak / pred:.3f}, need within 5 %)"
          + (f"; float32 {f32['peak_gib']:.3f} GiB" if f32 else "") + ":\n"
          + _phase_table(peaks, rep["ooc"]["phases"]), flush=True)
    print(f"  needed cells {count}"
          + (f", float32 {f32['count']} (difference {count - f32['count']},"
             f" need <= {1e-3 * BIG_N ** 3:.0f})" if f32 else "")
          + f"; host peak {(host.peak - host.start):.2f} GiB above the "
          f"start; launches: { {k: v for k, v in launches.items() if v} }",
          flush=True)
    need(abs(peak / pred - 1.0) <= 0.05, "big_bf16: the peak is not within "
         "5 % of the planner's")
    need(f32 is None or abs(count - f32["count"]) <= 1e-3 * BIG_N ** 3,
         "big_bf16: the needed count moved from the float32 run's")
    need(all(np.all(np.isfinite(v[::997])) for v in sp.vel.values()),
         "big_bf16: non-finite products")
    missing = sorted(k for k in OOC16 if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in OOC16)
    need(not missing and not stray, f"big_bf16: not launched {missing}, "
         f"launched from another path {stray}")
    KEPT.setdefault("storage16", {})["big"] = dict(
        wall_s=wall, return_s=t_ret, peak_gib=peak / GiB,
        planner_gib=pred / GiB, count=count,
        count_f32=None if f32 is None else f32["count"],
        peaks_gib={k: v / GiB for k, v in peaks.items()},
        timings=res.timings,
        storage_calls={f"{form} {list(shape)}": n
                       for (form, shape), n in tally.items()},
        storage_estimate_ms={f"{form} {list(shape)}": v[1]
                             for (form, shape), v in est.items()})
    del res, sp
    gc.collect()
    torch.cuda.empty_cache()


def planner_cli(dev):
    """The planner's CLI (the main of python -m pinocchio_tpu_torch.planner,
    in this process: a fresh process spends seconds before it reaches the
    card) on a BIG_N parameter file with bfloat16 storage, reading the
    card's memory (no --device-gb): the map against the card's total
    memory, the out-of-core engine chosen, and the storage estimate."""
    import contextlib
    import io
    import torch
    from pinocchio_tpu_torch import planner
    pf = write_parameter_file(scratch_dir("planner_cli"), BIG_N)
    buf, code = io.StringIO(), 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            planner.main([pf, "--norad", "--ooc-dtype", "bfloat16"])
    except SystemExit as e:
        code = e.code or 0
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, flush=True)
    need(code == 0, f"the planner's CLI exited with {code}")
    card = torch.cuda.get_device_properties(dev).total_memory / GiB
    need(f"of {card:.2f} GiB (OK)" in out and "out-of-core engine" in out
         and "ESTIMATED STORAGE REQUIREMENTS" in out,
         "the planner's CLI did not plan the card's memory")
    print(f"  the planner's CLI read the card's {card:.2f} GiB in {wall:.2f} "
          "s", flush=True)


def fits_phase(dev):
    """scripts/torch_pinocchio2fits.py on the classic path's catalogs and
    histories (run first if this process has not), each read back and
    checked column by column, then scripts/torch_validate_fits.py over the
    directory; both in this process, which holds no module of jax."""
    import contextlib
    import io
    import runpy
    if "classic_out" not in KEPT:
        run_path(dev, "classic")
    d = KEPT["classic_out"]
    pf = write_parameter_file(d, PIPELINE_N)
    files = sorted(os.path.join(d, f) for f in os.listdir(d)
                   if f.endswith((".catalog.out", ".histories.out")))
    need(len(files) == len(OUTPUT_Z) + 1, f"fits: the classic path's files "
         f"{files}")
    codes = []
    for name, argv in (("torch_pinocchio2fits.py",
                        files + ["--outdir", d, "--paramfile", pf]),
                       ("torch_validate_fits.py", [pf, "--dir", d])):
        buf = io.StringIO()
        old = sys.argv
        sys.argv = [name] + argv
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(HERE, "scripts", name),
                               run_name="__main__")
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code or 0)
        finally:
            sys.argv = old
        print(buf.getvalue().rstrip(), flush=True)
        print(f"  {name}: exit {codes[-1]} in {time.perf_counter() - t0:.2f} "
              "s", flush=True)
        out = buf.getvalue()
    need(codes == [0, 0] and "validation finished with 0 error(s)" in out,
         "fits: the classic path's files did not convert and validate")


# the reference's HMF Average Residual (HMF_Validation/VALIDATION_log.txt:
# 27-29), which the scripts phase prints beside the classic path's
HMF_REFERENCE_RESIDUAL = 0.206


def scripts_phase(dev):
    """The user scripts' twins on the classic path's files at PIPELINE_N
    (run first if this process has not): scripts/torch_hmf_validation.py's
    validate_run (its VALIDATION_log.txt, one residual per output, printed
    beside the reference's; no reference files, so no count compared and no
    figure) and scripts/torch_plot_example.py (mf.png and lss.png must
    exist; the path has no PLC) where matplotlib is installed; both in this
    process."""
    import contextlib
    import importlib.util
    import io
    if "classic_out" not in KEPT:
        run_path(dev, "classic")
    d = KEPT["classic_out"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = script_module("torch_hmf_validation").validate_run(
            d, params_for(PIPELINE_N))
    print(buf.getvalue().rstrip(), flush=True)
    with open(os.path.join(d, "VALIDATION_log.txt")) as fd:
        logged = fd.read().splitlines()
    need(len(rows) == len(OUTPUT_Z) == len(logged)
         and all(math.isfinite(r[1]) for r in rows)
         and "plotting skipped" in buf.getvalue(),
         f"scripts: the HMF validation of the classic path: {rows}")
    print(f"  scripts/torch_hmf_validation.py: z=0 HMF Average Residual "
          f"(mean |n/n_fit - 1| over the bins with halos) {rows[-1][1]:.4f}, "
          f"the reference's {HMF_REFERENCE_RESIDUAL}", flush=True)
    if importlib.util.find_spec("matplotlib") is None:
        # the plot twin draws with matplotlib, which the CPU tests run
        # (tests/test_torch_scripts.py); a machine without it cannot plot
        print("  scripts/torch_plot_example.py: not run, matplotlib is not "
              "installed here", flush=True)
        return
    pf = write_parameter_file(d, PIPELINE_N)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = script_module("torch_plot_example").main([pf, "--outdir", d])
    pngs = {f: os.path.getsize(os.path.join(d, f))
            for f in ("mf.png", "lss.png") if os.path.exists(
                os.path.join(d, f))}
    print(f"  scripts/torch_plot_example.py: exit {code}, "
          f"{buf.getvalue().strip()!r}, {pngs} bytes", flush=True)
    need(code == 0 and len(pngs) == 2 and all(pngs.values()),
         "scripts: the plot twin did not write mf.png and lss.png")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (kernels, "
                    "density_field, a path's name, mesh_fmax, "
                    "mesh_c2r, ooc_mesh_fmax or one of its names, "
                    "hosts_exchange, "
                    "hosts, procs, ooc_procs, ooc_procs_bf16, modes, "
                    "subbox_turns, reference:<path>, "
                    "ooc_dense:<name>, ooc_fmax, big, ooc_mesh_big, "
                    "refusal, handoff, storage_kernels, grid_fft, "
                    "ooc_f16, "
                    "ooc_mesh_bf16, big_bf16, planner_cli, fits, "
                    "scripts); no JSON line is printed")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    t_main = time.perf_counter()

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
            if wanted("kernels") or wanted("storage_kernels"):
                section(f"the 16-bit storage kernels K18, K19 at {N}^3:")
                storage_kernel_phases(N, dev, report)
        if wanted("kernels") or wanted("storage_kernels"):
            section(f"the 16-bit storage kernels K18, K19 at big_bf16's "
                    f"{BIG_N}^3 shapes:")
            storage_kernel_phases(BIG_N, dev, report)
        if wanted("kernels"):
            c2r_check(dev)
        if wanted("grid_fft"):
            section("the dense engine's grid transforms at 512^3:")
            grid_fft_phase(dev, report)
        paths = {}
        for path in PATHS:
            if wanted(path):
                section(f"{path} path at {PATHS[path][0]}^3:")
                t0 = time.perf_counter()
                paths[path] = run_path(dev, path)[0]
                print(f"  the {path} phase took "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
        if wanted("handoff"):
            section(f"the hand-off read through its views against joined "
                    f"runs at {PIPELINE_N}^3 and {HANDOFF_N}^3:")
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
        if wanted("ooc_f16"):
            section(f"out-of-core fmax with float16 storage at "
                    f"{OOC_F16_N}^3:")
            paths["ooc_f16"] = ooc_f16_phase(dev)
        if wanted("ooc_mesh_bf16"):
            section(f"out-of-core fmax with bfloat16 storage over "
                    f"{OOC_MESH16} shards of the card at {PIPELINE_N}^3:")
            paths["ooc_mesh_bf16"] = ooc_mesh16_phase(dev)
        if wanted("hosts_exchange"):
            section(f"the exchange over a 2x2 pencil mesh of the card at "
                    f"{HOSTS_N}^3, mocked hosts:")
            paths["hosts_exchange"] = hosts_exchange(dev)
        if wanted("hosts"):
            section(f"hosts path at {HOSTS_N}^3: {HOSTS} mocked hosts "
                    f"over a 2x2 pencil mesh of the card, {CORES} sub-boxes:")
            paths["hosts"] = hosts_path(dev)
        which = {k for k in ("ooc_procs", "procs", "ooc_procs_bf16")
                 if wanted(k)}
        if which:
            section(f"the hosts as {HOSTS} processes of the CLI on the card "
                    f"({', '.join(sorted(which))}): the out-of-core engine "
                    f"over 4 shards at {PIPELINE_N}^3 with its dump, the "
                    f"dense one over a 2x2 pencil mesh at {HOSTS_N}^3 "
                    f"single-turn and {PROCS_TWO_TURN_N}^3 two-turn, the "
                    f"out-of-core fmax with bfloat16 storage over "
                    f"{OOC_MESH16} shards at {PIPELINE_N}^3:")
            paths["ooc_procs"] = processes_phase(dev, which)
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
                t0 = time.perf_counter()
                if path == "hosts":
                    hosts_reference_check(dev)
                else:
                    reference_check(dev, path)
                print(f"  the reference:{path} phase took "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
        for name in OOC_CHECKS:
            if wanted(f"ooc_dense:{name}"):
                section(f"out-of-core against dense at "
                        f"{OOC_CHECKS[name][0]}^3, "
                        f"{name}:")
                t0 = time.perf_counter()
                ooc_dense_check(dev, name)
                print(f"  the ooc_dense:{name} phase took "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
        if wanted("ooc_fmax"):
            section(f"out-of-core fmax phase at {OOC_N}^3, phase by phase:")
            ooc_fmax_phase(dev, OOC_N, "on", {}, OOC)
        if wanted("big"):
            for name, (bN, ooc, kw, own) in BIG.items():
                section(f"fmax phase at {bN}^3 under ooc={ooc!r}, {name}:")
                ooc_fmax_phase(dev, bN, ooc, kw, own)
        if wanted("big_bf16"):
            section(f"fmax phase at {BIG_N}^3 with bfloat16 storage:")
            big16(dev)
        if wanted("ooc_mesh_big"):
            section(f"fmax phase at {BIG_N}^3 under ooc='auto' over "
                    f"{OOC_MESH_BIG} shards of the card, classic:")
            paths["ooc_mesh_big"] = ooc_mesh_big(dev)
        if wanted("refusal"):
            section(f"the planner at {BIG_N}^3 with f(R) growth and "
                    "RECOMPUTE:")
            big_refusal(dev)
        if wanted("planner_cli"):
            section(f"the planner's CLI at {BIG_N}^3 on the card's memory:")
            planner_cli(dev)
        if wanted("fits"):
            section("the classic path's outputs to FITS, validated:")
            fits_phase(dev)
        if wanted("scripts"):
            section("the user scripts' twins on the classic path's outputs:")
            t0 = time.perf_counter()
            scripts_phase(dev)
            print(f"  the scripts phase took {time.perf_counter() - t0:.2f} "
                  "s", flush=True)
        jaxish = sorted(m for m in sys.modules if m == "jax"
                        or m.startswith("jax.") or m == "pinocchio_tpu"
                        or m.startswith("pinocchio_tpu."))
        need(not jaxish, f"modules of jax or the JAX package imported: "
             f"{jaxish[:5]}")
        section("no module of jax or of the JAX package was imported; done")
        print(f"chip_smoke.py: {time.perf_counter() - t_main:.1f} s of "
              "script, the builds included", flush=True)
    except CheckFailed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if "scratch" in KEPT:
            import shutil
            shutil.rmtree(KEPT.pop("scratch"), ignore_errors=True)
    if only is not None:
        return 0

    # each kernel's launches: on the first path (in PATHS order) that owns
    # it; the shared kernels on the main path
    rows = []
    owners = {nm: own for nm, (_, _, own) in PATHS.items()}
    owners.update({nm: v[3] for nm, v in MESH_FMAX.items()})
    owners.update(hosts=HOSTS_LAUNCH, hosts_exchange=TWO_TURN_LAUNCH)
    for kname, (source, replaces) in kernels.KERNELS.items():
        owner = next(nm for nm, own in owners.items() if kname in own)
        r = report[PIPELINE_N][kname]
        big = report[max(KERNEL_SIZES)][kname]
        rows.append(dict(name=kname, source=source,
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
                                              "pair_bound_ms", "first_ms",
                                              "batch_ms", "host_ms",
                                              "one_plane", "plan_ms",
                                              "forms")
                            if k in r}))
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
                                    exchange=KEPT.get("hosts_exchange"),
                                    procs=KEPT.get("procs"),
                                    ooc_procs=KEPT.get("ooc_procs")),
                      "handoff": dict(KEPT.get("handoff", {}),
                                      big=KEPT.get("big_classic", {}).get(
                                          "joined")),
                      "storage16": KEPT.get("storage16")}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
