#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pinocchio_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. needs a CUDA device (exits non-zero without one) and prints the card's
   name and power limit;
2. builds the CUDA kernels from csrc/ with nvcc (one process per source, in
   parallel) and prints the build time;
3. runs every kernel at 256^3 and 512^3 on the card, holds each against its
   plain PyTorch version on the same inputs, with the tolerance printed, and
   times both (median of 5, CUDA events);
4. drives each path through run_pipeline, with the launch counters reset
   just before it and read just after, and checks its outputs (catalogs and
   mass functions at 4 redshifts with halos, FmaxPDF, histories, the
   cosmology table), its own launch set (every kernel of the path launched,
   none of another path's) and that no jax was imported:
     classic     the main path: classic ellipsoid, 256^3, 1 Mpc/h cells;
     tabulated   TABULATED_CT with the bicubic lookup, 256^3;
     scaledep    f(R) scale-dependent growth with RECOMPUTE_DISPLACEMENTS,
                 256^3;
     tabulated_trilinear, tabulated_bilinear   the other two lookups, 128^3;
5. runs the classic path at 48^3 and the tabulated and scaledep paths at
   64^3 on the card and on the CPU (the plain versions) and holds the halo
   catalogs to each other;
6. prints one JSON line of the kernels, then {"ok": true, "device": ...}
   as the last line.  Any failed check exits non-zero before that.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SIZES = (256, 512)
PIPELINE_N = 256
OUTPUT_Z = [2.0, 1.0, 0.5, 0.0]
REPS = 5
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
# the kernels every path launches, then each path's own
COMMON = {"ic_kdensity", "kspace_hessian", "lpt_sources_pointwise",
          "lpt_src32_accumulate", "gather_rows", "pdf_hist"}
# name -> (grid size, Params switches, kernels of the path besides COMMON)
PATHS = {
    "classic": (PIPELINE_N, {}, {"collapse_update", "kspace_gradient"}),
    "tabulated": (PIPELINE_N, dict(ell_model="tabulated",
                                   ct_interp="bicubic"),
                  {"collapse_update_table_bicubic", "kspace_gradient"}),
    "scaledep": (PIPELINE_N, FR, {"collapse_update", "kspace_gradient_tab"}),
    "tabulated_trilinear": (128, dict(ell_model="tabulated",
                                      ct_interp="trilinear"),
                            {"collapse_update_table_trilinear",
                             "kspace_gradient"}),
    "tabulated_bilinear": (128, dict(ell_model="tabulated",
                                     ct_interp="bilinear"),
                           {"collapse_update_table_bilinear",
                            "kspace_gradient"}),
}
# card-vs-CPU checks: path -> grid size
REFERENCE = {"classic": 48, "tabulated": 64, "scaledep": 64}


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


def params_for(N, **kw):
    from pinocchio_tpu.config import Params
    return Params(GridSize=N, BoxSize=float(N), output_z=list(OUTPUT_Z),
                  norad=True, plc_enabled=False, **kw)


def kernel_phases(N, dev, report):
    """Every kernel at N^3 against its plain version; fills report[name]
    with max_abs_err, ms and plain_ms of this size."""
    import numpy as np
    import torch
    from pinocchio_tpu.cosmology import Cosmology
    from pinocchio_tpu_torch import fmax, ic
    from pinocchio_tpu_torch.grids import Grid, irfft3, rfft3
    from pinocchio_tpu_torch.ops import (collapse, compact, derivatives, lpt,
                                         tabulated)

    p = params_for(N)
    cosmo = Cosmology(p)
    grid = Grid(N, p.BoxSize_htrue)
    sm = fmax.Smoothing.build(p, cosmo)
    rec = {}

    def phase(name, err, tol, ms, plain_ms, extra=""):
        ok = err <= tol
        print(f"  [{N}^3] {name:<22s} max_abs_err {err:.3e} "
              f"(tolerance {tol:.3e}) {extra}kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms -> {'ok' if ok else 'FAIL'}",
              flush=True)
        need(ok, f"{name} at {N}^3 disagrees with its plain version")
        rec[name] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms)

    # ---- K1: initial conditions.  delta must equal the plain version's
    # bit for bit, which needs bit-identical phase and amplitude draws ----
    kp, ka = ic.split(ic.prng_key(p.RandomSeed))
    logk, logpk = ic.pk_table(cosmo, grid)
    logk, logpk = torch.from_numpy(logk).to(dev), torch.from_numpy(logpk).to(dev)
    logkf = float(np.float32(math.log10(2.0 * math.pi / grid.BoxSize)))
    fac = float(np.float32(grid.BoxSize ** -1.5 * float(N) ** 3))
    args = (N, logk, logpk, kp, ka, logkf, fac, False, False)
    delta = ic.kdensity(*args)
    ref = ic.kdensity_plain(*args)
    err = (delta - ref).abs().max().item()
    need(torch.equal(torch.view_as_real(delta), torch.view_as_real(ref)),
         f"ic_kdensity at {N}^3 is not identical to its plain version")
    phase("ic_kdensity", err, 1e-5 * ref.abs().max().item(),
          time_ms(lambda: ic.kdensity(*args)),
          time_ms(lambda: ic.kdensity_plain(*args)),
          extra="identical, ")
    del ref

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
                      delta, R, N)), extra=f"R={R:g} ")
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
          time_ms(lambda: derivatives.gradient_kspace_plain(delta, D1, N)))
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
    print(f"  [{N}^3] collapse_update: F equal on {100 * exact:.4f}%, "
          f"within 1e-4*max(1,|F|) on "
          f"{100 * okF:.4f}% (need >= 99.99%), Rmax equal on "
          f"{100 * okR:.4f}% (need >= 99.9%), mean delta^2 rel err "
          f"{rel:.2e} (need <= 1e-5)", flush=True)
    need(okF >= 0.9999 and okR >= 0.999 and rel <= 1e-5,
         f"collapse_update at {N}^3 disagrees with its plain version")
    Ft, Rt = F0.clone(), R0.clone()
    ms = time_ms(lambda: collapse.collapse_update(sd, Ft, Rt, 1, pack))
    Ft, Rt = F0.clone(), R0.clone()
    plain_ms = time_ms(lambda: collapse.collapse_update_plain(
        sd, Ft, Rt, 1, pack))
    phase("collapse_update", dF.max().item(), math.inf, ms, plain_ms,
          extra="(F, fraction criteria above) ")
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
        print(f"  [{N}^3] {name}: F equal on {100 * exact:.4f}% (need >= "
              f"99.99%), within 1e-4*max(1,|F|) on {100 * okF.item():.4f}% "
              f"(need 100%), Rmax equal on {100 * okR:.4f}% (need >= "
              f"99.99%), mean delta^2 rel err {rel:.2e} (need <= 1e-5)",
              flush=True)
        need(okF.item() == 1.0 and exact >= 0.9999 and okR >= 0.9999
             and rel <= 1e-5, f"{name} at {N}^3 disagrees with its plain "
             "version")
        Ft, Rt = F0.clone(), R0.clone()
        ms = time_ms(lambda: collapse.collapse_update_table(
            sd, Ft, Rt, 1, *targs, interp))
        Ft, Rt = F0.clone(), R0.clone()
        plain_ms = time_ms(lambda: collapse.collapse_update_table_plain(
            sd, Ft, Rt, 1, *targs, interp))
        phase(name, dF.max().item(), math.inf, ms, plain_ms,
              extra="(F, fraction criteria above) ")
        del Fk, Rk, Fp, Rp, Ft, Rt, dF
    del tabs, targs

    # ---- K6a and K6b: the needed rows of four stacks, and the FmaxPDF
    # histogram, of the state after the mid radius ----
    collapse.collapse_update_plain(sd, F0, R0, 1, pack)
    idx = compact.needed_order(F0, p.Flast)
    stacks = [sd[i:i + 3] for i in (0, 3, 1, 2)]
    size = compact.packed_size(idx.numel(), len(stacks), True)
    got = torch.empty(size, device=dev)
    want = torch.empty(size, device=dev)
    compact.gather_rows(idx, stacks, got, F=F0)
    compact.gather_rows_plain(idx, stacks, want, F=F0)
    need(torch.equal(got.view(torch.int32), want.view(torch.int32)),
         f"gather_rows at {N}^3 is not identical to its plain version")
    phase("gather_rows", (got - want).abs().max().item(), 0.0,
          time_ms(lambda: compact.gather_rows(idx, stacks, got, F=F0)),
          time_ms(lambda: compact.gather_rows_plain(idx, stacks, want,
                                                    F=F0)),
          extra=f"identical, {idx.numel()} rows of 4 stacks, ")
    del got, want, stacks
    got = compact.pdf_hist(F0)
    want = compact.pdf_hist_plain(F0)
    need(torch.equal(got, want), f"pdf_hist at {N}^3 is not identical to "
         "its plain version")
    phase("pdf_hist", (got - want).abs().max().item(), 0.0,
          time_ms(lambda: compact.pdf_hist(F0)),
          time_ms(lambda: compact.pdf_hist_plain(F0)), extra="identical, ")
    del sd, F0, R0, idx

    # ---- K8: tabulated growth (an f(R) cosmology, so that the growth
    # varies with k) on delta ----
    cosmo_fr = Cosmology(params_for(N, **FR))
    gtabs, glo, gdx = fmax.growth_k_tables(cosmo_fr, 0.0, N, dev)
    got = derivatives.gradient_kspace_tab(delta, gtabs[0], glo, gdx, N)
    ref = derivatives.gradient_kspace_tab_plain(delta, gtabs[0], glo, gdx, N)
    need(torch.equal(torch.view_as_real(got), torch.view_as_real(ref)),
         f"kspace_gradient_tab at {N}^3 is not identical to its plain "
         "version")
    phase("kspace_gradient_tab", (got - ref).abs().max().item(), 0.0,
          time_ms(lambda: derivatives.gradient_kspace_tab(
              delta, gtabs[0], glo, gdx, N)),
          time_ms(lambda: derivatives.gradient_kspace_tab_plain(
              delta, gtabs[0], glo, gdx, N)), extra="identical, ")
    del got, ref

    # ---- K4: the two LPT passes on the R=0 stack ----
    sd = derivatives.second_derivatives(delta, 0.0, N)
    got = lpt.sources_pointwise(sd)
    ref = lpt.sources_pointwise_plain(sd)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    tol = 1e-5 * max(b.abs().max().item() for b in ref)
    phase("lpt_sources_pointwise", err, tol,
          time_ms(lambda: lpt.sources_pointwise(sd)),
          time_ms(lambda: lpt.sources_pointwise_plain(sd)))
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
          time_ms(lambda: lpt.src32_accumulate_plain(phi2, sd, src32)))
    del sd, phi2, src32, want, acc, scratch, delta
    torch.cuda.empty_cache()
    report[N] = rec


def c2r_check(dev):
    """The two c2r decompositions at 64^3 on a gradient-mode input (not
    Hermitian on the kx and ky Nyquist planes): the port's ifft2 + irfft on
    the card against the same on the CPU (pocketfft, the JAX package's
    convention), and torch.fft.irfftn on the card for information."""
    import torch
    from pinocchio_tpu.cosmology import Cosmology
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


def run_path(dev, name):
    """Drive one path through run_pipeline with the launch counts set to 0
    just before it; returns (launch counts, timings)."""
    import numpy as np
    import torch
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.run import run_pipeline

    N, kw, own = PATHS[name]
    p = params_for(N, **kw)
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = run_pipeline(p, outdir=out, device=dev, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        files = set(os.listdir(out))
        print(f"  {name} path {N}^3: {wall:.2f} s wall, peak device "
              f"memory {peak / 2**30:.2f} GiB", flush=True)
        print("  phases: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in sorted(res["timings"].items())),
            flush=True)
        for snap in res["frag"].catalogs:
            nh = int((snap.mass >= p.MinHaloMass).sum())
            print(f"  z={snap.z:g}: {nh} halos", flush=True)
            need(nh > 0, f"{name}: no halos at z={snap.z}")
            for kind in ("catalog", "mf"):
                fn = f"pinocchio.{snap.z:6.4f}.{p.RunFlag}.{kind}.out"
                need(fn in files, f"{name}: missing {fn}")
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
    print(f"  launches on the {name} path: {launches}", flush=True)
    expected = COMMON | own
    missing = sorted(k for k in expected if launches[k] <= 0)
    stray = sorted(k for k, v in launches.items()
                   if v > 0 and k not in expected)
    need(not missing, f"kernels of the {name} path not launched: {missing}")
    need(not stray, f"kernels of other paths launched on the {name} path: "
         f"{stray}")
    need("jax" not in sys.modules, "jax was imported")
    return launches, res["timings"]


def reference_check(dev, name):
    """A path at a small size on the card against the same run on the CPU,
    where every kernel is its plain PyTorch version (the versions the CPU
    tests hold to the JAX package).  The tolerance family of those tests:
    halo counts per output within max(5, 0.5 %), more than 97 % of the
    final halos identical in name and mass."""
    import torch
    from pinocchio_tpu_torch.run import run_pipeline

    N = REFERENCE[name]
    p = params_for(N, **PATHS[name][1])
    cats = []
    for d in (dev, torch.device("cpu")):
        with tempfile.TemporaryDirectory() as out:
            cats.append(run_pipeline(p, outdir=out, device=d, verbose=False,
                                     write_outputs=False)["frag"].catalogs)
    card, host = cats
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


def main() -> int:
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
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pinocchio_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.lib()
    print(f"kernels built with nvcc in {time.perf_counter() - t0:.1f} s",
          flush=True)

    try:
        report = {}
        for N in KERNEL_SIZES:
            print(f"kernel phases at {N}^3:", flush=True)
            kernel_phases(N, dev, report)
        c2r_check(dev)
        paths = {}
        for path in PATHS:
            print(f"{path} path at {PATHS[path][0]}^3:", flush=True)
            paths[path] = run_path(dev, path)[0]
        for path in REFERENCE:
            print(f"{path} path at {REFERENCE[path]}^3 on the card and on "
                  "the CPU:", flush=True)
            reference_check(dev, path)
    except CheckFailed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1

    # each kernel's launches: on the first path (in PATHS order) that owns
    # it; the shared kernels on the main path
    rows = []
    for kname, (route, source, replaces) in kernels.KERNELS.items():
        owner = next(nm for nm, (_, _, own) in PATHS.items()
                     if kname in COMMON | own)
        r = report[PIPELINE_N][kname]
        big = report[max(KERNEL_SIZES)][kname]
        rows.append(dict(name=kname, route=route, source=source,
                         replaces=replaces, launches=paths[owner][kname],
                         path=owner, max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"],
                         shape=f"{PIPELINE_N}^3",
                         ms_512=big["ms"], plain_ms_512=big["plain_ms"],
                         max_abs_err_512=big["max_abs_err"]))
    print(json.dumps({"kernels": rows, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
