"""A float64 evaluation of the classic-ellipsoid Fmax, the yardstick that
says on which cells float32 resolves the collapse time at all.

Near a collapse threshold F moves by percent, or jumps to another radius,
under a last-bit change of the Hessian: the CPU FFT's rounding alone (its
batched 1-D c2r takes another code path with more than one thread) flips
such cells, in either package.  fmax_float64 runs the same formulas (the
port's plain Hessian multipliers, the two-step c2r, collapse_F with the
run's inverse-growth packs, the strict running max) in float64 on the
port's planes; a parity test holds the port to JAX on the cells where
JAX's float32 Fmax lies within a quarter of the tolerance of it."""

import numpy as np
import torch

from pinocchio_tpu_torch import fmax, grids
from pinocchio_tpu_torch.ops import collapse, derivatives

TOL = 0.01


def fmax_float64(p, cosmo, kdensity, scaledep_gm=None) -> np.ndarray:
    """Fmax [N, N, N] float64 of the classic ellipsoid on the complex
    [N, N, N//2+1] planes ``kdensity`` (on the CPU)."""
    N = p.GridSize
    sm = fmax.Smoothing.build(p, cosmo)
    packs = fmax.inverse_growth_packs(cosmo, sm, scaledep_gm)
    radii = (sm.radii / grids.Grid(N, p.BoxSize_htrue).CellSize).astype(
        np.float32)
    kd = kdensity.to(torch.complex128)
    Fmax = torch.full((N, N, N), -10.0, dtype=torch.float64)
    for ism, R in enumerate(radii):
        sd = grids.irfft3(derivatives.hessian_kspace_plain(kd, float(R), N),
                          N)
        F = collapse.collapse_F(sd, packs[ism])
        assert F.dtype == torch.float64
        Fmax = torch.where(Fmax < F, F, Fmax)
    return Fmax.numpy()


def held_on_resolved(F, F_jax, F64, min_resolved=0.995):
    """|dF| > TOL on fewer than 0.1 % of the cells JAX's float32 resolves
    (|F_jax - F64| <= TOL / 4), which must be at least min_resolved of
    all; the median |dF| over every cell below 1e-4; and the port off
    float64 by more than TOL on at most 1.5 times as many cells as JAX.
    Returns (resolved fraction, flipped fraction there)."""
    F, F_jax = (np.asarray(x, np.float64) for x in (F, F_jax))
    d = np.abs(F - F_jax)
    resolved = np.abs(F_jax - F64) <= 0.25 * TOL
    flipped = (d[resolved] > TOL).mean()
    assert resolved.mean() >= min_resolved, resolved.mean()
    assert flipped < 1e-3, flipped
    assert np.median(d) < 1e-4
    assert ((np.abs(F - F64) > TOL).sum()
            <= 1.5 * (np.abs(F_jax - F64) > TOL).sum())
    return resolved.mean(), flipped


def _report(label, F_jax, runs, F64):
    """Print the flip counts of the port's runs {threads: Fmax} against
    JAX's, against each other and against the float64 Fmax."""
    res = np.abs(F_jax - F64) <= 0.25 * TOL
    print(f"{label}: JAX resolved on {100 * res.mean():.2f} % of cells; "
          f"off float64 by > {TOL}: JAX {(np.abs(F_jax - F64) > TOL).sum()}")
    for t, F in runs.items():
        d = np.abs(F - F_jax)
        print(f"  {t} threads: |dF| > {TOL} on {(d > TOL).sum()} cells "
              f"({(d > TOL).mean():.6f}), {(d[res] > TOL).sum()} of them "
              f"resolved; median {np.median(d):.3g}; off float64 "
              f"{(np.abs(F - F64) > TOL).sum()}")
    ts = sorted(runs)
    for t in ts[1:]:
        d = np.abs(runs[t] - runs[ts[0]])
        print(f"  {ts[0]} against {t} threads: {(d > 0).sum()} cells differ, "
              f"{(d > TOL).sum()} by more than {TOL}")


def main():
    """The evidence of the out-of-core parity tests' thread dependence
    (CHANGES.md, PR 19), on the CPU at 32^3: the batched 1-D c2r at one
    and at two threads, then the classic and the f(R) + RECOMPUTE runs of
    tests/test_torch_ooc.py and tests/test_torch_ooc_models.py at 1, 2 and
    4 threads against JAX's and the float64 Fmax.  Run from the repository
    root: python -m tests.torch_fmax64"""
    import dataclasses
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pinocchio_tpu import fmax as jfmax
    from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
    from pinocchio_tpu.fmax_ooc import run_fmax_ooc as jax_run_fmax_ooc
    from pinocchio_tpu.io.catalogs import largest_halo_mass as jlargest
    from pinocchio_tpu.scaledep import set_scaledep_gm as jax_gm
    from pinocchio_tpu_torch import fmax_ooc
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.scaledep import set_scaledep_gm
    from torch_params import bench_kwargs, params_pair

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 32, 32)).astype(np.float32))
    c = torch.fft.rfftn(x)
    out = {}
    for t in (1, 2):
        torch.set_num_threads(t)
        out[t] = (torch.fft.irfft(c, n=32, dim=2), torch.fft.irfftn(c))
    for i, what in enumerate(("batched 1-D irfft", "3-D irfftn")):
        a, b = out[1][i], out[2][i]
        print(f"{what}: {100 * (a != b).float().mean().item():.1f} % of the "
              f"values differ between 1 and 2 threads, max relative "
              f"{((a - b).abs().max() / a.abs().max()).item():.3g}")
    N = 32
    FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
              recompute_displacements=True, MaxMemPerParticle=400)
    for label, kw in (("classic", {}), ("f(R) + RECOMPUTE", FR)):
        jp, p = params_pair(**bench_kwargs(N, **kw), ooc_dtype="float32")
        jc, cosmo = JaxCosmology(jp), Cosmology(p)
        jgm = gm = None
        if kw:
            jgm = jax_gm(jp, jc, jfmax.Smoothing.build(jp, jc),
                         jlargest(jp, jc), verbose=False)
            gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                                 largest_halo_mass(p, cosmo), verbose=False)
        jres = jax_run_fmax_ooc(dataclasses.replace(
            jp, sparse_transfer=False, transfer_f16=False), jc,
            scaledep_gm=jgm, verbose=False, overlap=False)
        runs = {}
        for t in (1, 2, 4):
            torch.set_num_threads(t)
            runs[t] = fmax_ooc.run_fmax_ooc(
                p, cosmo, "cpu", scaledep_gm=gm).products.Fmax.numpy()
        kd = fmax_ooc.OocEngine(p, cosmo, "cpu").planes.assemble()
        _report(label, np.asarray(jres.products.Fmax, np.float64),
                {t: F.astype(np.float64) for t, F in runs.items()},
                fmax_float64(p, cosmo, kd, gm))


if __name__ == "__main__":
    main()
