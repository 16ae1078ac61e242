"""The port's fmax phase over an 8-shard CPU mesh, at N = 32, against the
JAX package's run_fmax_distributed on its 8 virtual CPU devices (pencil
4x2), for the classic ellipsoid, the tabulated collapse times and f(R)
growth with RECOMPUTE_DISPLACEMENTS (the mesh against the port's own
single-device run and end to end: test_torch_parallel_mesh.py).

Against JAX ( the port fed JAX's delta, so that both sides hold
one field; the tabulated model reads one CT table file that JAX wrote):
Fmax within 1e-4 max(1, |F|) on 99.99 % of the cells float32 resolves (the
cells where float64 and one-ulp-moved float32 evaluations over JAX's own
Hessians agree to a quarter of the tolerance; ROADMAP's Fmax/Rmax
tolerance), Rmax equal on 99.9 %, the grid variances within rtol 1e-4 (a
hierarchical mean in another order, JAX test_parallel.py:129), and the
displacement rows of every set within 1e-4 of the field's maximum.

"""

import os

import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fmax import Smoothing as JaxSmoothing
from pinocchio_tpu.io.catalogs import largest_halo_mass as jax_largest
from pinocchio_tpu.ops import derivatives as jder
from pinocchio_tpu.parallel import pfft as jpfft
from pinocchio_tpu.parallel.driver import (
    run_fmax_distributed as jax_run_fmax_distributed)
from pinocchio_tpu.scaledep import set_scaledep_gm as jax_set_scaledep_gm
from pinocchio_tpu_torch import fmax
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.ops import collapse
from pinocchio_tpu_torch.parallel import driver, pfft
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
CPU8 = ["cpu"] * 8
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
MODELS = {"classic": {}, "tabulated": dict(ell_model="tabulated"),
          "fr_recompute": FR}


def _gm(p, cosmo, jax_side):
    """The per-radius growth of a scale-dependent run, or None."""
    if not cosmo.scale_dep:
        return None
    if jax_side:
        return jax_set_scaledep_gm(p, cosmo, JaxSmoothing.build(p, cosmo),
                                   jax_largest(p, cosmo), verbose=False)
    return set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                           largest_halo_mass(p, cosmo), verbose=False)


def _resolved(jax_delta, radii_grid, jF, F_of):
    """The cells float32 resolves: float64 and two one-ulp-moved float32
    evaluations of F_of(Hessian stack, ism) over JAX's own Hessians agree
    with each other and with jF to a quarter of the tolerance."""
    rng = np.random.default_rng(0)
    F64 = np.full(jF.shape, -10.0)
    moved = [np.full(jF.shape, -10.0) for _ in range(2)]
    for ism, R in enumerate(radii_grid):
        sd = np.asarray(jder.second_derivatives(jax_delta, np.float32(R), N))
        F64 = np.maximum(F64, F_of(torch.from_numpy(sd).double(), ism))
        for i in range(2):
            sdm = (sd * (1.0 + 2.0 ** -23 * rng.choice([-1.0, 1.0], sd.shape))
                   ).astype(np.float32)
            moved[i] = np.maximum(moved[i], F_of(torch.from_numpy(sdm), ism))
    tol = 1e-4 * np.maximum(1.0, np.abs(jF))
    noise = np.max([np.abs(x - F64) for x in moved] + [np.abs(jF - F64)],
                   axis=0)
    return noise <= 0.25 * tol


def _F_of(p, cosmo, sm, gm):
    """F of one radius's Hessian stack with the run's collapse model, in
    the stack's precision (the port's plain versions)."""
    if p.ell_model == "classic":
        packs = fmax.inverse_growth_packs(cosmo, sm, gm)
        return lambda h, ism: collapse.collapse_F(h, packs[ism]).numpy()
    ct = fmax.prepare_ct_tables(p, cosmo, sm, verbose=False)
    state = fmax.load_jax_state({k: ct[k] for k in ("tables", "tables2",
                                                    "dv", "idx_map")}, "cpu")

    def F_of(h, ism):
        Fg = torch.full(h.shape[1:], -20.0, dtype=h.dtype)
        Rg = torch.zeros(h.shape[1:], dtype=torch.int32)
        collapse.collapse_update_table_plain(
            h, Fg, Rg, 0, state["tables"][ism].to(h.dtype),
            state["tables2"][ism].to(h.dtype), state["dv"].to(h.dtype),
            state["idx_map"], ct["ampl"][ism], p.ct_interp)
        return Fg.numpy()
    return F_of


@pytest.mark.parametrize("model", MODELS)
def test_run_fmax_distributed_matches_jax(model, tmp_path):
    kw = dict(MODELS[model])
    if model == "tabulated":
        kw["CTtableFile"] = str(tmp_path / "ct.out")
    jp, p = params_pair(**bench_kwargs(N, **kw))
    jcosmo, cosmo = JaxCosmology(jp), Cosmology(p)
    jr = jax_run_fmax_distributed(
        jp, jcosmo, jpfft.make_pencil_mesh(8, (4, 2)),
        scaledep_gm=_gm(jp, jcosmo, True), verbose=False)
    if model == "tabulated":
        assert os.path.exists(kw["CTtableFile"])    # JAX wrote the tables
    gm = _gm(p, cosmo, False)
    jdelta = np.asarray(jr.kdensity)[:, :, :N // 2 + 1]
    r = driver.run_fmax_distributed(
        p, cosmo, pfft.make_pencil_mesh(8, (4, 2), devices=CPU8),
        scaledep_gm=gm, kdensity=jdelta)
    jF, jR = np.asarray(jr.products.Fmax), np.asarray(jr.products.Rmax)
    F, R = r.products.gather()
    sm = r.smoothing
    radii_grid = (sm.radii / (p.BoxSize_htrue / N)).astype(np.float32)
    resolved = _resolved(jdelta, radii_grid, jF, _F_of(p, cosmo, sm, gm))
    tol = 1e-4 * np.maximum(1.0, np.abs(jF))
    assert resolved.mean() >= 0.95
    assert np.mean((np.abs(F - jF) <= tol)[resolved]) >= 0.9999
    assert np.mean(R == jR) >= 0.999
    np.testing.assert_allclose(sm.true_variance,
                               jr.smoothing.true_variance, rtol=1e-4)
    sp = r.host_products
    jsets = jr.vel_segments or [{k: np.asarray(v)
                                 for k, v in jr.products.vel.items()}]
    sets = sp.segments or [sp.vel]
    assert len(sets) == len(jsets) == (len(p.output_z)
                                       if p.recompute_displacements else 1)
    for got, want in zip(sets, jsets):
        assert sorted(got) == sorted(want)
        for k in want:
            rows = want[k].reshape(3, -1)[:, sp.ci].T
            assert np.abs(got[k] - rows).max() <= 1e-4 * np.abs(
                want[k]).max(), k


