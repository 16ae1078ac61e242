"""Shared cases of the exchange's parity with the JAX package
(tests/test_torch_exchange_jax*.py): JAX's run_fmax_distributed over a mesh
of its 8 virtual CPU devices, the same products handed to the port as a
deferred hand-off over a port mesh of the same shape
(driver.handoff_from_arrays), and both packages' exchanges compared host by
host.  One JAX exchange costs about half a minute on the CPU (it compiles
its device programs anew), so the cases are split over four files that
the test workers run side by side."""

import dataclasses

import numpy as np

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fragment.subbox import choose_nbox as jchoose
from pinocchio_tpu.fragment.subbox import subbox_geometries as jgeoms
from pinocchio_tpu.io.catalogs import largest_halo_mass as jlargest
from pinocchio_tpu.parallel import exchange as jexchange
from pinocchio_tpu.parallel import pfft as jpfft
from pinocchio_tpu.parallel.driver import (
    run_fmax_distributed as jax_run_fmax_distributed)
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fmax import FmaxResult, Smoothing
from pinocchio_tpu_torch.fragment.driver import run_fragmentation
from pinocchio_tpu_torch.fragment.subbox import (
    _base_mask, choose_nbox, quick_pass_spheres, subbox_geometries)
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.parallel import driver, exchange, pfft
from pinocchio_tpu_torch.parallel.multihost import (fetch_local_sparse,
                                                    host_subboxes)
from torch_params import bench_kwargs, params_pair

N = 32
CPU8 = ["cpu"] * 8


def geometries(p, cosmo, ntasks):
    largest = largest_halo_mass(p, cosmo)
    nbox = choose_nbox(p, cosmo, largest, ntasks)
    return subbox_geometries(p, cosmo, largest, nbox), nbox, largest


def jax_products(kind):
    """JAX's run_fmax_distributed over its pencil (2x4) or slab mesh of 8
    devices, and the same products as the port's deferred hand-off over
    the port's mesh of that shape."""
    jp, p = params_pair(**bench_kwargs(N))
    if kind == "pencil":
        jmesh = jpfft.make_pencil_mesh(8)
        mesh = pfft.make_pencil_mesh(8, devices=CPU8)
    else:
        jmesh = jpfft.make_mesh(8)
        mesh = pfft.make_mesh(8, devices=CPU8)
    assert tuple(mesh.devices.shape) == tuple(jmesh.devices.shape)
    jres = jax_run_fmax_distributed(jp, JaxCosmology(jp), jmesh)
    F = np.asarray(jres.products.Fmax)
    vel = {k: np.asarray(v) for k, v in jres.products.vel.items()}
    h = driver.handoff_from_arrays(pfft.make_decomp(mesh, N), F, [vel],
                                   p.Flast)
    sm = jres.smoothing
    fr = FmaxResult(products=None, grid=None, host_products=None,
                    pdf_hist=None, handoff=h, smoothing=Smoothing(
                        radii=np.asarray(sm.radii),
                        variance=np.asarray(sm.variance),
                        true_variance=np.asarray(sm.true_variance)))
    return dict(jp=jp, p=p, jres=jres, jmesh=jmesh, fr=fr)


def _spheres(p, cosmo, fr, geoms, nhosts):
    """Each host's boundary spheres from one quick pass per own sub-box
    over the whole products."""
    full = dataclasses.replace(fr, host_products=fetch_local_sparse(fr),
                               handoff=None)
    out = {}
    for h in range(nhosts):
        parts = [np.zeros((0, 4), np.float32)]
        for g in host_subboxes(geoms, h, nhosts):
            base, r1, r2 = _base_mask(g)
            q = run_fragmentation(p, cosmo, full, geom=g, cell_mask=base,
                                  quick=True, verbose=False)
            parts.append(quick_pass_spheres(p, g, q, r1, r2))
        out[h] = np.concatenate(parts)
    return out


def assert_exchange_equals_jax(d, nhosts, turn):
    """The port's exchange on JAX's products equals JAX's exchange_products
    per host: identical cell sets, F and rows of every displacement stack,
    compared after sorting by cell (JAX's order), the port's rows in the
    sweep's order.  Turn 1 takes each host's spheres from a quick pass."""
    p, jp = d["p"], d["jp"]
    cosmo = Cosmology(p)
    geoms, _, _ = geometries(p, cosmo, 4)
    jc = JaxCosmology(jp)
    jl = jlargest(jp, jc)
    jg = jgeoms(jp, jc, jl, jchoose(jp, jc, jl, 4))
    assert [(g.L, g.stabl) for g in jg] == [(g.L, g.stabl) for g in geoms]
    spheres = None
    if turn == 1:
        spheres = _spheres(p, cosmo, d["fr"], geoms, nhosts)
        assert sum(len(s) for s in spheres.values()) > 0
    got = exchange.exchange_products(d["fr"], geoms, nhosts, turn=turn,
                                     spheres=spheres)
    want = jexchange.exchange_products(jp, d["jres"], d["jmesh"], jg, nhosts,
                                       f16=False, turn=turn, spheres=spheres)
    assert sorted(got) == sorted(want) == list(range(nhosts))
    for h in range(nhosts):
        sp, w = got[h], want[h]
        assert len(w.ci) > 0
        assert np.all((np.diff(sp.F) < 0) | ((np.diff(sp.F) == 0)
                                            & (np.diff(sp.ci) > 0)))
        o = np.argsort(sp.ci)
        np.testing.assert_array_equal(sp.ci[o], w.ci)
        np.testing.assert_array_equal(sp.F[o], w.F)
        assert sorted(sp.vel) == sorted(w.vel)
        for k in w.vel:
            np.testing.assert_array_equal(sp.vel[k][o], w.vel[k])
