"""The port's fmax phase over CPU meshes against the port's own
single-device run at N = 32 (the same delta on both, bit for bit), with the
JAX package's criteria for its mesh (test_parallel.py): displacements within
1e-4 of the maximum, fewer than 30 cells with |dF| > 0.1, the count of
cells with F >= 1 within max(5, c/1000), variances within rtol 1e-4; the
products in the sweep's order with rows equal to the dense fields.  End to
end through run_pipeline(mesh=...) and the CLI's --chips on the CPU, halo
counts per output within 0.5 % of the single-device run's at 48^3; and the
mesh's refusal of the out-of-core engine (item 12c).
"""

import os

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch import fmax
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.parallel import driver, pfft
from pinocchio_tpu_torch.run import main, run_pipeline
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_params import bench_kwargs

torch.set_num_threads(2)

N = 32
CPU8 = ["cpu"] * 8
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)


@pytest.fixture(scope="module")
def single():
    """The port's single-device classic run with the dense products."""
    p = Params(**bench_kwargs(N))
    cosmo = Cosmology(p)
    return p, cosmo, fmax.run_fmax(p, cosmo, "cpu", keep_dense_products=True)


@pytest.mark.parametrize("mesh", [
    lambda: pfft.make_pencil_mesh(8, (4, 2), devices=CPU8),
    lambda: pfft.make_volume_mesh(8, devices=CPU8),
    lambda: pfft.make_mesh(4, devices=["cpu"] * 4)],
    ids=["pencil42", "vol222", "slab4"])
def test_mesh_matches_the_single_device_run(single, mesh):
    p, cosmo, ref = single
    r = driver.run_fmax_distributed(p, cosmo, mesh(),
                                    keep_dense_products=True)
    F, Rm = r.products.gather()
    np.testing.assert_array_equal(F, r.dense.Fmax)
    np.testing.assert_array_equal(Rm, r.dense.Rmax)
    F_ref = ref.products.Fmax.numpy()
    for key, a in ref.dense.vel.items():
        b = r.dense.vel[key]
        assert np.abs(a - b).max() < 1e-4 * max(np.abs(a).max(), 1e-3), key
    np.testing.assert_allclose(r.smoothing.true_variance,
                               ref.smoothing.true_variance, rtol=1e-4)
    assert int((np.abs(F - F_ref) > 0.1).sum()) < 30
    c_ref = int((F_ref >= 1.0).sum())
    assert abs(int((F >= 1.0).sum()) - c_ref) <= max(5, c_ref // 1000)
    # the products: the mesh's own Fmax in the sweep's order, rows equal to
    # its dense fields at the needed cells
    sp = r.host_products
    want = np.flatnonzero(F.ravel() >= p.Flast)
    want = want[np.lexsort((want, -F.ravel()[want]))]
    np.testing.assert_array_equal(sp.ci, want)
    for key, v in r.dense.vel.items():
        np.testing.assert_array_equal(sp.vel[key],
                                      v.reshape(3, -1)[:, want].T)
    assert int(r.pdf_hist.sum()) == N ** 3


def test_recompute_sets_match_the_single_device_run():
    """f(R) growth with RECOMPUTE over a slab mesh: one displacement set per
    output redshift (K8s), each within 1e-4 of the single-device set's
    maximum at the cells both runs need."""
    p = Params(**bench_kwargs(N, **FR))
    cosmo = Cosmology(p)
    gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                         largest_halo_mass(p, cosmo), verbose=False)
    ref = fmax.run_fmax(p, cosmo, "cpu", scaledep_gm=gm).host_products
    got = driver.run_fmax_distributed(
        p, cosmo, pfft.make_mesh(8, devices=CPU8),
        scaledep_gm=gm).host_products
    assert len(got.segments) == len(ref.segments) == len(p.output_z)
    common, ig, ir = np.intersect1d(got.ci, ref.ci, return_indices=True)
    assert len(common) >= 0.99 * len(ref.ci)
    for g, w in zip(got.segments, ref.segments):
        for k in w:
            assert np.abs(g[k][ig] - w[k][ir]).max() <= 1e-4 * np.abs(
                w[k]).max()


def _counts(res, p):
    return [int((c.mass >= p.MinHaloMass).sum())
            for c in res["frag"].catalogs]


def test_run_pipeline_on_a_mesh(tmp_path):
    """run_pipeline(mesh=...) end to end on the CPU: the catalogs' halo
    counts per output within 0.5 % of the single-device run's."""
    p = Params(**bench_kwargs(48))
    single = run_pipeline(p, outdir=str(tmp_path), device="cpu",
                          verbose=False, write_outputs=False)
    mesh = run_pipeline(p, outdir=str(tmp_path), device="cpu",
                        verbose=False,
                        mesh=pfft.make_pencil_mesh(4, devices=["cpu"] * 4))
    assert isinstance(mesh["fmax"].products, driver.ShardedProducts)
    want, got = _counts(single, p), _counts(mesh, p)
    assert min(want) > 0
    for g, w in zip(got, want):
        assert abs(g - w) <= 0.005 * w, (got, want)
    assert any(f.endswith("catalog.out") for f in os.listdir(tmp_path))


def test_cli_chips_on_the_cpu(tmp_path):
    """`--chips 4 --decomp volumes --device cpu` runs the pipeline over a
    4-shard CPU volumes mesh and writes the catalogs."""
    pf = tmp_path / "parameter_file"
    pf.write_text("GridSize 16\nBoxSize 16.0\n")
    main([str(pf), "--chips", "4", "--decomp", "volumes", "--device", "cpu",
          "--outdir", str(tmp_path)])
    outs = set(os.listdir(tmp_path))
    assert "pinocchio.run.FmaxPDF.out" in outs
    assert any(f.endswith("catalog.out") for f in outs)


@pytest.mark.parametrize("ooc", ["on", "auto"])
def test_mesh_with_the_out_of_core_engine_raises(tmp_path, monkeypatch, ooc):
    """A mesh with ooc 'on', or 'auto' where the planner picks the
    out-of-core engine, raises naming item 12c."""
    from pinocchio_tpu_torch import planner
    p = Params(**bench_kwargs(16, ooc=ooc))
    if ooc == "auto":
        # a device between the two engines' peaks
        rep = planner.plan(p, "cpu", Cosmology(p))
        limit = 0.5 * (rep["dense"]["peak"] + rep["ooc"]["peak"])
        assert rep["ooc"]["peak"] < limit < rep["dense"]["peak"]
        monkeypatch.setattr(planner, "device_memory", lambda dev: limit)
    with pytest.raises(NotImplementedError, match="item 12c"):
        run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=False,
                     mesh=pfft.make_mesh(2, devices=["cpu"] * 2))
