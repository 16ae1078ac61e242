"""The port's out-of-core engine with its ledger sharded over a mesh of CPU
shards (fmax_ooc.OocMesh), against the JAX package's kz-sharded engine and
against the port's own single-device out-of-core engine, on the CPU.

Against JAX's run_fmax_ooc(mesh=pfft.make_mesh(8)) on the conftest's 8
virtual devices (float32 storage, overlap=False), at 32^3 with the
tolerance of the JAX package's own mesh test (tests/test_ooc.py:395-423):
|dF| > 0.01 on fewer than 0.1 % of cells, median |dF| < 1e-4, grid
variances within rtol 1e-4, the needed sets differing on at most
max(4, 0.1 %) cells, the rows of the common cells within rtol = atol =
3e-3.

Against the port's single-device engine the mesh is exact: every kz plane
is regenerated with its own key and transformed on its own (the CPU's FFTs
give a plane the same bits in any batch), an x-slab is the same irfft
wherever its kz pieces lived, and the slab statistics are summed in global
slab order.  So Fmax, the grid variances, the FmaxPDF counts, the needed
cells, their F and every row of every displacement set are equal over 2,
3, 4 and 8 shards (uneven kz windows of Nh = 17 planes) at one x-slab
width; with the default widths (16 on one device, 8 over 3 shards) all but
the variances, which sum other slab means, are equal.  End to end the
catalogs equal the single-device out-of-core run's exactly.
"""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fmax_ooc import run_fmax_ooc as jax_run_fmax_ooc
from pinocchio_tpu.parallel import pfft as jpfft
from pinocchio_tpu_torch import fmax, fmax_ooc, planner
from pinocchio_tpu_torch.config import Params, read_parameter_file
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.parallel import driver, pfft
from pinocchio_tpu_torch.run import main, run_pipeline
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
# one x-slab width for the exact comparisons: 8 slabs, a slab for each of
# up to 8 shards
BX = dict(ooc_z_batch=4)
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
MODELS = {"bicubic": dict(ell_model="tabulated", ct_interp="bicubic"),
          "fr_recompute": FR, "lpt2": dict(three_lpt=False)}


def cpu_mesh(n):
    return pfft.make_mesh(n, devices=["cpu"] * n)


def _fmax(res):
    """The run's Fmax grid as a host array."""
    if isinstance(res.products, driver.ShardedProducts):
        return res.products.gather()[0]
    return res.products.Fmax.numpy()


def _sets(sp):
    return sp.segments if sp.segments is not None else [sp.vel]


def _same(got, want, variances=True):
    """Two out-of-core runs give the same products, bit for bit."""
    np.testing.assert_array_equal(_fmax(got), _fmax(want))
    if variances:
        np.testing.assert_array_equal(got.smoothing.true_variance,
                                      want.smoothing.true_variance)
    np.testing.assert_array_equal(got.pdf_hist, want.pdf_hist)
    a, b = got.host_products, want.host_products
    assert a.sorted_by == b.sorted_by == "F"
    np.testing.assert_array_equal(a.ci, b.ci)
    np.testing.assert_array_equal(a.F, b.F)
    assert len(_sets(a)) == len(_sets(b))
    for sa, sb in zip(_sets(a), _sets(b)):
        assert sorted(sa) == sorted(sb)
        for k in sb:
            np.testing.assert_array_equal(sa[k], sb[k])


def _run(p, cosmo, n=None, gm=None):
    return fmax_ooc.run_fmax_ooc(p, cosmo, "cpu", scaledep_gm=gm,
                                 mesh=None if n is None else cpu_mesh(n))


@pytest.fixture(scope="module")
def classic():
    """The classic run's Params and cosmology, and the single-device
    out-of-core run at the common x-slab width."""
    p = Params(**bench_kwargs(N, **BX))
    cosmo = Cosmology(p)
    return p, cosmo, _run(p, cosmo)


@pytest.fixture(scope="module")
def models():
    """name -> (Params, cosmology, scaledep_gm) of the other models."""
    out = {}
    for name, kw in MODELS.items():
        p = Params(**bench_kwargs(N, **BX, **kw))
        cosmo = Cosmology(p)
        gm = None
        if cosmo.scale_dep:
            gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                                 largest_halo_mass(p, cosmo), verbose=False)
        out[name] = (p, cosmo, gm)
    return out


def test_mesh_matches_the_jax_mesh():
    """8 CPU shards against JAX's kz-sharded engine on 8 virtual
    devices."""
    assert len(jax.devices()) == 8
    jp, p = params_pair(**bench_kwargs(N), ooc_dtype="float32")
    jres = jax_run_fmax_ooc(dataclasses.replace(
        jp, sparse_transfer=False, transfer_f16=False), JaxCosmology(jp),
        verbose=False, overlap=False, mesh=jpfft.make_mesh(8))
    res = _run(p, Cosmology(p), 8)
    d = np.abs(_fmax(res) - np.asarray(jres.products.Fmax))
    assert (d > 0.01).mean() < 1e-3
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(res.smoothing.true_variance,
                               jres.smoothing.true_variance, rtol=1e-4)
    sp, jsp = res.host_products, jres.host_products
    assert len(np.setxor1d(sp.ci, jsp.ci)) <= max(4, 1e-3 * len(jsp.ci))
    _, io, ij = np.intersect1d(sp.ci, jsp.ci, return_indices=True)
    assert sorted(sp.vel) == ["v1", "v2", "v31", "v32"]
    for k in sp.vel:
        np.testing.assert_allclose(sp.vel[k][io], np.asarray(jsp.vel[k])[ij],
                                   rtol=3e-3, atol=3e-3)
    assert int(res.pdf_hist.sum()) == N ** 3


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_mesh_equals_one_device(classic, n):
    p, cosmo, one = classic
    res = _run(p, cosmo, n)
    assert isinstance(res.products, driver.ShardedProducts)
    assert res.products.Rmax is None
    _same(res, one)


def test_default_slab_widths_keep_the_products(classic):
    """At the default widths one device takes slabs of 16 and 3 shards of
    8: the products are equal, the variances (sums of other slab means)
    within float64 round-off."""
    p, cosmo, _ = classic
    p = dataclasses.replace(p, ooc_z_batch=None)
    one, three = _run(p, cosmo), _run(p, cosmo, 3)
    assert fmax_ooc.OocMesh(p, cosmo, "cpu", cpu_mesh(3)).Bx == 8
    _same(three, one, variances=False)
    np.testing.assert_allclose(three.smoothing.true_variance,
                               one.smoothing.true_variance, rtol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_models_over_uneven_shards_equal_one_device(models, name):
    """The bicubic table lookup (K13), f(R) growth with RECOMPUTE (K14, one
    row set per output) and 2LPT over 3 shards (kz windows 6, 6, 5)."""
    p, cosmo, gm = models[name]
    res = _run(p, cosmo, 3, gm)
    _same(res, _run(p, cosmo, gm=gm))
    sets = _sets(res.host_products)
    assert len(sets) == (len(p.output_z) if p.recompute_displacements
                         else 1)
    assert sorted(sets[0]) == (["v1", "v2"] if name == "lpt2"
                               else ["v1", "v2", "v31", "v32"])


def test_shards_windows_and_blocks(classic):
    """kz windows cover the Nh planes contiguously, unevenly; x-blocks are
    runs of whole slabs; the kz = N/2 plane's imaginary part is zeroed on
    its owner, the last shard; too many shards raise."""
    p, cosmo, _ = classic
    om = fmax_ooc.OocMesh(p, cosmo, "cpu", cpu_mesh(8))
    wins = [(sh.k0, sh.nkz) for sh in om.shards]
    assert wins == [(0, 3)] + [(3 + 2 * i, 2) for i in range(7)]
    assert om.x_blocks == [(4 * i, 4) for i in range(8)]
    assert om.owner == list(range(8))
    stacks = om.build(om.stack(1), lambda i, kz0, B: om.planes(
        i, kz0, B).unsqueeze(0))
    assert torch.all(stacks[-1][..., -1].imag == 0)
    assert torch.any(stacks[-1][..., 0].imag != 0)
    assert torch.all(stacks[0][..., 0].imag == 0)
    # the shards' pieces are the single device's stack, plane for plane
    eng = fmax_ooc.OocEngine(p, cosmo, "cpu")
    whole = eng.build(eng.stack(1), lambda kz0, B: eng.planes(
        kz0, B).unsqueeze(0))
    assert torch.equal(torch.view_as_real(torch.cat(stacks, dim=-1)),
                       torch.view_as_real(whole))
    with pytest.raises(ValueError, match="kz planes"):
        fmax_ooc.OocMesh(dataclasses.replace(p, GridSize=8), cosmo, "cpu",
                         cpu_mesh(6))
    with pytest.raises(ValueError, match="x-slabs"):
        fmax_ooc.OocMesh(dataclasses.replace(p, ooc_z_batch=8), cosmo,
                         "cpu", cpu_mesh(8))


@pytest.mark.parametrize("n,one_card", [(4, True), (4, False), (3, True)])
def test_planner_models_the_shards(classic, n, one_card):
    """The planner's per-device arrays against the shards' tensors: a card
    holding every shard holds the sum (the whole stacks and Fmax), one of
    n devices its largest shard's; the sort covers the largest x-block."""
    p, cosmo, _ = classic
    p = dataclasses.replace(p, ooc_z_batch=None)
    om = fmax_ooc.OocMesh(p, cosmo, "cpu", cpu_mesh(n))
    stacks = om.stack(6)
    blocks = om.blocks()
    nbytes = [t.numel() * t.element_size() for t in stacks]
    fbytes = [t.numel() * t.element_size() for t in blocks]
    rep = planner.plan(p, "cpu", cosmo, n_chips=1 if one_card else n,
                       shards=n)
    cycle = rep["ooc"]["phases"]["cycle"]
    assert cycle["hessian_stack"] == pytest.approx(
        sum(nbytes) if one_card else max(nbytes))
    assert cycle["fmax"] == pytest.approx(
        sum(fbytes) if one_card else max(fbytes))
    sort = rep["ooc"]["phases"]["needed sort"]["needed_sort"]
    assert sort == pytest.approx(planner.SORT_FIELDS * max(fbytes))
    assert rep["shards"] == n


def _catalogs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.z == b.z and len(a.name) > 0
        for k in ("name", "mass", "q", "x", "v"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.fixture(scope="module")
def single_pipeline(tmp_path_factory):
    """run_pipeline on one device with ooc='on', and its outdir."""
    out = tmp_path_factory.mktemp("single")
    p = Params(**bench_kwargs(N, ooc="on"))
    return run_pipeline(p, outdir=str(out), device="cpu", verbose=False), out


def test_pipeline_over_an_ooc_mesh(single_pipeline, tmp_path):
    """run_pipeline(mesh=pencil 2x2, ooc='on'): the ledger shards over the
    mesh's 4 devices whatever the decomposition; catalogs and files equal
    to the single-device out-of-core run's."""
    single, out1 = single_pipeline
    p = Params(**bench_kwargs(N, ooc="on"))
    res = run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=False,
                       mesh=pfft.make_pencil_mesh(4, devices=["cpu"] * 4))
    assert res["plan"]["engine"] == "out-of-core"
    assert res["plan"]["shards"] == 4
    assert isinstance(res["fmax"].products.decomp, fmax_ooc.OocMesh)
    _catalogs_equal(res["frag"].catalogs, single["frag"].catalogs)
    for f in os.listdir(out1):
        if f.endswith(".out") and "cosmology" not in f:
            assert filecmp.cmp(out1 / f, tmp_path / f, shallow=False), f


def test_cli_chips_with_the_out_of_core_engine(tmp_path, monkeypatch):
    """`--chips 4 --device cpu` where the planner picks the out-of-core
    engine (a device between the two engines' per-device peaks): the same
    files as the single-device out-of-core run of the parameter file."""
    pf = tmp_path / "parameter_file"
    pf.write_text(f"GridSize {N}\nBoxSize {float(N)}\n")
    (tmp_path / "outputs").write_text("2.0\n1.0\n0.5\n0.0\n")
    p = read_parameter_file(str(pf), norad=True)
    out1 = tmp_path / "single"
    os.makedirs(out1)
    run_pipeline(dataclasses.replace(p, ooc="on"), outdir=str(out1),
                 device="cpu", verbose=False)
    rep = planner.plan(p, "cpu", Cosmology(p), shards=4)
    limit = 0.5 * (rep["dense"]["peak"] + rep["ooc"]["peak"])
    assert rep["ooc"]["peak"] < limit < rep["dense"]["peak"]
    monkeypatch.setattr(planner, "device_memory", lambda dev: limit)
    out = tmp_path / "out"
    main([str(pf), "--chips", "4", "--device", "cpu", "--norad",
          "--outdir", str(out)])
    names = sorted(f for f in os.listdir(out1)
                   if f.endswith(".out") and "cosmology" not in f)
    assert any("catalog" in f for f in names)
    for f in names:
        assert filecmp.cmp(out1 / f, out / f, shallow=False), f


def test_dump_and_restart_over_an_ooc_mesh(single_pipeline, tmp_path):
    """A product dump over a 3-shard mesh, then a restart from it: both
    runs' catalogs equal the single-device out-of-core run's."""
    single, _ = single_pipeline
    p = Params(**bench_kwargs(N, ooc="on", DumpProducts=True))
    first = run_pipeline(p, outdir=str(tmp_path), device="cpu",
                         verbose=False, mesh=cpu_mesh(3))
    assert os.path.exists(tmp_path / "DumpProducts" / "products.0.npz")
    again = run_pipeline(
        dataclasses.replace(p, DumpProducts=False,
                            ReadProductsFromDumps=True),
        outdir=str(tmp_path), device="cpu", verbose=False, mesh=cpu_mesh(3),
        write_outputs=False)
    _catalogs_equal(first["frag"].catalogs, single["frag"].catalogs)
    _catalogs_equal(again["frag"].catalogs, single["frag"].catalogs)


def test_hosts_over_an_ooc_mesh(tmp_path):
    """Two mocked hosts over a 4-shard out-of-core mesh, 2 sub-boxes: each
    sweeps its share of the host products (no exchange); their catalogs
    united equal one process's."""
    p = Params(**bench_kwargs(N, ooc="on", subbox_tasks=2))
    one = run_pipeline(p, outdir=str(tmp_path / "one"), device="cpu",
                       verbose=False, write_outputs=False, mesh=cpu_mesh(4))
    os.makedirs(tmp_path / "hosts")
    parts = [run_pipeline(p, outdir=str(tmp_path / "hosts"), device="cpu",
                          verbose=False, mesh=cpu_mesh(4), hosts=(h, 2))
             for h in range(2)]
    for iout, want in enumerate(one["frag"].catalogs):
        assert len(want.name) > 0
        got = [r["frag"].catalogs[iout] for r in parts]
        assert all(len(g.name) > 0 for g in got)
        names = np.concatenate([g.name for g in got])
        mass = np.concatenate([g.mass for g in got])
        o, ow = np.argsort(names), np.argsort(want.name)
        np.testing.assert_array_equal(names[o], want.name[ow])
        np.testing.assert_array_equal(mass[o], want.mass[ow])
    outs = os.listdir(tmp_path / "hosts")
    assert any(f.endswith("catalog.out.0") for f in outs)
    assert any(f.endswith("catalog.out.1") for f in outs)
