"""run_pipeline over two mocked hosts of one process (hosts=(h, 2), h = 0
then 1, one outdir), IC and fmax over a 4-shard CPU pencil mesh, against
the single-process run of the same configuration, as the JAX package's
test_multihost.py:168-250 holds its own: the PLC to z 0.05 and the
timeless snapshot with RMAX, at 32^3.

The hosts write .out.0 / .out.1 chunks and no part file or staging
directory is left; the in-run mass functions and n(z), reduced through part
files, are the single-process files byte for byte; scripts/
torch_merge_chunks.py reassembles catalogs, histories and the PLC equal to
the single-process ones and a timeless snapshot identical to its file (and
writes a mass function the run did not); the port's io/readers parse the
chunks (NumFiles > 1) and the merged files as the JAX package's readers do,
and a JAX run's files too; a sparse dump of two hosts restarts to the
single-process catalogs.

Every run of the module is handed one fmax result (computed once, each
call given its own copy and deferred hand-off), so that the comparisons are
of the hosts' path on identical products: on the CPU the FFT library's
results may differ in the last bit from one call to the next under load,
which moves a cell across Flast now and then (the card's are the same on
every call, and chip_smoke.py's hosts path compares separate runs).
"""

import copy
import dataclasses
import filecmp
import importlib.util
import os

import numpy as np
import pytest
import torch

from pinocchio_tpu.io import readers as jax_readers
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io import readers
from pinocchio_tpu_torch.parallel import driver, pfft
from pinocchio_tpu_torch.parallel.pfft import make_pencil_mesh
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
KW = dict(bench_kwargs(N), plc_enabled=True, StartingzForPLC=0.05,
          LastzForPLC=0.0, PLCProvideConeData=True,
          WriteTimelessSnapshot=True, add_rmax_to_snapshot=True,
          subbox_tasks=2)
CATALOGS = [f"pinocchio.{z:6.4f}.run.catalog.out" for z in KW["output_z"]]
CHUNKED = CATALOGS + ["pinocchio.run.histories.out", "pinocchio.run.plc.out"]


def _mesh():
    return make_pencil_mesh(4, devices=["cpu"] * 4)


def _merge_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_merge_chunks", os.path.join(REPO, "scripts",
                                           "torch_merge_chunks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_fmax():
    """driver.run_fmax_distributed replaced, for the module, by copies of
    one result: its products as shards of the caller's mesh, and a
    deferred hand-off of them when asked."""
    p = Params(**KW)
    ref = driver.run_fmax_distributed(p, Cosmology(p), _mesh(),
                                      keep_dense_products=True)
    d = ref.dense

    def fmax(params, cosmo, mesh, scaledep_gm=None, verbose=False,
             keep_dense_products=False, kdensity=None, defer_handoff=False):
        decomp = pfft.make_decomp(mesh, params.GridSize)
        h = driver.handoff_from_arrays(decomp, d.Fmax, [d.vel], params.Flast)
        return dataclasses.replace(
            ref, smoothing=copy.deepcopy(ref.smoothing),
            products=driver.ShardedProducts(decomp, decomp.scatter(d.Fmax),
                                            decomp.scatter(d.Rmax)),
            host_products=None if defer_handoff else h.finish(),
            handoff=h if defer_handoff else None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "run_fmax_distributed", fmax)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process run and the two hosts' runs (their chunks kept
    in 'chunks', merged in 'multi')."""
    base = tmp_path_factory.mktemp("multihost")
    p = Params(**KW)
    single, multi = base / "single", base / "multi"
    os.makedirs(single), os.makedirs(multi)
    res = run_pipeline(p, outdir=str(single), device="cpu", verbose=False,
                       mesh=_mesh())
    hosts = [run_pipeline(p, outdir=str(multi), device="cpu", verbose=False,
                          mesh=_mesh(), hosts=(h, 2)) for h in range(2)]
    listing = sorted(os.listdir(multi))
    chunks = base / "chunks"
    os.makedirs(chunks)
    for f in listing:
        if ".out." in f:
            with open(multi / f, "rb") as src, open(chunks / f, "wb") as dst:
                dst.write(src.read())
    return dict(p=p, single=single, multi=multi, chunks=chunks, res=res,
                hosts=hosts, listing=listing)


def test_hosts_write_chunks_and_reduce_in_run(runs):
    listing = runs["listing"]
    for f in CHUNKED:
        assert f"{f}.0" in listing and f"{f}.1" in listing, f
        assert f not in listing
    assert "pinocchio.run.t_snapshot.out.0.npz" in listing
    assert not any(".part" in f or f.startswith(".host") for f in listing)
    # the mass functions and n(z): the single-process files byte for byte
    for f in ([c.replace("catalog", "mf") for c in CATALOGS]
              + ["pinocchio.run.nz.out", "pinocchio.run.FmaxPDF.out"]):
        assert filecmp.cmp(runs["single"] / f, runs["multi"] / f,
                           shallow=False), f
    # each host swept its own sub-box: the halos partition the single run's
    single = runs["res"]["frag"].catalogs[-1]
    names = np.concatenate([r["frag"].catalogs[-1].name
                            for r in runs["hosts"]])
    assert len(single.name) > 0
    np.testing.assert_array_equal(np.sort(names), np.sort(single.name))


def _same_catalog(a, b):
    assert len(a) == len(b) > 0
    oa, ob = np.argsort(a["name"]), np.argsort(b["name"])
    for field in a.dtype.names:
        np.testing.assert_array_equal(a[field][oa], b[field][ob])


def _same_histories(a, b):
    (na, ta), (nb, tb) = a, b
    assert na == nb == len(ta) == len(tb) > 0
    key = lambda t: tuple(t["name"].tolist())  # noqa: E731
    sa, sb = sorted(ta, key=key), sorted(tb, key=key)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)


def test_readers_parse_the_chunks(runs):
    """The port's readers read the chunks as one NumFiles > 1 output, as
    the JAX package's readers do, equal to the single-process files."""
    single, chunks = runs["single"], runs["chunks"]
    for f in CATALOGS:
        got = readers.read_catalog(str(chunks / f))
        np.testing.assert_array_equal(
            got, jax_readers.read_catalog(str(chunks / f)))
        _same_catalog(got, readers.read_catalog(str(single / f)))
    h = "pinocchio.run.histories.out"
    _same_histories(readers.read_histories(str(chunks / h)),
                    readers.read_histories(str(single / h)))
    _same_histories(readers.read_histories(str(chunks / h)),
                    jax_readers.read_histories(str(chunks / h)))
    plc = "pinocchio.run.plc.out"
    got = readers.read_plc(str(chunks / plc))
    np.testing.assert_array_equal(got, jax_readers.read_plc(str(chunks / plc)))
    _same_catalog(got, readers.read_plc(str(single / plc)))


def test_merge_tool_reassembles_the_files(runs):
    """scripts/torch_merge_chunks.py: catalogs, histories and PLC equal to
    the single-process files, the timeless snapshot identical, the chunks
    removed; a mass function the run did not write is written from the
    merged catalog."""
    p, single, multi = runs["p"], runs["single"], runs["multi"]
    mf = multi / CATALOGS[-1].replace("catalog", "mf")
    os.remove(mf)
    written = _merge_tool().merge(p, str(multi))
    assert str(mf) in written
    want = np.loadtxt(single / mf.name)
    got = np.loadtxt(mf)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    left = os.listdir(multi)
    assert not any(".out." in f for f in left)
    for f in CATALOGS:
        a = readers.read_catalog(str(single / f))
        b = readers.read_catalog(str(multi / f))
        _same_catalog(a, b)
        np.testing.assert_array_equal(b, jax_readers.read_catalog(
            str(multi / f)))
    h = "pinocchio.run.histories.out"
    _same_histories(readers.read_histories(str(multi / h)),
                    readers.read_histories(str(single / h)))
    plc = "pinocchio.run.plc.out"
    _same_catalog(readers.read_plc(str(multi / plc)),
                  readers.read_plc(str(single / plc)))
    snap = "pinocchio.run.t_snapshot.out"
    assert filecmp.cmp(single / snap, multi / snap, shallow=False)
    _, a = readers.read_timeless_snapshot(str(multi / snap))
    _, b = jax_readers.read_timeless_snapshot(str(multi / snap))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_readers_parse_a_jax_run(tmp_path):
    """The port's readers parse the JAX package's catalog, histories, PLC
    and timeless snapshot field for field as its own readers do."""
    from pinocchio_tpu.config import Params as JaxParams
    from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
    kw = dict(KW, subbox_tasks=1, GridSize=16, BoxSize=16.0,
              StartingzForPLC=0.02)
    jax_run_pipeline(JaxParams(**kw), outdir=str(tmp_path), verbose=False)
    for f in CATALOGS:
        np.testing.assert_array_equal(
            readers.read_catalog(str(tmp_path / f)),
            jax_readers.read_catalog(str(tmp_path / f)))
    h = "pinocchio.run.histories.out"
    _same_histories(readers.read_histories(str(tmp_path / h)),
                    jax_readers.read_histories(str(tmp_path / h)))
    np.testing.assert_array_equal(
        readers.read_plc(str(tmp_path / "pinocchio.run.plc.out")),
        jax_readers.read_plc(str(tmp_path / "pinocchio.run.plc.out")))
    snap = str(tmp_path / "pinocchio.run.t_snapshot.out")
    _, a = readers.read_timeless_snapshot(snap)
    _, b = jax_readers.read_timeless_snapshot(snap)
    assert sorted(a) == sorted(b) and "GRUP" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_hosts_that_do_not_divide_the_mesh(runs, tmp_path):
    """Three hosts over a slab mesh of 4: the exchange does not apply, so
    each host reads the whole products (the JAX package's local-fetch
    branch, one process); the hosts' catalogs unite to the single-process
    ones and their snapshot chunks (shards owned unevenly) to its file."""
    from pinocchio_tpu_torch.parallel.pfft import make_mesh
    p = dataclasses.replace(runs["p"], subbox_tasks=3)
    single = run_pipeline(p, outdir=str(tmp_path), device="cpu",
                          verbose=False, mesh=make_mesh(4, devices=["cpu"] * 4))
    os.rename(tmp_path / "pinocchio.run.t_snapshot.out", tmp_path / "one")
    parts = [run_pipeline(p, outdir=str(tmp_path), device="cpu",
                          verbose=False, hosts=(h, 3),
                          mesh=make_mesh(4, devices=["cpu"] * 4))
             for h in range(3)]
    for iout, want in enumerate(single["frag"].catalogs):
        names = np.concatenate([r["frag"].catalogs[iout].name for r in parts])
        np.testing.assert_array_equal(np.sort(names), np.sort(want.name))
    _merge_tool().merge(p, str(tmp_path))
    assert filecmp.cmp(tmp_path / "one",
                       tmp_path / "pinocchio.run.t_snapshot.out",
                       shallow=False)


def test_two_host_sparse_dump_restarts(runs, tmp_path):
    """Two hosts dump their own shards' products (products.0.npz and
    products.1.npz); a one-process restart from their union gives the
    single-process catalogs."""
    p = dataclasses.replace(runs["p"], WriteTimelessSnapshot=False,
                            DumpProducts=True)
    for h in range(2):
        run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=False,
                     mesh=_mesh(), hosts=(h, 2))
    dumps = sorted(os.listdir(tmp_path / "DumpProducts"))
    assert "products.0.npz" in dumps and "products.1.npz" in dumps
    with np.load(tmp_path / "DumpProducts" / "products.0.npz") as a, \
            np.load(tmp_path / "DumpProducts" / "products.1.npz") as b:
        assert len(np.intersect1d(a["ci"], b["ci"])) == 0
    restart = dataclasses.replace(p, DumpProducts=False,
                                  ReadProductsFromDumps=True)
    res = run_pipeline(restart, outdir=str(tmp_path), device="cpu",
                       verbose=False, write_outputs=False)
    for got, want in zip(res["frag"].catalogs, runs["res"]["frag"].catalogs):
        o, ow = np.argsort(got.name), np.argsort(want.name)
        np.testing.assert_array_equal(got.name[o], want.name[ow])
        np.testing.assert_array_equal(got.mass[o], want.mass[ow])
