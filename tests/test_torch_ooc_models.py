"""The port's out-of-core engine with the other collapse models, with
scale-dependent growth and RECOMPUTE_DISPLACEMENTS, and the product dumps,
against the JAX package and against the port's dense engine, on the CPU.

JAX's run_fmax_ooc runs at float32 with overlap=False, as in
tests/test_torch_ooc.py, and the tolerances are that file's: |dF| > 0.01 on
fewer than 0.1 % of cells (for the f(R) run, as there, of the cells JAX's
float32 resolves against a float64 evaluation: 99.69 % of them; measured
29-33 cells off JAX on all cells at one to four threads, 3-6 on the
resolved ones), median |dF| < 1e-4, grid variances within 1e-4,
the needed set equal up to max(2, 0.1 %) borderline cells, the rows of the
common cells within rtol = atol = 3e-3, for every displacement set.  The
collapse tables come from one CT table file that both packages read, so
that the two runs look up the same table.  Against the port's dense engine
fed the delta assembled from the engine's kz planes, the engine agrees
exactly on the CPU (measured: Fmax, needed cells and order, and the rows of
every set), held to the same tolerances, with the needed cells in the same
order.

End to end at 48^3, ooc='on' against ooc='off' (two realizations of one
cosmology): halo counts per output within max(10, 6 sqrt(n) + 5 % n), the
JAX package's tolerance (tests/test_ooc.py).  A restart from a dump gives
identical catalogs.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pinocchio_tpu import fmax as jfmax
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fmax_ooc import run_fmax_ooc as jax_run_fmax_ooc
from pinocchio_tpu.io import dumps as jdumps
from pinocchio_tpu.io.catalogs import largest_halo_mass as jlargest
from pinocchio_tpu.scaledep import set_scaledep_gm as jax_set_scaledep_gm
from pinocchio_tpu_torch import fmax, fmax_ooc, planner
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io import dumps
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.ops import sng, tabulated
from pinocchio_tpu_torch.run import run_pipeline
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_fmax64 import fmax_float64, held_on_resolved
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)


@pytest.fixture(scope="module")
def ct_file(tmp_path_factory):
    """The port's classic CT tables of the 32^3 run, in a CT table file."""
    p = Params(**bench_kwargs(N))
    cosmo = Cosmology(p)
    sm = fmax.Smoothing.build(p, cosmo)
    path = str(tmp_path_factory.mktemp("ct") / "tables.ct")
    tabulated.write_ct_table_file(
        path, p, sm, tabulated.build_ct_tables_all(cosmo, sm)["tables"])
    return path


def _port(p, cosmo, gm=None):
    """The port's out-of-core run and its dense run on the same planes."""
    ooc = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu", scaledep_gm=gm)
    kd = fmax_ooc.OocEngine(p, cosmo, "cpu").planes.assemble()
    return ooc, fmax.run_fmax(p, cosmo, "cpu", kdensity=kd, scaledep_gm=gm)


def _jax(jp, jc, gm=None):
    return jax_run_fmax_ooc(dataclasses.replace(
        jp, sparse_transfer=False, transfer_f16=False), jc, scaledep_gm=gm,
        verbose=False, overlap=False)


@pytest.fixture(scope="module")
def tab_runs(ct_file):
    """interp -> (JAX's run, the port's run, the port's dense run)."""
    out = {}
    for interp in tabulated.INTERP:
        jp, p = params_pair(**bench_kwargs(N, ell_model="tabulated",
                                           ct_interp=interp,
                                           CTtableFile=ct_file),
                            ooc_dtype="float32")
        out[interp] = (_jax(jp, JaxCosmology(jp)),) + _port(p, Cosmology(p))
    return out


@pytest.fixture(scope="module")
def fr_runs():
    """(JAX's run, the port's run, the port's dense run, port Params, the
    float64 Fmax of the port's planes) of f(R) growth with
    RECOMPUTE_DISPLACEMENTS."""
    jp, p = params_pair(**bench_kwargs(N, **FR), ooc_dtype="float32")
    jc, cosmo = JaxCosmology(jp), Cosmology(p)
    jgm = jax_set_scaledep_gm(jp, jc, jfmax.Smoothing.build(jp, jc),
                              jlargest(jp, jc), verbose=False)
    gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                         largest_halo_mass(p, cosmo), verbose=False)
    kd = fmax_ooc.OocEngine(p, cosmo, "cpu").planes.assemble()
    return (_jax(jp, jc, jgm),) + _port(p, cosmo, gm) + (
        p, fmax_float64(p, cosmo, kd, gm))


def _sets(sp):
    return sp.segments if sp.segments is not None else [sp.vel]


def _jax_sets(jres):
    vel = jres.host_products.vel
    return jres.vel_segments if jres.vel_segments is not None else [vel]


def _held_to_jax(ooc, jres, nsets, fmax64=None):
    """fmax64: the float64 Fmax of the port's planes; with it, |dF| > 0.01
    is counted on the cells JAX's float32 resolves (tests/torch_fmax64.py)."""
    if fmax64 is not None:
        held_on_resolved(ooc.products.Fmax.numpy(), jres.products.Fmax,
                         fmax64)
    else:
        d = np.abs(ooc.products.Fmax.numpy()
                   - np.asarray(jres.products.Fmax))
        assert (d > 0.01).mean() < 1e-3
        assert np.median(d) < 1e-4
    np.testing.assert_allclose(ooc.smoothing.true_variance,
                               jres.smoothing.true_variance, rtol=1e-4)
    sp, jsp = ooc.host_products, jres.host_products
    assert len(np.setxor1d(sp.ci, jsp.ci)) <= max(2, 1e-3 * len(jsp.ci))
    _, io, ij = np.intersect1d(sp.ci, jsp.ci, return_indices=True)
    assert len(_sets(sp)) == len(_jax_sets(jres)) == nsets
    for mine, theirs in zip(_sets(sp), _jax_sets(jres)):
        assert sorted(mine) == ["v1", "v2", "v31", "v32"]
        for k in mine:
            np.testing.assert_allclose(mine[k][io], np.asarray(theirs[k])[ij],
                                       rtol=3e-3, atol=3e-3)


def _held_to_dense(ooc, dense, p):
    d = np.abs(ooc.products.Fmax.numpy() - dense.products.Fmax.numpy())
    assert (d > 0.01).mean() < 1e-3
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(ooc.smoothing.true_variance,
                               dense.smoothing.true_variance, rtol=1e-4)
    sp, dp = ooc.host_products, dense.host_products
    F = ooc.products.Fmax.numpy().ravel()
    want = np.flatnonzero(F >= p.Flast)
    np.testing.assert_array_equal(sp.ci, want[np.lexsort((want, -F[want]))])
    assert len(np.setxor1d(sp.ci, dp.ci)) <= max(2, 1e-3 * len(dp.ci))
    _, io, idn = np.intersect1d(sp.ci, dp.ci, return_indices=True)
    assert len(_sets(sp)) == len(_sets(dp))
    for mine, theirs in zip(_sets(sp), _sets(dp)):
        for k in mine:
            np.testing.assert_allclose(mine[k][io], theirs[k][idn],
                                       rtol=3e-3, atol=3e-3)
    np.testing.assert_array_equal(ooc.pdf_hist, dense.pdf_hist)


@pytest.mark.parametrize("interp", tabulated.INTERP)
def test_tabulated_ooc_matches_jax(tab_runs, interp):
    jres, ooc, _ = tab_runs[interp]
    _held_to_jax(ooc, jres, 1)


@pytest.mark.parametrize("interp", tabulated.INTERP)
def test_tabulated_ooc_matches_dense(tab_runs, interp):
    _, ooc, dense = tab_runs[interp]
    _held_to_dense(ooc, dense, Params(**bench_kwargs(N)))
    assert ooc.host_products.segments is None


def test_sng_reads_the_table_file_without_solving(tab_runs, ct_file,
                                                  monkeypatch):
    """ELL_SNG through a CTtableFile: the SNG solver never runs, and the
    engine looks up the file's tables as TABULATED_CT does."""
    def no_solve(*a, **k):
        raise AssertionError("the SNG solver ran")

    monkeypatch.setattr(sng, "ell_sng_F", no_solve)
    p = Params(**bench_kwargs(N, ell_model="sng", ct_interp="trilinear",
                              CTtableFile=ct_file))
    res = fmax_ooc.run_fmax_ooc(p, Cosmology(p), "cpu")
    want = tab_runs["trilinear"][1]
    assert torch.equal(res.products.Fmax, want.products.Fmax)
    np.testing.assert_array_equal(res.host_products.ci,
                                  want.host_products.ci)


def test_scaledep_recompute_ooc_matches_jax(fr_runs):
    jres, ooc, _, p, fmax64 = fr_runs
    _held_to_jax(ooc, jres, len(p.output_z), fmax64)


def test_scaledep_recompute_ooc_matches_dense(fr_runs):
    _, ooc, dense, p, _ = fr_runs
    _held_to_dense(ooc, dense, p)
    # the sets differ by their growth: the first is stored at output_z[0]
    v0, v3 = (ooc.host_products.segments[i]["v1"] for i in (0, 3))
    assert not np.allclose(v0, v3)


def test_run_fmax_ooc_takes_the_scaledep_packs(fr_runs, monkeypatch):
    """The cycle takes the per-radius inverse growth of a scale-dependent
    cosmology, as the dense engine does (fmax.py run_fmax)."""
    _, ooc, _, p, _ = fr_runs
    seen = []
    real = fmax_ooc.inverse_growth_packs

    def spy(cosmo, sm, scaledep_gm=None):
        seen.append(scaledep_gm)
        return real(cosmo, sm, scaledep_gm)

    monkeypatch.setattr(fmax_ooc, "inverse_growth_packs", spy)
    cosmo = Cosmology(p)
    gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                         largest_halo_mass(p, cosmo), verbose=False)
    q = dataclasses.replace(p, recompute_displacements=False, two_lpt=False,
                            three_lpt=False)
    res = fmax_ooc.run_fmax_ooc(q, cosmo, "cpu", scaledep_gm=gm)
    assert len(seen) == 1 and seen[0] is gm
    assert torch.equal(res.products.Fmax, ooc.products.Fmax)


@pytest.mark.parametrize("kw", [dict(ell_model="tabulated",
                                     ct_interp="bicubic"), FR])
def test_pipeline_ooc_against_dense(tmp_path, kw):
    base = bench_kwargs(48, **kw)
    res = run_pipeline(Params(**base, ooc="on"), outdir=str(tmp_path),
                       device="cpu", verbose=False, write_outputs=False)
    std = run_pipeline(Params(**base, ooc="off"), outdir=str(tmp_path),
                       device="cpu", verbose=False, write_outputs=False)
    assert res["plan"]["engine"] == "out-of-core"
    assert std["plan"]["engine"] == "dense"
    for a, b in zip(res["frag"].catalogs, std["frag"].catalogs):
        n, n_std = len(a.name), len(b.name)
        assert n > 0
        assert abs(n - n_std) <= max(10, 6 * np.sqrt(n_std) + 0.05 * n_std)


def test_port_dump_read_by_jax(fr_runs, tmp_path):
    _, ooc, _, p, _ = fr_runs
    dumps.dump_products(p, ooc, str(tmp_path))
    jp = params_pair(**bench_kwargs(N, **FR))[0]
    got = jdumps.read_dumps(jp, str(tmp_path))
    sp, jsp = ooc.host_products, got.host_products
    assert jsp.sorted_by == "F"
    np.testing.assert_array_equal(jsp.ci, sp.ci)
    np.testing.assert_array_equal(jsp.F, sp.F)
    assert len(got.vel_segments) == len(sp.segments) == len(p.output_z)
    for mine, theirs in zip(sp.segments, got.vel_segments):
        for k in mine:
            np.testing.assert_array_equal(theirs[k], mine[k])
    np.testing.assert_array_equal(got.smoothing.true_variance,
                                  ooc.smoothing.true_variance)


@pytest.fixture(scope="module")
def jax_fr24():
    """The JAX package's CPU fmax run at 24^3 with f(R) growth and
    RECOMPUTE_DISPLACEMENTS (dense products, one set per output)."""
    jp, p = params_pair(**bench_kwargs(24, **FR))
    jc = JaxCosmology(jp)
    jgm = jax_set_scaledep_gm(jp, jc, jfmax.Smoothing.build(jp, jc),
                              jlargest(jp, jc), verbose=False)
    return jp, p, jfmax.run_fmax(jp, jc, scaledep_gm=jgm, verbose=False)


def test_jax_dump_read_by_the_port(jax_fr24, tmp_path):
    """A dump of the JAX package's CPU run (rows sorted by cell) comes back
    in the sweep's order, with every set."""
    jp, p, jres = jax_fr24
    jdumps.dump_products(jp, jres, str(tmp_path))
    res = dumps.read_dumps(p, str(tmp_path))
    sp = res.host_products
    F = np.asarray(jres.products.Fmax).ravel()
    want = np.flatnonzero(F >= p.Flast)
    want = want[np.lexsort((want, -F[want]))]
    assert sp.sorted_by == "F" and res.products.Fmax is None
    np.testing.assert_array_equal(sp.ci, want)
    np.testing.assert_array_equal(sp.F, F[want])
    assert len(sp.segments) == len(p.output_z)
    for mine, theirs in zip(sp.segments, jres.vel_segments):
        for k, v in theirs.items():
            np.testing.assert_array_equal(
                mine[k], np.asarray(v).reshape(3, -1)[:, want].T)


def test_restart_from_a_dump_gives_the_same_catalogs(tmp_path):
    kw = bench_kwargs(24, **FR)
    first = run_pipeline(Params(**kw, ooc="on", DumpProducts=True),
                         outdir=str(tmp_path), device="cpu", verbose=False)
    pdf = tmp_path / "pinocchio.run.FmaxPDF.out"
    assert (tmp_path / "DumpProducts" / "summary.json").exists()
    os.remove(pdf)
    again = run_pipeline(Params(**kw, ReadProductsFromDumps=True),
                         outdir=str(tmp_path), device="cpu", verbose=False)
    assert not pdf.exists()           # the dumping run wrote it
    assert not any(k.startswith("fmax_") for k in again["timings"])
    for a, b in zip(first["frag"].catalogs, again["frag"].catalogs):
        assert a.z == b.z and len(a.name) > 0
        np.testing.assert_array_equal(a.name, b.name)
        np.testing.assert_array_equal(a.mass, b.mass)


@pytest.mark.parametrize("key,change", [
    ("GridSize", dict(GridSize=64)), ("RandomSeed", dict(RandomSeed=7)),
    ("BoxSize", dict(BoxSize=30.0)), ("lpt_order", dict(three_lpt=False))])
def test_dump_of_another_run_raises(fr_runs, tmp_path, key, change):
    _, ooc, _, p, _ = fr_runs
    dumps.dump_products(p, ooc, str(tmp_path))
    with pytest.raises(ValueError, match=f"dump mismatch for {key}"):
        dumps.read_dumps(dataclasses.replace(p, **change), str(tmp_path))


def test_jax_dense_dump_read_by_the_port(jax_fr24, tmp_path):
    """A dense dump of the JAX package (WriteTimelessSnapshot): the whole
    grid's products, the needed particles compacted in the sweep's order,
    the FmaxPDF counts; like the JAX package's, it keeps only the first of
    the RECOMPUTE sets (ROADMAP queue 1 item 13)."""
    jp, p, jres = jax_fr24
    jq, q = (dataclasses.replace(x, WriteTimelessSnapshot=True)
             for x in (jp, p))
    jdumps.dump_products(jq, jres, str(tmp_path))
    meta = json.loads((tmp_path / "DumpProducts" / "summary.json")
                      .read_text())
    assert meta["format"] == "dense"
    res = dumps.read_dumps(q, str(tmp_path))
    F = np.asarray(jres.products.Fmax)
    np.testing.assert_array_equal(res.dense.Fmax, F)
    np.testing.assert_array_equal(res.dense.Rmax,
                                  np.asarray(jres.products.Rmax))
    assert sorted(res.dense.vel) == sorted(jres.products.vel)
    Ff = F.ravel()
    want = np.flatnonzero(Ff >= p.Flast)
    want = want[np.lexsort((want, -Ff[want]))]
    sp = res.host_products
    assert sp.sorted_by == "F" and sp.segments is None
    np.testing.assert_array_equal(sp.ci, want)
    np.testing.assert_array_equal(sp.F, Ff[want])
    for k, v in jres.products.vel.items():
        np.testing.assert_array_equal(res.dense.vel[k], np.asarray(v))
        np.testing.assert_array_equal(
            sp.vel[k], np.asarray(v).reshape(3, -1)[:, want].T)
    assert res.pdf_hist.sum() == 24 ** 3
    np.testing.assert_array_equal(
        res.pdf_hist, np.asarray(jfmax._pdf_bincount(jres.products.Fmax)))
    assert jdumps.read_dumps(jq, str(tmp_path)).vel_segments is None


def test_planner_refuses_recompute_at_1024_on_the_host(monkeypatch, tmp_path):
    """f(R) growth with RECOMPUTE_DISPLACEMENTS at 1024^3 needs four sets of
    rows (about 146 GiB) on a 101 GiB host: the run aborts with the map
    before the fmax engine allocates anything; without RECOMPUTE it fits."""
    monkeypatch.setattr(planner, "host_memory", lambda: 101 * planner.GiB)
    monkeypatch.setattr(planner, "device_memory", lambda device: 80e9)

    def no_engine(*a, **k):
        raise AssertionError("the fmax engine ran")

    monkeypatch.setattr(fmax_ooc, "run_fmax_ooc", no_engine)
    p = Params(**bench_kwargs(1024, **FR), ooc="auto")
    with pytest.raises(planner.MemoryPlanError) as err:
        planner.enforce_budget(p, "cuda", verbose=False)
    msg = str(err.value)
    assert "host memory of the run" in msg and "RUN PLAN for 1024^3" in msg
    assert "rows" in msg and "out-of-core engine" in msg
    rep = planner.plan(p, "cuda")
    rows = rep["host"]["phases"]["fmax"]["rows"] / planner.GiB
    assert rep["use_ooc"] and rep["fits_device"] and 130.0 < rows < 160.0
    with pytest.raises(planner.MemoryPlanError):
        run_pipeline(p, outdir=str(tmp_path), device="cuda"
                     if torch.cuda.is_available() else "cpu", verbose=False)
    q = dataclasses.replace(p, recompute_displacements=False)
    assert planner.plan(q, "cuda")["fits_host"]
