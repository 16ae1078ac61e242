"""The port's timeless snapshot, dense dumps and special modes against the
JAX package's, on the CPU.

Same products on both sides: the dense dump of the JAX package's 48^3 run
(WriteTimelessSnapshot with RMAX, so the dump holds the whole grid's
products) is read by both packages and swept, and the two t_snapshot.out
files are byte-identical; a dense restart of the port writes the dumping
run's snapshot byte for byte, and each package reads the other's dense
dump.  From each package's own fmax (same seed): IDs identical, FMAX within
|dF| <= 1e-4 max(1, |F|) on 99.99 % of the cells float32 resolves (the
collapse kernel's criterion, tests/test_torch_collapse.py), RMAX equal on
99.9 %, the VEL blocks within 1e-5 max|v|, GRUP equal and ZACC (a float
derived from F) within 1e-4 max(1, |z|) on 97 % of the particles.

Special modes at 32^3: mode 2's DENS within 1e-5 max|delta| with the
header and IDs identical; mode 3's POS (periodically) and VEL within 1e-5
of the box and of max|v|; mode 1's CT table file has JAX's header and
record layout, and its entries the classic table build's tolerance on the
nodes float32 resolves (about half the entries differ from JAX's by ulps,
as the closed-form ellipsoid rounds differently in XLA and in PyTorch, so
the file is not byte-identical).  Mode 3 grows the displacements to the
last redshift but labels the file and its velocities with the first
output's, as the JAX package does (ROADMAP queue 1 item 13).
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu.io import dumps as jdumps
from pinocchio_tpu.ops import derivatives as jder
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu.run import run_special_mode as jax_run_special_mode
from pinocchio_tpu_torch import fmax
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io import dumps
from pinocchio_tpu_torch.io.snapshot import read_snapshot
from pinocchio_tpu_torch.ops import collapse, tabulated
from pinocchio_tpu_torch.run import run_pipeline, run_special_mode
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 48
SNAP = dict(WriteTimelessSnapshot=True, add_rmax_to_snapshot=True)
SNAPSHOT = "pinocchio.run.t_snapshot.out"


def _blocks(path):
    return read_snapshot(str(path))[1]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    jp, p = params_pair(**bench_kwargs(N, DumpProducts=True, **SNAP))
    out = tmp_path_factory.mktemp("jax")
    res = jax_run_pipeline(jp, outdir=str(out), verbose=False)
    return jp, p, res, out


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    p = params_pair(**bench_kwargs(N, DumpProducts=True, **SNAP))[1]
    out = tmp_path_factory.mktemp("port")
    res = run_pipeline(p, outdir=str(out), device="cpu", verbose=False)
    return p, res, out


def _restart(run, params, dump_dir, out, **kw):
    shutil.copytree(dump_dir / "DumpProducts", out / "DumpProducts")
    q = dataclasses.replace(params, DumpProducts=False,
                            ReadProductsFromDumps=True)
    return run(q, outdir=str(out), verbose=False, **kw)


def test_snapshot_from_the_same_products_is_byte_identical(jax_run,
                                                           tmp_path):
    jp, p, _, jout = jax_run
    _restart(jax_run_pipeline, jp, jout, tmp_path / "j")
    res = _restart(run_pipeline, p, jout, tmp_path / "t", device="cpu")
    assert res["fmax"].dense is not None
    mine = (tmp_path / "t" / SNAPSHOT).read_bytes()
    assert mine == (tmp_path / "j" / SNAPSHOT).read_bytes()
    assert mine == (jout / SNAPSHOT).read_bytes()
    for name in ("FmaxPDF", "histories"):
        f = f"pinocchio.run.{name}.out"
        assert ((tmp_path / "t" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes())


def test_dense_restart_writes_the_dumping_runs_snapshot(port_run, tmp_path):
    p, first, out = port_run
    again = _restart(run_pipeline, p, out, tmp_path, device="cpu")
    assert not any(k.startswith("fmax_") for k in again["timings"])
    assert (tmp_path / SNAPSHOT).read_bytes() == (out / SNAPSHOT).read_bytes()
    for a, b in zip(first["frag"].catalogs, again["frag"].catalogs):
        np.testing.assert_array_equal(a.name, b.name)
        np.testing.assert_array_equal(a.mass, b.mass)


def test_jax_reads_the_port_dense_dump(port_run):
    p, res, out = port_run
    jp = params_pair(**bench_kwargs(N, **SNAP))[0]
    got = jdumps.read_dumps(jp, str(out))
    d = res["fmax"].dense
    np.testing.assert_array_equal(np.asarray(got.products.Fmax), d.Fmax)
    np.testing.assert_array_equal(np.asarray(got.products.Rmax), d.Rmax)
    assert sorted(got.products.vel) == sorted(d.vel)
    for k, v in d.vel.items():
        np.testing.assert_array_equal(np.asarray(got.products.vel[k]), v)
    np.testing.assert_array_equal(got.smoothing.true_variance,
                                  res["fmax"].smoothing.true_variance)


def test_sparse_dump_is_refused_for_a_snapshot(port_run, tmp_path):
    p, res, _ = port_run
    dumps.dump_products(dataclasses.replace(p, WriteTimelessSnapshot=False),
                        res["fmax"], str(tmp_path))
    with pytest.raises(ValueError, match="sparse"):
        dumps.read_dumps(p, str(tmp_path))


def test_snapshot_from_each_packages_fmax(jax_run, port_run):
    _, p, jres, jout = jax_run
    _, _, out = port_run
    jb, tb = _blocks(jout / SNAPSHOT), _blocks(out / SNAPSHOT)
    assert list(jb) == list(tb)
    for label in ("HEAD", "ID  ", "INFO"):
        assert tb[label] == jb[label]

    # FMAX on the cells float32 resolves: float64 and one-ulp-moved float32
    # collapse over JAX's own Hessians
    jF = np.frombuffer(jb["FMAX"], np.float32).reshape(N, N, N)
    tF = np.frombuffer(tb["FMAX"], np.float32).reshape(N, N, N)
    jf = jres["fmax"]
    pack = fmax.inverse_growth_packs(Cosmology(p), jf.smoothing)[0]
    rng = np.random.default_rng(0)
    F64 = np.full(jF.shape, -10.0)
    moved = [np.full(jF.shape, -10.0) for _ in range(2)]
    for r in jf.smoothing.radii:
        sd = np.array(jder.second_derivatives(
            jf.kdensity, jnp.float32(r / jf.grid.CellSize), N))
        F64 = np.maximum(F64, collapse.collapse_F(
            torch.from_numpy(sd).double(), pack).numpy())
        for i in range(len(moved)):
            sdm = (sd * (1.0 + 2.0 ** -23 * rng.choice([-1.0, 1.0], sd.shape))
                   ).astype(np.float32)
            moved[i] = np.maximum(moved[i], collapse.collapse_F(
                torch.from_numpy(sdm), pack).numpy())
    tol = 1e-4 * np.maximum(1.0, np.abs(jF))
    noise = np.max([np.abs(x - F64) for x in moved] + [np.abs(jF - F64)],
                   axis=0)
    resolved = noise <= 0.25 * tol
    assert resolved.mean() >= 0.95
    assert np.mean((np.abs(tF - jF) <= tol)[resolved]) >= 0.9999

    rmax = [np.frombuffer(b["RMAX"], np.int32) for b in (jb, tb)]
    assert np.mean(rmax[0] == rmax[1]) >= 0.999
    for label in ("VEL ", "VEL2", "VL31", "VL32"):
        jv, tv = (np.frombuffer(b[label], np.float32) for b in (jb, tb))
        assert np.abs(tv - jv).max() <= 1e-5 * np.abs(jv).max(), label
    # the accretion redshift is a float derived from F: equal within F's
    # tolerance (measured 99.8 %); the group names exactly (99.98 %)
    jz, tz = (np.frombuffer(b["ZACC"], np.float32) for b in (jb, tb))
    assert np.mean(np.abs(tz - jz) <= 1e-4 * np.maximum(1.0, np.abs(jz))) \
        >= 0.97
    jg, tg = (np.frombuffer(b["GRUP"], np.uint64) for b in (jb, tb))
    assert np.mean(tg == jg) >= 0.97
    assert (tg > 1).any()


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """Special modes 1, 2, 3 of both packages at 32^3."""
    jp, p = params_pair(**bench_kwargs(32))
    files = {}
    for mode in (1, 2, 3):
        jd = tmp_path_factory.mktemp(f"jax_mode{mode}")
        td = tmp_path_factory.mktemp(f"port_mode{mode}")
        files[mode] = (jax_run_special_mode(jp, mode, str(jd), verbose=False),
                       run_special_mode(p, mode, str(td), device="cpu",
                                        verbose=False))
    return p, files


def test_mode_1_ct_table_matches_jax(modes):
    p, files = modes
    jfile, tfile = files[1]
    assert os.path.basename(jfile) == os.path.basename(tfile)
    jraw, traw = open(jfile, "rb").read(), open(tfile, "rb").read()
    assert len(traw) == len(jraw) and traw[:40] == jraw[:40]
    cosmo = Cosmology(p)
    sm = fmax.Smoothing.build(p, cosmo)
    jt = tabulated.read_ct_table_file(jfile, p, sm)
    tt = tabulated.read_ct_table_file(tfile, p, sm)
    nrec = 4 + 8 * jt[0].size
    for ism in range(sm.n):
        assert traw[40 + ism * nrec:44 + ism * nrec] == \
            jraw[40 + ism * nrec:44 + ism * nrec]
    for ism in (0, sm.n // 2, sm.n - 1):
        ls = tabulated.node_eigenvalues(float(np.sqrt(sm.variance[ism])))
        bc = collapse.ell_classic(*[torch.from_numpy(x) for x in ls]).numpy()
        F64 = np.where(bc > 0.0, 1.0 + cosmo.InverseGrowingMode(
            np.maximum(bc, 1e-30)), 0.0)
        want, got = jt[ism].ravel(), tt[ism].ravel()
        tol = 1e-4 * np.maximum(1.0, np.abs(F64))
        resolved = np.abs(want - F64) <= 0.25 * tol
        assert resolved.mean() >= 0.9
        assert np.mean((np.abs(got - want) <= tol)[resolved]) >= 0.999


def test_mode_2_density_matches_jax(modes):
    _, files = modes
    jb, tb = (_blocks(f) for f in files[2])
    assert list(tb) == list(jb)
    for label in ("HEAD", "ID  ", "INFO"):
        assert tb[label] == jb[label]
    jd, td = (np.frombuffer(b["DENS"], np.float32) for b in (jb, tb))
    assert np.abs(td - jd).max() <= 1e-5 * np.abs(jd).max()


def test_mode_3_lpt_snapshot_matches_jax(modes):
    p, files = modes
    jfile, tfile = files[3]
    assert os.path.basename(jfile) == os.path.basename(tfile)
    jb, tb = _blocks(jfile), _blocks(tfile)
    for label in ("HEAD", "ID  ", "INFO"):
        assert tb[label] == jb[label]
    box = p.BoxSize_h100
    jpos, tpos = (np.frombuffer(b["POS "], np.float32).astype(np.float64)
                  for b in (jb, tb))
    d = tpos - jpos
    d -= box * np.round(d / box)
    assert np.abs(d).max() <= 1e-5 * box
    jv, tv = (np.frombuffer(b["VEL "], np.float32) for b in (jb, tb))
    assert np.abs(tv - jv).max() <= 1e-5 * np.abs(jv).max()


def test_mode_3_labels_last_z_displacements_with_the_first_output(modes):
    """The displacements are grown to the last output redshift, but the
    file name, the header and the velocity factor are the first output's
    (JAX fmax.py:745, snapshot.py:100-120)."""
    p, files = modes
    tfile = files[3][1]
    z0 = p.output_z[0]
    assert os.path.basename(tfile).startswith(f"pinocchio.{z0:6.4f}.")
    header, blocks = read_snapshot(tfile)
    assert header["RedShift"] == z0 != p.zlast
    cosmo = Cosmology(p)
    res = fmax.run_fmax(p, cosmo, "cpu", keep_dense_products=True)
    disp = sum(v.reshape(3, -1) for v in res.dense.vel.values())
    vfact = np.float32(cosmo.Hubble(z0) / (1.0 + z0) * p.InterPartDist
                       * (1.0 + z0) * cosmo.fomega(z0, p.k_for_GM)
                       / np.sqrt(1.0 + z0))
    vel = np.frombuffer(blocks["VEL "], np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(vel, (disp * vfact).T)
