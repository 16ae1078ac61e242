"""The port's CAMB-table path (FileWithInputSpectrum CAMBTable: READ_PK_TABLE,
SCALE_DEPENDENT and RECOMPUTE_DISPLACEMENTS, with HubbleTableFile for
READ_HUBBLE_TABLE) against the JAX package, on the CPU.

The CAMB file set comes from scripts/torch_make_camb_inputs.py (30 outputs
uniform in 1/(1+z) up to z 99, no radiation) on a parameter file written
here, once per test run; the JAX script's set, written in a subprocess, is
byte for byte the same.

- Growth: the reference's SCALE_DEP_LCDM scenario, as
  tests/test_scripts.py::test_camb_inputs_scale_dep_lcdm holds the JAX
  package: the port's Cosmology on the table set reproduces the plain LCDM
  growth within rtol 5e-3 (z 0, 0.5, 1, 2, 5; k 0.01, 1) and P(k) within
  rtol 1e-4, and equals the JAX package's Cosmology on the same files
  (GrowingMode(z, k), Hubble(z), the scale-dependent growth and f tables)
  to float64 round-off, rtol 1e-12: the same numpy code.
- Fmax, the RECOMPUTE sets and halos on both engines: each package's
  run_pipeline at 32^3 with MaxMemPerParticle 400, the dense engine and
  ooc='on' (float32 storage, the hand-off joined in the run), one torch
  thread.
  Fmax is held on the cells JAX's float32 resolves against a float64
  evaluation of the port's delta (tests/torch_fmax64.py: |dF| > 0.01 on
  fewer than 0.1 % of them, the median |dF| below 1e-4); the grid
  variances within rtol 1e-4; the needed set up to max(2, 0.1 %)
  borderline cells; the four sets' rows of the common cells within rtol =
  atol = 3e-3 (tests/test_torch_ooc_models.py); the halo counts per output
  within max(5, 0.5 %) (tests/test_torch_pipeline.py).  Measured at 32^3:
  dense 24 cells off JAX by more than 0.01, 1 of them resolved, halo
  counts equal; out-of-core 31 and 4, counts within 1.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu_torch import fmax, fmax_ooc
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.grids import Grid
from pinocchio_tpu_torch.ic import generate_kdensity
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.run import run_pipeline
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_fmax64 import fmax_float64, held_on_resolved
from torch_params import bench_kwargs, params_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
NZ = 30
SCRIPT = os.path.join(REPO, "scripts", "torch_make_camb_inputs.py")


def _script_main():
    """The twin's main, loaded from its file."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_make_camb_inputs",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="session")
def camb_set(tmp_path_factory):
    """(the parameter file, the twin's output directory, its stdout)."""
    import contextlib
    import io
    d = tmp_path_factory.mktemp("camb")
    pf = d / "parameter_file"
    pf.write_text(f"GridSize {N}\nBoxSize {float(N)}\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _script_main()([str(pf), "--outdir", str(d / "port"),
                               "--nz", str(NZ), "--norad"]) == 0
    return pf, d / "port", buf.getvalue()


def camb_kwargs(outdir, n=N, **kw):
    """bench_kwargs(n) with the CAMB table set in ``outdir``, its Hubble
    table and MaxMemPerParticle 400."""
    return bench_kwargs(n, FileWithInputSpectrum="CAMBTable",
                        CAMBMatterFile=str(outdir / "pk_cb"),
                        CAMBRedshiftsFile=str(outdir / "redshifts.dat"),
                        HubbleTableFile=str(outdir / "hubble.dat"),
                        MaxMemPerParticle=400, **kw)


def _pair(outdir, **kw):
    """Both packages' validated Params of the CAMB-table path."""
    jp, p = params_pair(**camb_kwargs(outdir, **kw))
    for q in (jp, p):
        q.validate()
        assert q.scale_dependent and q.read_pk_table
        assert q.recompute_displacements
    return jp, p


def test_files_equal_the_jax_scripts(camb_set, tmp_path):
    pf, port, printed = camb_set
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_camb_inputs.py"),
         str(pf), "--outdir", str(tmp_path), "--nz", str(NZ), "--norad"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(tmp_path))
    assert len(names) == NZ + 2 and f"pk_cb_{NZ - 1:03d}.dat" in names
    for f in names:
        assert (port / f).read_bytes() == (tmp_path / f).read_bytes(), f
    assert printed.replace(str(port), "D") == r.stdout.replace(
        str(tmp_path), "D")


@pytest.fixture(scope="module")
def cosmologies(camb_set):
    """(plain LCDM, the port's CAMB-table, the JAX package's CAMB-table)
    cosmologies."""
    _, port, _ = camb_set
    jp, p = _pair(port)
    return Cosmology(dataclasses.replace(
        p, FileWithInputSpectrum="no", scale_dependent=False,
        read_pk_table=False, recompute_displacements=False,
        HubbleTableFile="no")), Cosmology(p), JaxCosmology(jp)


def test_table_growth_reproduces_lcdm(cosmologies):
    c0, c1, _ = cosmologies
    assert c1.scale_dep and not c0.scale_dep
    assert c1._hubble_spline is not None
    zs = np.array([0.0, 0.5, 1.0, 2.0, 5.0])
    for k in (0.01, 1.0):
        g0 = np.asarray(c0.GrowingMode(zs)) / float(c0.GrowingMode(0.0))
        g1 = np.asarray(c1.GrowingMode(zs, k)) / float(c1.GrowingMode(0.0, k))
        np.testing.assert_allclose(g1, g0, rtol=5e-3)
    kk = np.logspace(-2, 0.5, 20)
    np.testing.assert_allclose(np.asarray(c1.PowerSpectrum(kk)),
                               np.asarray(c0.PowerSpectrum(kk)), rtol=1e-4)


def test_table_growth_equals_jax(cosmologies):
    _, c1, jc = cosmologies
    zs = np.array([0.0, 0.3, 0.5, 1.0, 2.0, 5.0, 20.0])
    for k in (1e-3, 0.01, 0.1, 1.0, 10.0):
        for f in ("GrowingMode", "GrowingMode_2LPT", "GrowingMode_3LPT_1",
                  "GrowingMode_3LPT_2", "fomega"):
            np.testing.assert_allclose(
                np.asarray(getattr(c1, f)(zs, k)),
                np.asarray(getattr(jc, f)(zs, k)), rtol=1e-12, err_msg=f)
    np.testing.assert_allclose(c1.Hubble(zs), np.asarray(jc.Hubble(zs)),
                               rtol=1e-12)
    for o in (1, 2, 31, 32):
        np.testing.assert_allclose(c1.sd_grow[o], jc.sd_grow[o], rtol=1e-12)
        np.testing.assert_allclose(c1.sd_fomega[o], jc.sd_fomega[o],
                                   rtol=1e-12)


@pytest.fixture(scope="module")
def engines(camb_set, tmp_path_factory):
    """engine -> (JAX's run_pipeline, the port's, the port's Params, the
    float64 Fmax of the port's delta), each run at one torch thread."""
    _, port, _ = camb_set
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for ooc in ("off", "on"):
            jp, p = _pair(port, ooc=ooc, ooc_dtype="float32")
            d = str(tmp_path_factory.mktemp(f"camb_{ooc}"))
            jres = jax_run_pipeline(jp, outdir=d, verbose=False,
                                    write_outputs=False)
            res = run_pipeline(p, outdir=d, device="cpu", verbose=False,
                               write_outputs=False)
            assert res["plan"]["engine"] == ("out-of-core" if ooc == "on"
                                             else "dense")
            cosmo = res["cosmo"]
            gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                                 largest_halo_mass(p, cosmo), verbose=False)
            if ooc == "on":
                kd = fmax_ooc.OocEngine(p, cosmo, "cpu").planes.assemble()
            else:
                kd = generate_kdensity(Grid(N, p.BoxSize_htrue), cosmo,
                                       p.RandomSeed, "cpu")
            out[ooc] = (jres, res, p, fmax_float64(p, cosmo, kd, gm))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("ooc", ["off", "on"])
def test_fmax_and_sets_match_jax(engines, ooc):
    jres, res, p, fmax64 = engines[ooc]
    jf, tf = jres["fmax"], res["fmax"]
    F, jF = tf.products.Fmax.numpy(), np.asarray(jf.products.Fmax)
    held_on_resolved(F, jF, fmax64)
    np.testing.assert_allclose(tf.smoothing.true_variance,
                               jf.smoothing.true_variance, rtol=1e-4)
    sp = tf.host_products
    assert len(sp.segments) == len(jf.vel_segments) == len(p.output_z)
    if ooc == "on":
        jci = jf.host_products.ci
        _, io, ij = np.intersect1d(sp.ci, jci, return_indices=True)
    else:
        # the JAX package's CPU run keeps the dense fields
        jci = np.flatnonzero(jF.ravel() >= p.Flast)
        io = np.flatnonzero(np.isin(sp.ci, jci))
        ij = sp.ci[io]
    assert len(np.setxor1d(sp.ci, jci)) <= max(2, 1e-3 * len(jci))
    for mine, theirs in zip(sp.segments, jf.vel_segments):
        assert sorted(mine) == sorted(theirs) == ["v1", "v2", "v31", "v32"]
        for k in mine:
            t = np.asarray(theirs[k])
            t = t[ij] if ooc == "on" else t.reshape(3, -1)[:, ij].T
            np.testing.assert_allclose(mine[k][io], t, rtol=3e-3, atol=3e-3)
    # the sets differ by their growth
    assert not np.allclose(sp.segments[0]["v1"], sp.segments[-1]["v1"])


@pytest.mark.parametrize("ooc", ["off", "on"])
def test_halo_counts_match_jax(engines, ooc):
    jres, res, p, _ = engines[ooc]
    mh = p.MinHaloMass
    for s, m in zip(jres["frag"].catalogs, res["frag"].catalogs):
        assert s.z == m.z
        ns, nm = int((s.mass >= mh).sum()), int((m.mass >= mh).sum())
        assert ns > 0
        assert abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)
