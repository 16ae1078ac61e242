"""The port's past light cone against the JAX package's, on the CPU.

At 64^3 (BoxSize 64 Mpc/h, the HMF_Validation switches) with a cone from
the default vertex along the default axis, 30 degrees wide, from z 0.1 to
0: about 77,000 crossings against a buffer of 4 Nmax = 139,808.

Same products on both sides: the sparse dump of the JAX package's run is
read by both packages and swept; the crossings (name, z, mass, x, v, n(z))
are equal and plc.out and nz.out byte-identical.  From each package's own
fmax (same seed): crossing counts within max(5, 0.5 %) and over 97 % of the
crossings identical in name and mass, the tolerance family of the halo
catalogs (tests/test_torch_pipeline.py).  The geometry (replications, their
F windows, the frame) equals JAX's, as do cone_and_cube_intersect on
tests/test_plc.py's cases and the geometry file.  As in the JAX package,
write_geometry is never called by a run, and a cone with more crossings
than the buffer holds (4 Nmax, from the grid size alone) stops there and
sets the overflow flag (ROADMAP queue 1 item 13).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from pinocchio_tpu import plc as jplc
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu_torch import plc
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 64
PLC = dict(plc_enabled=True, StartingzForPLC=0.1, LastzForPLC=0.0,
           PLCAperture=30.0, PLCProvideConeData=True)


def _kwargs(n=N, **kw):
    return dict(bench_kwargs(n), **PLC, **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    jp, p = params_pair(**_kwargs(DumpProducts=True))
    out = tmp_path_factory.mktemp("jax")
    res = jax_run_pipeline(jp, outdir=str(out), verbose=False)
    return jp, p, res, out


@pytest.fixture(scope="module")
def restarts(jax_run, tmp_path_factory):
    """Both packages read the JAX run's dump and sweep it."""
    jp, p, _, jout = jax_run
    outs = {}
    for name, run, params, kw in (("jax", jax_run_pipeline, jp, {}),
                                  ("port", run_pipeline, p,
                                   dict(device="cpu"))):
        out = tmp_path_factory.mktemp(f"{name}_restart")
        shutil.copytree(jout / "DumpProducts", out / "DumpProducts")
        q = dataclasses.replace(params, DumpProducts=False,
                                ReadProductsFromDumps=True)
        outs[name] = (run(q, outdir=str(out), verbose=False, **kw), out)
    return outs


def test_plc_from_the_same_products_is_identical(restarts):
    (jres, _), (tres, _) = restarts["jax"], restarts["port"]
    jp, tp = jres["frag"].plc, tres["frag"].plc
    assert len(tp.z) > 1000 and not tp.overflow and not jp.overflow
    for k in ("name", "z", "mass", "x", "v", "nz"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), k)


def test_plc_files_from_the_same_products_are_byte_identical(restarts):
    (_, jout), (_, tout) = restarts["jax"], restarts["port"]
    for kind in ("plc", "nz"):
        f = f"pinocchio.run.{kind}.out"
        assert (tout / f).read_bytes() == (jout / f).read_bytes(), f
    assert not any(f.endswith(".geometry.out") for f in os.listdir(tout))
    assert not any(f.endswith(".geometry.out") for f in os.listdir(jout))


def test_plc_from_each_packages_fmax(jax_run, tmp_path):
    _, p, jres, _ = jax_run
    res = run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=False,
                       write_outputs=False)
    assert "plc_geom" in res["timings"]
    jp, tp = jres["frag"].plc, res["frag"].plc
    nj, nt = len(jp.z), len(tp.z)
    assert nj > 1000 and not tp.overflow
    assert abs(nt - nj) <= max(5, 0.005 * nj), (nt, nj)
    theirs = set(zip(jp.name.tolist(), jp.mass.tolist()))
    same = sum(1 for k in zip(tp.name.tolist(), tp.mass.tolist())
               if k in theirs)
    assert same / nj > 0.97
    # the crossings lie in the cone: redshift range (+- the crossing
    # solve's tolerance) and aperture
    assert tp.z.min() >= -0.02 and tp.z.max() <= 0.12
    axis = np.asarray(p.PLCAxis) / np.linalg.norm(p.PLCAxis)
    cosang = tp.x @ axis / np.linalg.norm(tp.x, axis=1)
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))).max() \
        < p.PLCAperture + 1e-3


@pytest.fixture(scope="module")
def geometries(jax_run):
    jp, p, _, _ = jax_run
    return (jplc.build_plc_geometry(jp, JaxCosmology(jp), verbose=False),
            plc.build_plc_geometry(p, Cosmology(p), verbose=False), jp, p)


def test_geometry_matches_jax(geometries):
    jg, tg, _, _ = geometries
    assert tg.enabled and jg.enabled and len(tg.repls_ijk) > 1
    for k in ("Fstart", "Fstop", "center", "zvers", "xvers", "yvers",
              "repls_ijk", "repls_F1", "repls_F2", "nzbins", "delta_z",
              "Nmax"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k), k)
    assert tg.geometry_rows == jg.geometry_rows


def test_geometry_file_matches_jax(geometries, tmp_path):
    jg, tg, jp, p = geometries
    (tmp_path / "t").mkdir()
    mine = plc.write_geometry(p, tg, 1.0, 2.0, str(tmp_path / "t"))
    theirs = jplc.write_geometry(jp, jg, 1.0, 2.0, str(tmp_path))
    assert open(mine, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("Oc,theta", [
    ((0.0, 0.0, 0.0), 30.0),         # the vertex inside the cube
    ((0.0, 0.0, 20.0), 30.0),        # the cube ahead on the axis
    ((200.0, 0.0, 0.0), 10.0),       # far to the side of a narrow cone
    ((200.0, 0.0, 0.0), 180.0),      # the full sky
    ((12.0, 3.0, -25.0), 45.0),      # an edge case of the corner search
])
def test_cone_and_cube_intersect_matches_jax(Oc, theta):
    L = np.array([10.0, 10.0, 10.0])
    V = np.array([5.0, 5.0, 5.0])
    D = np.array([0.0, 0.0, 1.0])
    got = plc.cone_and_cube_intersect(np.array(Oc), L, V, D, theta)
    assert got == jplc.cone_and_cube_intersect(np.array(Oc), L, V, D, theta)


def test_nhalos_prediction_matches_jax(geometries):
    _, _, jp, p = geometries
    want = jplc.compute_nhalos_prediction(jp, JaxCosmology(jp), 0.0, 0.05)
    assert want > 0
    assert plc.compute_nhalos_prediction(p, Cosmology(p), 0.0, 0.05) == want


def test_deep_cone_in_a_small_box_overflows_like_jax(tmp_path):
    """The crossing buffer holds 4 Nmax = 4 int(N^3 / 6 PredPeakFactor)
    crossings, however deep the cone: 32^3 cells to z 0.05 make about 9,400
    crossings, over the 8,736 of PredPeakFactor 0.4 (a 64^3 box to z 0.3
    overflows the same way at the default 0.8).  Both packages stop at the
    cap and flag the overflow."""
    jp, p = params_pair(**dict(_kwargs(32), StartingzForPLC=0.05,
                               PredPeakFactor=0.4))
    jres = jax_run_pipeline(jp, outdir=str(tmp_path), verbose=False,
                            write_outputs=False)
    res = run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=False,
                       write_outputs=False)
    cap = 4 * int(32 ** 3 / 6 * p.PredPeakFactor)
    for r in (jres, res):
        assert r["frag"].plc.overflow and len(r["frag"].plc.z) == cap
