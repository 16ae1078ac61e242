"""The port's multi-sub-box and two-turn fragmentation against the JAX
package's, on the CPU.

Pure geometry: find_start, find_length, choose_nbox, subbox_geometries and
turn0_bounds equal the JAX package's for ntasks 1-12 at 48^3 and 64^3.

Same products: both packages read one sparse dump written by the port
(48^3) and run their own run_fragmentation_multibox with nbox 2 x 2 x 1,
single-turn and two-turn; the sweep, the geometry and the products are the
same, so the catalogs (name, mass, q, x, v per output), the counters, the
histories.out bytes and the two-turn map's requested cells are exactly
equal, and so are the PLC arrays with a cone to z 0.1.  Both packages read
one dense dump (the timeless snapshot's) and run the pipeline over 4
sub-boxes: their t_snapshot.out files are byte-identical except ZACC and
GRUP at a few cells, which the JAX package's dense-product branch orders by
-F stably in each sub-box's local order, where the port keeps the global
order: only cells whose F ties another stored cell's may differ (measured:
none at 48^3).  The port's merged particle_pos covers each stored cell once.

From the port's own fmax (64^3): the 4-sub-box run against the one-box run
with the criteria of the JAX package's tests/test_subbox.py (halo counts
per output within max(5, 0.5 %), over 97 % of the one-box halos found in
name and mass, no duplicate names, mass-function bins of more than 100
halos within 3 %), single-turn and two-turn on the dense engine and once on
the out-of-core engine.  A legacy dense dump (radii and variances in the
npz, not in summary.json) reads to the same smoothing and products in
both packages; a sparse one without them is refused with a clear message.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fragment import subbox as jsub
from pinocchio_tpu.io import catalogs as jcat
from pinocchio_tpu.io import dumps as jdumps
from pinocchio_tpu.plc import build_plc_geometry as jax_plc_geometry
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu_torch import fmax, fmax_ooc
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fragment import subbox
from pinocchio_tpu_torch.fragment.driver import run_fragmentation
from pinocchio_tpu_torch.io import catalogs, dumps
from pinocchio_tpu_torch.io.snapshot import read_snapshot
from pinocchio_tpu_torch.plc import build_plc_geometry
from pinocchio_tpu_torch.run import main, run_pipeline
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N_PARITY = 48
N_OWN = 64
NBOX = (2, 2, 1)
PLC = dict(plc_enabled=True, StartingzForPLC=0.1, LastzForPLC=0.0,
           PLCAperture=30.0, PLCProvideConeData=True)
SNAP = dict(WriteTimelessSnapshot=True, add_rmax_to_snapshot=True)
SNAPSHOT = "pinocchio.run.t_snapshot.out"


@pytest.fixture(scope="module")
def cosmologies():
    out = {}
    for n in (N_PARITY, N_OWN):
        jp, p = params_pair(**bench_kwargs(n))
        out[n] = (jp, JaxCosmology(jp), p, Cosmology(p))
    return out


@pytest.mark.parametrize("n", [N_PARITY, N_OWN])
@pytest.mark.parametrize("ntasks", [1, 2, 4, 6, 8, 12])
def test_geometry_matches_jax(cosmologies, n, ntasks):
    jp, jc, p, c = cosmologies[n]
    for L in (n, n + 1, 7):
        for ib in range(ntasks):
            assert subbox.find_start(L, ntasks, ib) == \
                jsub.find_start(L, ntasks, ib)
            assert subbox.find_length(L, ntasks, ib) == \
                jsub.find_length(L, ntasks, ib)
    largest = catalogs.largest_halo_mass(p, c)
    assert largest == jcat.largest_halo_mass(jp, jc)
    nbox = subbox.choose_nbox(p, c, largest, ntasks)
    assert nbox == jsub.choose_nbox(jp, jc, largest, ntasks)
    mine = subbox.subbox_geometries(p, c, largest, nbox)
    theirs = jsub.subbox_geometries(jp, jc, largest, nbox)
    assert len(mine) == ntasks == len(theirs)
    for a, b in zip(mine, theirs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert subbox.turn0_bounds(a) == jsub.turn0_bounds(b)


def _same_catalogs(mine, theirs):
    assert len(mine.catalogs) == len(theirs.catalogs)
    for a, b in zip(mine.catalogs, theirs.catalogs):
        assert a.z == b.z
        for k in ("name", "mass", "q", "x", "v"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


@pytest.fixture(scope="module")
def sparse_dump(tmp_path_factory):
    """The port's sparse dump at N_PARITY, read by both packages."""
    jp, p = params_pair(**bench_kwargs(N_PARITY))
    out = tmp_path_factory.mktemp("sparse")
    res = fmax.run_fmax(p, Cosmology(p), "cpu")
    dumps.dump_products(p, res, str(out))
    return (jp, jdumps.read_dumps(jp, str(out)), p,
            dumps.read_dumps(p, str(out)), out)


def _multibox_pair(sparse_dump, capsys, two_turn, **kw):
    jp, jres, p, res, _ = sparse_dump
    jp, p = (dataclasses.replace(x, **kw) for x in (jp, p))
    jc, c = JaxCosmology(jp), Cosmology(p)
    jg = jax_plc_geometry(jp, jc, verbose=False) if kw else None
    g = build_plc_geometry(p, c, verbose=False) if kw else None
    capsys.readouterr()
    theirs = jsub.run_fragmentation_multibox(
        jp, jc, jres, NBOX, plc_geom=jg, two_turn=two_turn, verbose=True)
    said = capsys.readouterr().out
    mine = subbox.run_fragmentation_multibox(
        p, c, res, NBOX, plc_geom=g, two_turn=two_turn, verbose=False)
    return jp, theirs, p, mine, said


@pytest.mark.parametrize("two_turn", [False, True])
def test_multibox_from_the_same_products_equals_jax(sparse_dump, capsys,
                                                    tmp_path, two_turn):
    jp, theirs, p, mine, said = _multibox_pair(sparse_dump, capsys, two_turn)
    _same_catalogs(mine, theirs)
    np.testing.assert_array_equal(mine.counters, theirs.counters)
    assert len(mine.groups) == len(theirs.groups) == 4
    assert mine.nstored == theirs.nstored
    assert mine.timings["overhead"] == theirs.timings["overhead"]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jh = jcat.write_histories(jp, theirs.groups, str(tmp_path / "j"))
    th = catalogs.write_histories(p, mine.groups, str(tmp_path / "t"))
    assert open(th, "rb").read() == open(jh, "rb").read()
    if two_turn:
        nreq = int(mine.timings["boundary_requested"])
        assert nreq > 0
        assert f"({nreq} boundary particles requested)" in said
        assert mine.timings["quick"] > 0.0
        assert mine.nstored < subbox.run_fragmentation_multibox(
            p, Cosmology(p), sparse_dump[3], NBOX, two_turn=False,
            verbose=False).nstored
    else:
        assert mine.timings["boundary_requested"] == 0.0


def test_multibox_plc_from_the_same_products_equals_jax(sparse_dump, capsys):
    _, theirs, _, mine, _ = _multibox_pair(sparse_dump, capsys, False, **PLC)
    _same_catalogs(mine, theirs)
    assert len(mine.plc.z) > 1000 and not mine.plc.overflow
    for k in ("name", "z", "mass", "x", "v", "nz"):
        np.testing.assert_array_equal(getattr(mine.plc, k),
                                      getattr(theirs.plc, k), k)
    assert mine.plc.overflow == theirs.plc.overflow


def test_concurrent_sweeps_equal_sweeps_alone(sparse_dump):
    """As many sub-boxes as the pool has threads (cores + 4, so more
    threads than cores), with a short switch interval: the merged catalogs
    and counters equal those of the same sub-boxes swept one after another,
    single-turn and two-turn (the native sweep keeps its state per
    thread)."""
    import sys
    p, res = sparse_dump[2], sparse_dump[3]
    c = Cosmology(p)
    largest = catalogs.largest_halo_mass(p, c)
    ntasks = subbox.pool_workers()
    nbox = subbox.choose_nbox(p, c, largest, ntasks)
    geoms = subbox.subbox_geometries(p, c, largest, nbox)
    assert len(geoms) == ntasks
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for two_turn in (False, True):
            merged = subbox.run_fragmentation_multibox(
                p, c, res, nbox, largest_mass=largest, two_turn=two_turn,
                verbose=False)
            alone = [subbox.run_fragmentation_two_turn(p, c, res, g)
                     if two_turn else
                     run_fragmentation(p, c, res, geom=g, verbose=False)
                     for g in geoms]
            np.testing.assert_array_equal(
                merged.counters, np.sum([r.counters for r in alone], axis=0))
            for i, snap in enumerate(merged.catalogs):
                for k in ("name", "mass", "q", "x", "v"):
                    np.testing.assert_array_equal(
                        getattr(snap, k), np.concatenate(
                            [getattr(r.catalogs[i], k) for r in alone]), k)
    finally:
        sys.setswitchinterval(old)


@pytest.fixture(scope="module")
def dense_dump(tmp_path_factory):
    """The port's dense dump (the timeless snapshot's) at N_PARITY."""
    _, p = params_pair(**bench_kwargs(N_PARITY, DumpProducts=True, **SNAP))
    out = tmp_path_factory.mktemp("dense")
    res = fmax.run_fmax(p, Cosmology(p), "cpu")
    dumps.dump_products(p, res, str(out))
    return out


@pytest.fixture(scope="module")
def snapshot_restarts(dense_dump, tmp_path_factory):
    """Both packages' pipelines over 4 sub-boxes from the dense dump."""
    jp, p = params_pair(**bench_kwargs(N_PARITY, ReadProductsFromDumps=True,
                                       subbox_tasks=4, **SNAP))
    outs = {}
    for name, run, params, kw in (("jax", jax_run_pipeline, jp, {}),
                                  ("port", run_pipeline, p,
                                   dict(device="cpu"))):
        out = tmp_path_factory.mktemp(f"{name}_snap")
        shutil.copytree(dense_dump / "DumpProducts", out / "DumpProducts")
        outs[name] = (run(params, outdir=str(out), verbose=False, **kw), out)
    return p, outs


def test_multibox_snapshot_from_the_same_products(snapshot_restarts):
    p, outs = snapshot_restarts
    (_, jout), (tres, tout) = outs["jax"], outs["port"]
    jb = read_snapshot(str(jout / SNAPSHOT))[1]
    tb = read_snapshot(str(tout / SNAPSHOT))[1]
    assert list(tb) == list(jb)
    for label in jb:
        if label not in ("ZACC", "GRUP"):
            assert tb[label] == jb[label], label
    # the cells where the JAX package's dense branch and the port may order
    # a tie in F differently
    F = np.frombuffer(tb["FMAX"], np.float32)
    stored = F >= p.Flast
    vals, counts = np.unique(F[stored], return_counts=True)
    tied = stored & np.isin(F, vals[counts > 1])
    diff = ((np.frombuffer(tb["ZACC"], np.float32)
             != np.frombuffer(jb["ZACC"], np.float32))
            | (np.frombuffer(tb["GRUP"], np.uint64)
               != np.frombuffer(jb["GRUP"], np.uint64)))
    print(f"ZACC or GRUP differ at {int(diff.sum())} cells; "
          f"{int(tied.sum())} stored cells tie another's F")
    assert not (diff & ~tied).any()
    assert diff.sum() <= 10
    assert (np.frombuffer(tb["GRUP"], np.uint64) > 1).any()
    assert tres["frag"].particle_pos is not None


def test_merged_particles_cover_each_stored_cell_once(snapshot_restarts):
    p, outs = snapshot_restarts
    res = outs["port"][0]
    pos = res["frag"].particle_pos
    F = res["fmax"].dense.Fmax.ravel()
    np.testing.assert_array_equal(np.sort(pos), np.flatnonzero(F >= p.Flast))
    assert len(res["frag"].particle_zacc) == len(pos)
    assert len(res["frag"].particle_grup) == len(pos)


@pytest.fixture(scope="module")
def own_runs():
    """The port's own fmax at N_OWN on either engine, each swept as one box
    and over 4 sub-boxes: name -> (params, one box, 4 sub-boxes)."""
    p = params_pair(**bench_kwargs(N_OWN))[1]
    c = Cosmology(p)
    largest = catalogs.largest_halo_mass(p, c)
    nbox = subbox.choose_nbox(p, c, largest, 4)
    dense = fmax.run_fmax(p, c, "cpu")
    ooc = fmax_ooc.run_fmax_ooc(p, c, "cpu")
    out = {}
    for name, res, two_turn in (("single-turn", dense, False),
                                ("two-turn", dense, True),
                                ("out-of-core", ooc, None)):
        one = run_fragmentation(p, c, res, verbose=False)
        multi = subbox.run_fragmentation_multibox(
            p, c, res, nbox, largest_mass=largest, two_turn=two_turn,
            verbose=False)
        out[name] = (p, one, multi)
    return out


RUNS = ["single-turn", "two-turn", "out-of-core"]


@pytest.mark.parametrize("name", RUNS)
def test_own_fmax_halo_counts_match_one_box(own_runs, name):
    p, one, multi = own_runs[name]
    for s, m in zip(one.catalogs, multi.catalogs):
        ns = int((s.mass >= p.MinHaloMass).sum())
        nm = int((m.mass >= p.MinHaloMass).sum())
        assert ns > 0
        assert abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)


@pytest.mark.parametrize("name", RUNS)
def test_own_fmax_halo_identity_matches_one_box(own_runs, name):
    _, one, multi = own_runs[name]
    s, m = one.catalogs[-1], multi.catalogs[-1]
    sm = dict(zip(s.name.tolist(), s.mass.tolist()))
    matched = sum(1 for nm, ms in zip(m.name.tolist(), m.mass.tolist())
                  if sm.get(nm) == ms)
    assert matched / len(s.name) > 0.97


@pytest.mark.parametrize("name", RUNS)
def test_own_fmax_no_duplicate_halos(own_runs, name):
    _, _, multi = own_runs[name]
    for snap in multi.catalogs:
        assert len(np.unique(snap.name)) == len(snap.name)


@pytest.mark.parametrize("name", RUNS)
def test_own_fmax_mass_functions_match_one_box(own_runs, name):
    _, one, multi = own_runs[name]
    s, m = one.catalogs[-1], multi.catalogs[-1]
    bins = np.arange(1, 5, 0.2)
    hs, _ = np.histogram(np.log10(s.mass), bins=bins)
    hm, _ = np.histogram(np.log10(m.mass), bins=bins)
    big = hs > 100
    assert big.any()
    assert np.abs(hm[big] / hs[big] - 1.0).max() < 0.03


def _outputs(p, out):
    files = set(os.listdir(out))
    want = {f"pinocchio.{z:6.4f}.{p.RunFlag}.{kind}.out"
            for z in p.output_z for kind in ("catalog", "mf")}
    want |= {f"pinocchio.{p.RunFlag}.{k}.out"
             for k in ("FmaxPDF", "histories", "cosmology")}
    return want - files


def test_run_pipeline_over_sub_boxes_writes_every_output(tmp_path):
    """Over 4 sub-boxes: the dense engine with the PLC, the timeless
    snapshot and a dense dump; the out-of-core engine with the PLC and a
    sparse dump, then a restart from it (the same catalogs); the histories
    of several GroupStates."""
    base = dict(bench_kwargs(32, subbox_tasks=4), **dict(PLC,
                                                         StartingzForPLC=0.02))
    runs = {}
    for name, kw in (("dense", dict(SNAP, DumpProducts=True)),
                     ("ooc", dict(ooc="on", DumpProducts=True)),
                     ("restart", dict(ooc="on", ReadProductsFromDumps=True))):
        out = tmp_path / ("ooc" if name == "restart" else name)
        out.mkdir(exist_ok=True)
        p = params_pair(**dict(base, **kw))[1]
        res = run_pipeline(p, outdir=str(out), device="cpu", verbose=False)
        runs[name] = res
        assert res["plan"]["nbox"] == (2, 2, 1)
        assert isinstance(res["frag"].groups, list)
        assert len(res["frag"].groups) == 4
        assert not _outputs(p, out) or name == "restart"
        for kind in ("plc", "nz"):
            assert (out / f"pinocchio.run.{kind}.out").exists()
        assert len(res["frag"].plc.z) > 0
    assert (tmp_path / "dense" / SNAPSHOT).exists()
    with open(tmp_path / "ooc" / "DumpProducts" / "summary.json") as fd:
        assert json.load(fd)["format"] == "sparse"
    assert not any(k.startswith("fmax_") for k in runs["restart"]["timings"])
    _same_catalogs(runs["restart"]["frag"], runs["ooc"]["frag"])
    h = open(tmp_path / "dense" / "pinocchio.run.histories.out", "rb").read()
    trees = [catalogs.build_histories_flat(g, p.MinHaloMass)[0]
             for g in runs["dense"]["frag"].groups]
    assert all(len(t) for t in trees)
    # the (Ntrees, Nbranches) record follows the record-length record
    assert np.frombuffer(h[16:20], "<i4")[0] == sum(len(t) for t in trees)


def test_cli_subboxes(tmp_path, capsys):
    pf = tmp_path / "parameter_file"
    pf.write_text("GridSize 32\nBoxSize 32.0\n")
    main([str(pf), "--subboxes", "4", "--device", "cpu", "--outdir",
          str(tmp_path)])
    assert "fragmentation over 4 sub-boxes" in capsys.readouterr().out
    assert (tmp_path / "pinocchio.run.histories.out").exists()
    assert any(f.endswith(".catalog.out") for f in os.listdir(tmp_path))


@pytest.fixture(scope="module")
def legacy_dense_dump(dense_dump, tmp_path_factory):
    """The dense dump with its radii and variances moved from summary.json
    into products.npz, as the JAX package's earlier dumps kept them."""
    out = tmp_path_factory.mktemp("legacy")
    ddir = out / "DumpProducts"
    shutil.copytree(dense_dump / "DumpProducts", ddir)
    with open(ddir / "summary.json") as fd:
        meta = json.load(fd)
    with np.load(ddir / "products.npz") as data:
        arrays = {k: data[k] for k in data.files}
    for k in ("radii", "variance", "true_variance"):
        arrays[k] = np.asarray(meta.pop(k))
    with open(ddir / "summary.json", "w") as fd:
        json.dump(meta, fd)
    np.savez(ddir / "products.npz", **arrays)
    return out


def test_legacy_dense_dump_reads_as_in_jax(dense_dump, legacy_dense_dump):
    jp, p = params_pair(**bench_kwargs(N_PARITY, **SNAP))
    got = dumps.read_dumps(p, str(legacy_dense_dump))
    want = dumps.read_dumps(p, str(dense_dump))
    theirs = jdumps.read_dumps(jp, str(legacy_dense_dump))
    for k in ("radii", "variance", "true_variance"):
        np.testing.assert_array_equal(getattr(got.smoothing, k),
                                      getattr(theirs.smoothing, k), k)
        np.testing.assert_array_equal(getattr(got.smoothing, k),
                                      getattr(want.smoothing, k), k)
    np.testing.assert_array_equal(got.dense.Fmax,
                                  np.asarray(theirs.products.Fmax))
    np.testing.assert_array_equal(got.dense.Rmax,
                                  np.asarray(theirs.products.Rmax))
    assert sorted(got.dense.vel) == sorted(theirs.products.vel)
    for k, v in got.dense.vel.items():
        np.testing.assert_array_equal(v, np.asarray(theirs.products.vel[k]))
    for k in ("ci", "F"):
        np.testing.assert_array_equal(getattr(got.host_products, k),
                                      getattr(want.host_products, k))


def test_sparse_dump_without_radii_is_refused(sparse_dump, tmp_path):
    p = sparse_dump[2]
    shutil.copytree(sparse_dump[4] / "DumpProducts", tmp_path / "DumpProducts")
    path = tmp_path / "DumpProducts" / "summary.json"
    meta = json.loads(path.read_text())
    del meta["radii"]
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="no smoothing radii"):
        dumps.read_dumps(p, str(tmp_path))
