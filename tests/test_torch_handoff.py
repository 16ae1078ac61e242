"""The port's hand-off on the CPU: the needed rows stream to the host in
chunks (handoff.PendingFetch, fmax_ooc.OocMesh.land_stream), a waiter
thread advances the rows_ready watermark (handoff.StreamState), and the C
sweep starts on the delivered prefix.  On the CPU a copy is made by the
thread that waits for it (handoff.HostCopy), so these tests drive the same
code as a card does.

- The products read through the StreamingVel views before the join,
  against the JAX package's: on the dense engine (classic, and f(R) with
  RECOMPUTE: 4 sets) on JAX's delta, against its run_fmax with
  sparse_transfer=True; on the out-of-core engine (one device, 2 CPU
  shards; classic and f(R) with RECOMPUTE) against its run_fmax_ooc; every
  set, with the tolerances below.  run_pipeline's dump, written after the
  join, holds the products, and a restart from it (ReadProductsFromDumps)
  writes the first run's files byte for byte (catalogs, mass functions,
  histories, the past light cone and n(z)).
- The dense hand-off's cell indices land as the sort's int64: sp.ci is
  int64, C-contiguous and a view of the page-locked block that F follows
  (no array made on the host), equal element for element to the needed
  cells of the run's Fmax in (-F, cell) order and to the JAX package's
  PendingFetch on the same Fmax.
- The watermark gates the sweep: with _STREAM_TEST_DELAY seconds before
  each chunk lands, the catalogs of one box and of 2x1x1 sub-boxes,
  single- and two-turn, equal those of a run joined before its sweep
  (counters, names and masses exactly, positions within 1e-5), the run
  takes longer than delay x N_CHUNKS / 2, and the sweeps report time
  spent waiting on the watermark.
- Against the JAX package: its run_fmax with sparse_transfer=True and
  transfer_f16=False (its PendingFetch on the CPU) against the port's
  run_fmax on JAX's delta, and its run_fmax_ooc(overlap=True) against the
  port's, with the tolerances of test_torch_ooc.py: the needed set equal
  up to max(2, 0.1 %) borderline cells, the common cells in the same order
  (among the cells whose F the two agree on within 1e-3 max(1, |F|), over
  99 % of them, the two orders differ only where F differs by at most
  twice that: near ties), rows within rtol = atol = 3e-3; the catalogs of
  test_torch_pipeline.py: halo counts per output within max(5, 0.5 %).
- A chunk copy that raises makes run_fragmentation and run_pipeline raise
  that error, within a bounded join.
"""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pinocchio_tpu import fmax as jfmax
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fmax import fetch_products_host
from pinocchio_tpu.fmax import run_fmax as jax_run_fmax
from pinocchio_tpu.fmax_ooc import run_fmax_ooc as jax_run_fmax_ooc
from pinocchio_tpu.fragment.driver import \
    run_fragmentation as jax_run_fragmentation
from pinocchio_tpu.io.catalogs import largest_halo_mass as jlargest
from pinocchio_tpu.scaledep import set_scaledep_gm as jax_set_scaledep_gm
from pinocchio_tpu_torch import fmax, fmax_ooc, handoff
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fmax import Smoothing
from pinocchio_tpu_torch.fragment.driver import run_fragmentation
from pinocchio_tpu_torch.fragment.subbox import run_fragmentation_multibox
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.parallel.pfft import make_mesh
from pinocchio_tpu_torch.run import run_pipeline
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
DELAY = 0.02
JOIN_TIMEOUT = 120.0


def _setup(**kw):
    p = Params(**bench_kwargs(N, **kw))
    cosmo = Cosmology(p)
    gm = None
    if getattr(cosmo, "scale_dep", False):
        gm = set_scaledep_gm(p, cosmo, Smoothing.build(p, cosmo),
                             largest_halo_mass(p, cosmo), verbose=False)
    return p, cosmo, gm


@pytest.fixture(scope="module")
def classic():
    return _setup()


@pytest.fixture(scope="module")
def fr():
    return _setup(**FR)


def _sets(sp):
    return sp.segments if sp.segments is not None else [sp.vel]


def _same_catalogs(fa, fb):
    np.testing.assert_array_equal(fa.counters, fb.counters)
    assert len(fa.catalogs) == len(fb.catalogs)
    for c0, c1 in zip(fa.catalogs, fb.catalogs):
        assert len(c0.name) > 0
        o0, o1 = np.argsort(c0.name), np.argsort(c1.name)
        np.testing.assert_array_equal(c0.name[o0], c1.name[o1])
        np.testing.assert_array_equal(c0.mass[o0], c1.mass[o1])
        np.testing.assert_allclose(c0.x[o0], c1.x[o1], atol=1e-5)


@pytest.fixture(scope="module")
def jax_runs():
    """(engine, model) -> (JAX's run of the model, the port's Params,
    cosmology and scaledep_gm): its dense run_fmax with sparse_transfer
    (its PendingFetch) fetched to the host, or its run_fmax_ooc; each made
    once."""
    cache = {}

    def get(engine, model):
        if (engine, model) not in cache:
            jp, p = params_pair(**bench_kwargs(N, **(FR if model == "fr"
                                                     else {})),
                                ooc_dtype="float32")
            jc, cosmo = JaxCosmology(jp), Cosmology(p)
            jgm = gm = None
            if model == "fr":
                jgm = jax_set_scaledep_gm(jp, jc, jfmax.Smoothing.build(jp, jc),
                                          jlargest(jp, jc), verbose=False)
                gm = set_scaledep_gm(p, cosmo, Smoothing.build(p, cosmo),
                                     largest_halo_mass(p, cosmo),
                                     verbose=False)
            if engine == "dense":
                jp = dataclasses.replace(jp, sparse_transfer=True,
                                         transfer_f16=False)
                jres = fetch_products_host(jp, jax_run_fmax(
                    jp, jc, scaledep_gm=jgm, verbose=False))
            else:
                jres = jax_run_fmax_ooc(dataclasses.replace(
                    jp, sparse_transfer=False, transfer_f16=False), jc,
                    scaledep_gm=jgm, verbose=False, overlap=False)
            cache[engine, model] = jres, p, cosmo, gm
        return cache[engine, model]
    return get


def _jax_sets(jres):
    vel = jres.host_products.vel
    return jres.vel_segments if jres.vel_segments is not None else [vel]


@pytest.mark.parametrize("model", ["classic", "fr"])
def test_dense_overlap_equals_blocking(model, jax_runs):
    """The dense engine's products read through the StreamingVel views
    before the join, every set, against the JAX package's on its delta;
    the join's times in order and the device buffer dropped."""
    jres, p, cosmo, gm = jax_runs("dense", model)
    state = fmax.load_jax_state({"kdensity": np.asarray(jres.kdensity)},
                                "cpu")
    res = fmax.run_fmax(p, cosmo, "cpu", kdensity=state["kdensity"],
                        scaledep_gm=gm)
    sp = res.host_products
    assert isinstance(sp.vel, handoff.StreamingVel)
    assert len(_sets(sp)) == len(_jax_sets(jres)) == (4 if model == "fr"
                                                      else 1)
    _held_to_jax(sp, jres.host_products, ordered=True,
                 sets=(_sets(sp), _jax_sets(jres)))
    times = res.pending_fetch.join()
    assert (0.0 < times["handoff_ci"] <= times["handoff_ci_F"]
            <= times["handoff_first"] <= times["handoff_last"])
    assert res.pending_fetch.buf is None


@pytest.mark.parametrize("model", ["classic", "fr"])
def test_dense_overlap_lands_int64_cell_indices(model, classic, fr):
    """The dense hand-off's cell indices land as the sort's int64: sp.ci
    is int64, C-contiguous and a view of the page-locked block that F
    follows in (no array made on the host), equal element for element to
    the needed cells of the run's Fmax in (-F, cell) order and to the JAX
    package's PendingFetch on the same Fmax."""
    import jax.numpy as jnp
    from pinocchio_tpu.fmax import PendingFetch as JaxPendingFetch
    p, cosmo, gm = classic if model == "classic" else fr
    res = fmax.run_fmax(p, cosmo, "cpu", scaledep_gm=gm)
    sp = res.host_products
    assert sp.ci.dtype == np.int64 and sp.ci.flags.c_contiguous
    assert not sp.ci.flags.owndata and not sp.F.flags.owndata
    assert sp.F.ctypes.data == sp.ci.ctypes.data + sp.ci.nbytes
    assert len(sp.ci) > 0
    F = res.products.Fmax.numpy().ravel()
    want = np.flatnonzero(F >= p.Flast)
    np.testing.assert_array_equal(sp.ci, want[np.lexsort((want, -F[want]))])
    jp, _ = params_pair(**bench_kwargs(N, **(FR if model == "fr" else {})))
    jsp = JaxPendingFetch(jp, jnp.asarray(res.products.Fmax.numpy()), N,
                          expected_keys=[]).finish()
    assert jsp.ci.dtype == np.int64
    np.testing.assert_array_equal(sp.ci, jsp.ci)
    np.testing.assert_array_equal(sp.F, np.asarray(jsp.F))
    res.pending_fetch.join()


@pytest.mark.parametrize("model,shards", [("classic", 1), ("classic", 2),
                                          ("fr", 1), ("fr", 2)])
def test_ooc_overlap_equals_blocking(model, shards, jax_runs):
    """The out-of-core engine's products read through the StreamingVel
    views before the join, every set, against the JAX package's
    run_fmax_ooc (one device); the row phase's timings arrive with the
    join."""
    jres, p, cosmo, gm = jax_runs("ooc", model)
    p = dataclasses.replace(p, ooc="on")
    mesh = None if shards == 1 else make_mesh(shards,
                                              devices=["cpu"] * shards)
    res = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu", scaledep_gm=gm, mesh=mesh)
    assert res.ooc_pending is res.pending_fetch
    assert "lpt_rows" not in res.timings
    sp = res.host_products
    assert isinstance(sp.vel, handoff.StreamingVel)
    assert len(_sets(sp)) == len(_jax_sets(jres)) == (4 if model == "fr"
                                                      else 1)
    _held_to_jax(sp, jres.host_products, ordered=False,
                 sets=(_sets(sp), _jax_sets(jres)))
    timings = res.pending_fetch.join()
    assert "lpt_rows" in timings
    # the row phase is timed on a card's events alone
    assert "rows_device_s" not in timings
    assert timings["handoff_return"] <= timings["handoff_last"]


def _timed(run):
    t0 = time.perf_counter()
    out = run()
    return out, time.perf_counter() - t0


@pytest.mark.parametrize("engine", ["dense", "ooc"])
@pytest.mark.parametrize("boxes", ["one", "single_turn", "two_turn"])
def test_watermark_gates_the_sweep(engine, boxes, classic, monkeypatch):
    """With a slow stream the sweeps start on the delivered prefix and
    wait on the watermark for every later row; if the gate failed they
    would read rows that have not landed and find other halos."""
    p, cosmo, _ = classic
    if engine == "ooc":
        p = dataclasses.replace(p, ooc="on")
    run_fmax = fmax.run_fmax if engine == "dense" else fmax_ooc.run_fmax_ooc

    def frag(res):
        if boxes == "one":
            return run_fragmentation(p, cosmo, res, verbose=False)
        return run_fragmentation_multibox(p, cosmo, res, (2, 1, 1),
                                          two_turn=boxes == "two_turn",
                                          verbose=False)

    joined = run_fmax(p, cosmo, "cpu")
    joined.pending_fetch.join()
    want = frag(joined)
    monkeypatch.setattr(handoff, "_STREAM_TEST_DELAY", DELAY)
    got, elapsed = _timed(lambda: frag(run_fmax(p, cosmo, "cpu")))
    assert elapsed > DELAY * handoff.N_CHUNKS / 2
    assert got.timings["stream_wait"] > 0.0
    _same_catalogs(want, got)


@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_pipeline_files_and_dump_equal_blocking(engine, tmp_path):
    """run_pipeline's dump, written after the join, holds the run's
    products, and a restart from it writes the run's files byte for byte
    (catalogs, mass functions, histories, the past light cone and n(z);
    the FmaxPDF is the dumping run's alone)."""
    kw = dict(bench_kwargs(N), subbox_tasks=2, plc_enabled=True,
              StartingzForPLC=0.05, PLCProvideConeData=True)
    if engine == "ooc":
        kw.update(FR, ooc="on")
    first, again = tmp_path / "first", tmp_path / "again"
    first.mkdir()
    res = run_pipeline(Params(**kw, DumpProducts=True), outdir=str(first),
                       device="cpu", verbose=False)
    assert "fmax_handoff_last" in res["timings"]
    sp = res["fmax"].host_products
    with np.load(first / "DumpProducts" / "products.0.npz") as a:
        if engine == "ooc":
            assert "seg3_v1" in a.files
        np.testing.assert_array_equal(a["ci"], sp.ci)
        np.testing.assert_array_equal(a["F"], sp.F)
        for s, rows in enumerate(_sets(sp)):
            for k in rows:
                name = f"vel_{k}" if s == 0 else f"seg{s}_{k}"
                np.testing.assert_array_equal(a[name], rows[k])
    shutil.copytree(first / "DumpProducts", again / "DumpProducts")
    run_pipeline(Params(**kw, ReadProductsFromDumps=True), outdir=str(again),
                 device="cpu", verbose=False)
    files = sorted(f for f in os.listdir(again) if (again / f).is_file())
    assert files == sorted(f for f in os.listdir(first)
                           if (first / f).is_file()
                           and not f.endswith(".FmaxPDF.out"))
    assert any(f.endswith(".plc.out") for f in files)
    for f in files:
        assert (first / f).read_bytes() == (again / f).read_bytes(), f


def _in_thread(fn):
    """fn() on a thread joined within JOIN_TIMEOUT: (result, error)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:       # noqa: BLE001 - returned
            box["err"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(JOIN_TIMEOUT)
    assert not th.is_alive(), "the run hung"
    return box.get("out"), box.get("err")


class Injected(RuntimeError):
    pass


def _fail_after(monkeypatch, calls: int):
    """HostCopy.wait raises from its calls-th call on."""
    wait = handoff.HostCopy.wait
    seen = [0]

    def failing(self):
        seen[0] += 1
        if seen[0] >= calls:
            raise Injected("injected copy failure")
        return wait(self)
    monkeypatch.setattr(handoff.HostCopy, "wait", failing)


@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_failed_copy_raises_from_the_fragmentation(engine, classic,
                                                   monkeypatch):
    p, cosmo, _ = classic
    if engine == "dense":
        run = fmax.run_fmax
    else:
        p, run = dataclasses.replace(p, ooc="on"), fmax_ooc.run_fmax_ooc
    # past the dense engine's counts, cell indices and F: a table's chunk
    _fail_after(monkeypatch, 5)
    res = run(p, cosmo, "cpu")
    _, err = _in_thread(lambda: run_fragmentation(p, cosmo, res,
                                                  verbose=False))
    assert isinstance(err, Injected)
    _, err = _in_thread(res.pending_fetch.join)
    assert isinstance(err, Injected)


@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_failed_copy_raises_from_run_pipeline(engine, monkeypatch, tmp_path):
    p = Params(**bench_kwargs(N, subbox_tasks=2,
                              ooc="on" if engine == "ooc" else "off"))
    _fail_after(monkeypatch, 7)
    _, err = _in_thread(lambda: run_pipeline(p, outdir=str(tmp_path),
                                             device="cpu", verbose=False))
    assert isinstance(err, Injected)


@pytest.fixture(scope="module")
def jax_pair():
    jp, p = params_pair(**bench_kwargs(N), ooc_dtype="float32")
    return jp, JaxCosmology(jp), p, Cosmology(p)


def _held_to_jax(sp, jsp, ordered: bool, sets=None):
    """The port's products against the JAX package's (module docstring);
    sets: the pairs of displacement sets to hold (default the first)."""
    assert len(np.setxor1d(sp.ci, jsp.ci)) <= max(2, 1e-3 * len(jsp.ci))
    _, io, ij = np.intersect1d(sp.ci, jsp.ci, return_indices=True)
    for mine, theirs in zip(*(sets or ([sp.vel], [jsp.vel]))):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            np.testing.assert_allclose(mine[k][io],
                                       np.asarray(theirs[k])[ij],
                                       rtol=3e-3, atol=3e-3)
    if ordered:
        # the common cells whose F the two packages agree on, in the
        # port's order and in JAX's: where the two differ, only near-ties
        # have swapped
        Fp = dict(zip(sp.ci.tolist(), sp.F.tolist()))
        Fj = dict(zip(jsp.ci.tolist(), np.asarray(jsp.F).tolist()))
        agree = {c for c in Fp.keys() & Fj.keys()
                 if abs(Fp[c] - Fj[c]) <= 1e-3 * max(1.0, abs(Fj[c]))}
        assert len(agree) >= 0.99 * len(jsp.ci)
        a = np.array([c for c in sp.ci.tolist() if c in agree])
        b = np.array([c for c in jsp.ci.tolist() if c in agree])
        fa = np.array([Fp[c] for c in a.tolist()])
        fb = np.array([Fp[c] for c in b.tolist()])
        diff = a != b
        assert np.all(np.abs(fa - fb)[diff]
                      <= 2e-3 * np.maximum(1.0, np.abs(fa[diff])))


def _counts_held(p, jfrag, frag):
    for s, m in zip(jfrag.catalogs, frag.catalogs):
        ns = int((s.mass >= p.MinHaloMass).sum())
        nm = int((m.mass >= p.MinHaloMass).sum())
        assert ns > 0
        assert abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)


def test_dense_overlap_against_jax_pending_fetch(jax_pair):
    jp, jc, p, cosmo = jax_pair
    jp = dataclasses.replace(jp, sparse_transfer=True, transfer_f16=False)
    jres = jax_run_fmax(jp, jc, verbose=False)
    assert jres.pending_fetch is not None
    jres = fetch_products_host(jp, jres)
    state = fmax.load_jax_state({"kdensity": np.asarray(jres.kdensity)},
                                "cpu")
    res = fmax.run_fmax(p, cosmo, "cpu", kdensity=state["kdensity"])
    assert res.pending_fetch is not None
    _held_to_jax(res.host_products, jres.host_products, ordered=True)
    _counts_held(p, jax_run_fragmentation(jp, jc, jres, verbose=False),
                 run_fragmentation(p, cosmo, res, verbose=False))
    res.pending_fetch.join()


def test_ooc_overlap_against_jax_overlap(jax_pair):
    jp, jc, p, cosmo = jax_pair
    jres = jax_run_fmax_ooc(dataclasses.replace(
        jp, sparse_transfer=False, transfer_f16=False), jc, verbose=False,
        overlap=True)
    res = fmax_ooc.run_fmax_ooc(dataclasses.replace(p, ooc="on"), cosmo,
                                "cpu")
    assert jres.ooc_pending is not None and res.pending_fetch is not None
    jfrag = jax_run_fragmentation(jp, jc, jres, verbose=False)
    jres.ooc_pending.join()
    frag = run_fragmentation(p, cosmo, res, verbose=False)
    res.pending_fetch.join()
    # JAX's out-of-core rows are in storage order, the port's in the
    # sweep's
    _held_to_jax(res.host_products, jres.host_products, ordered=False)
    _counts_held(p, jfrag, frag)


def test_stream_state_watermark_is_the_least_prefix():
    """Two tables whose chunks land in (chunk, table) order: after each
    chunk ``ready`` is the least prefix delivered over both tables, and
    join() returns once both have landed whole."""
    src = {k: torch.arange(30, dtype=torch.float32).reshape(10, 3) + i
           for i, k in enumerate(("a", "b"))}
    copier = handoff.CopyStream("cpu")
    st = handoff.StreamState(10, ["a", "b"])
    for k in src:
        st.attach(k, np.zeros((10, 3), np.float32))
    b = handoff.chunk_bounds(10, 2)
    copies = []
    for i in range(2):
        for k in ("a", "b"):
            dst = torch.from_numpy(st.buffer(k))
            copies.append(copier.copy(dst[b[i]:b[i + 1]],
                                      src[k][b[i]:b[i + 1]]))
            st.enqueue(k, b[i + 1], copies[-1])
    times = st.join()
    assert st.ready[0] == 10
    assert all(c._args is None for c in copies)
    for k in src:
        np.testing.assert_array_equal(st.buffer(k), src[k].numpy())
    assert 0.0 < times["first"] <= times["last"]
