"""The port's overlapped hand-off on the CPU: the needed rows stream to the
host in chunks (fmax.PendingFetch, fmax_ooc.OocMesh.land_stream), a waiter
thread advances the rows_ready watermark (fmax._StreamState), and the C
sweep starts on the delivered prefix.  On the CPU a copy is made by the
thread that waits for it (kernels.HostCopy), so these tests drive the same
code as a card does.

- Overlapped against blocking (overlap=False), bit for bit: the cell
  indices, F, every row of every displacement set and the FmaxPDF counts,
  on the dense engine (classic, and f(R) with RECOMPUTE: 4 sets) and on
  the out-of-core engine (one device, 2 CPU shards, f(R) with RECOMPUTE);
  run_pipeline's files (with the past light cone) and dump arrays byte for
  byte.
- The dense hand-off's cell indices land as the sort's int64: sp.ci is
  int64, C-contiguous and a view of the page-locked block beside F (no
  array made on the host), equal element for element to the blocking
  path's and to the JAX package's PendingFetch on the same Fmax.
- The watermark gates the sweep: with _STREAM_TEST_DELAY seconds before
  each chunk lands, the catalogs of one box and of 2x1x1 sub-boxes,
  single- and two-turn, equal the blocking run's (counters, names and
  masses exactly, positions within 1e-5), the run takes longer than
  delay x N_CHUNKS / 2, and the sweeps report time spent waiting on the
  watermark.
- Against the JAX package: its run_fmax with sparse_transfer=True and
  transfer_f16=False (its PendingFetch on the CPU) against the port's
  overlapped run_fmax on JAX's delta, and its run_fmax_ooc(overlap=True)
  against the port's, with the tolerances of test_torch_ooc.py: the needed
  set equal up to max(2, 0.1 %) borderline cells, the common cells in the
  same order (among the cells whose F the two agree on within
  1e-3 max(1, |F|), over 99 % of them, the two orders differ only where F
  differs by at most twice that: near ties), rows within rtol = atol =
  3e-3; the
  catalogs of test_torch_pipeline.py: halo counts per output within
  max(5, 0.5 %).
- A chunk copy that raises makes run_fragmentation and run_pipeline raise
  that error, within a bounded join.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fmax import fetch_products_host
from pinocchio_tpu.fmax import run_fmax as jax_run_fmax
from pinocchio_tpu.fmax_ooc import run_fmax_ooc as jax_run_fmax_ooc
from pinocchio_tpu.fragment.driver import \
    run_fragmentation as jax_run_fragmentation
from pinocchio_tpu_torch import fmax, fmax_ooc, kernels
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


def _same_products(a, b):
    """Two FmaxResults' host products and FmaxPDF counts, bit for bit."""
    sa, sb = a.host_products, b.host_products
    np.testing.assert_array_equal(sa.ci, sb.ci)
    np.testing.assert_array_equal(sa.F, sb.F)
    assert len(_sets(sa)) == len(_sets(sb))
    for x, y in zip(_sets(sa), _sets(sb)):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    np.testing.assert_array_equal(a.pdf_hist, b.pdf_hist)


def _same_catalogs(fa, fb):
    np.testing.assert_array_equal(fa.counters, fb.counters)
    assert len(fa.catalogs) == len(fb.catalogs)
    for c0, c1 in zip(fa.catalogs, fb.catalogs):
        assert len(c0.name) > 0
        o0, o1 = np.argsort(c0.name), np.argsort(c1.name)
        np.testing.assert_array_equal(c0.name[o0], c1.name[o1])
        np.testing.assert_array_equal(c0.mass[o0], c1.mass[o1])
        np.testing.assert_allclose(c0.x[o0], c1.x[o1], atol=1e-5)


@pytest.mark.parametrize("model", ["classic", "fr"])
def test_dense_overlap_equals_blocking(model, classic, fr):
    p, cosmo, gm = classic if model == "classic" else fr
    blocking = fmax.run_fmax(p, cosmo, "cpu", scaledep_gm=gm, overlap=False)
    res = fmax.run_fmax(p, cosmo, "cpu", scaledep_gm=gm)
    assert blocking.pending_fetch is None
    assert isinstance(res.host_products.vel, fmax.StreamingVel)
    assert len(_sets(res.host_products)) == (4 if model == "fr" else 1)
    _same_products(res, blocking)
    times = res.pending_fetch.join()
    assert (0.0 < times["handoff_ci"] <= times["handoff_ci_F"]
            <= times["handoff_first"] <= times["handoff_last"])
    assert res.pending_fetch.buf is None


@pytest.mark.parametrize("model", ["classic", "fr"])
def test_dense_overlap_lands_int64_cell_indices(model, classic, fr):
    """The overlapped dense hand-off's cell indices land as the sort's
    int64: sp.ci is int64, C-contiguous and a view of the page-locked
    block they landed in (no array made on the host), equal element for
    element to the blocking path's and to the JAX package's PendingFetch
    on the same Fmax; F lands in the same block."""
    import jax.numpy as jnp
    from pinocchio_tpu.fmax import PendingFetch as JaxPendingFetch
    p, cosmo, gm = classic if model == "classic" else fr
    blocking = fmax.run_fmax(p, cosmo, "cpu", scaledep_gm=gm, overlap=False)
    res = fmax.run_fmax(p, cosmo, "cpu", scaledep_gm=gm)
    sp = res.host_products
    block = res.pending_fetch._ci_F.numpy()
    assert sp.ci.dtype == np.int64 and sp.ci.flags.c_contiguous
    assert not sp.ci.flags.owndata
    assert np.shares_memory(sp.ci, block) and np.shares_memory(sp.F, block)
    assert len(sp.ci) > 0
    np.testing.assert_array_equal(sp.ci, blocking.host_products.ci)
    jp, _ = params_pair(**bench_kwargs(N, **(FR if model == "fr" else {})))
    jsp = JaxPendingFetch(jp, jnp.asarray(res.products.Fmax.numpy()), N,
                          expected_keys=[]).finish()
    assert jsp.ci.dtype == np.int64
    np.testing.assert_array_equal(sp.ci, jsp.ci)
    np.testing.assert_array_equal(sp.F, np.asarray(jsp.F))
    res.pending_fetch.join()


@pytest.mark.parametrize("model,shards", [("classic", 1), ("classic", 2),
                                          ("fr", 1), ("fr", 2)])
def test_ooc_overlap_equals_blocking(model, shards, classic, fr):
    p, cosmo, gm = classic if model == "classic" else fr
    p = dataclasses.replace(p, ooc="on")
    mesh = None if shards == 1 else make_mesh(shards,
                                              devices=["cpu"] * shards)
    blocking = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu", scaledep_gm=gm,
                                     mesh=mesh, overlap=False)
    res = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu", scaledep_gm=gm, mesh=mesh)
    assert blocking.ooc_pending is None and "lpt_rows" in blocking.timings
    assert "lpt_rows" not in res.timings
    _same_products(res, blocking)
    timings = res.ooc_pending.join()
    assert "lpt_rows" in timings
    # the row phase is timed on a card's events alone
    assert "rows_device_s" not in timings
    assert "rows_device_s" not in blocking.timings
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

    want = frag(run_fmax(p, cosmo, "cpu", overlap=False))
    monkeypatch.setattr(fmax, "_STREAM_TEST_DELAY", DELAY)
    got, elapsed = _timed(lambda: frag(run_fmax(p, cosmo, "cpu")))
    assert elapsed > DELAY * fmax.N_CHUNKS / 2
    assert got.timings["stream_wait"] > 0.0
    _same_catalogs(want, got)


@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_pipeline_files_and_dump_equal_blocking(engine, tmp_path):
    """run_pipeline overlapped writes the blocking run's files byte for
    byte (catalogs, mass functions, histories, FmaxPDF, the past light
    cone and n(z)), the dump (written after fragmentation) with the same
    arrays."""
    kw = dict(bench_kwargs(N), subbox_tasks=2, DumpProducts=True,
              plc_enabled=True, StartingzForPLC=0.05,
              PLCProvideConeData=True)
    if engine == "ooc":
        kw.update(FR, ooc="on")
    p = Params(**kw)
    outs = {}
    for overlap in (False, True):
        out = tmp_path / str(overlap)
        out.mkdir()
        res = run_pipeline(p, outdir=str(out), device="cpu", verbose=False,
                           overlap=overlap)
        outs[overlap] = out
        assert ("fmax_handoff_last" in res["timings"]) == overlap
    files = sorted(f for f in os.listdir(outs[False])
                   if (outs[False] / f).is_file())
    assert files == sorted(f for f in os.listdir(outs[True])
                           if (outs[True] / f).is_file())
    assert any(f.endswith(".plc.out") for f in files)
    for f in files:
        assert ((outs[False] / f).read_bytes()
                == (outs[True] / f).read_bytes()), f
    with np.load(outs[False] / "DumpProducts" / "products.0.npz") as a, \
            np.load(outs[True] / "DumpProducts" / "products.0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        if engine == "ooc":
            assert "seg3_v1" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


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
    wait = kernels.HostCopy.wait
    seen = [0]

    def failing(self):
        seen[0] += 1
        if seen[0] >= calls:
            raise Injected("injected copy failure")
        return wait(self)
    monkeypatch.setattr(kernels.HostCopy, "wait", failing)


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
    pending = res.pending_fetch or res.ooc_pending
    _, err = _in_thread(pending.join)
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


def _held_to_jax(sp, jsp, ordered: bool):
    """The port's products against the JAX package's (module docstring)."""
    assert len(np.setxor1d(sp.ci, jsp.ci)) <= max(2, 1e-3 * len(jsp.ci))
    _, io, ij = np.intersect1d(sp.ci, jsp.ci, return_indices=True)
    for k in sp.vel:
        np.testing.assert_allclose(sp.vel[k][io], np.asarray(jsp.vel[k])[ij],
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
    assert jres.ooc_pending is not None and res.ooc_pending is not None
    jfrag = jax_run_fragmentation(jp, jc, jres, verbose=False)
    jres.ooc_pending.join()
    frag = run_fragmentation(p, cosmo, res, verbose=False)
    res.ooc_pending.join()
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
    copier = kernels.CopyStream("cpu")
    st = fmax._StreamState(10, ["a", "b"])
    for k in src:
        st.attach(k, np.zeros((10, 3), np.float32))
    b = fmax._chunk_bounds(10, 2)
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
