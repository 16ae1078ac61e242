"""The port's own spans and host counters (handoff.HOST_COUNTS), on the CPU
unless marked ``cuda``.

- The spans of torch.profiler.record_function that each engine opens, and
  their nesting, under a CPU profiler of a 32^3 run: fmax.ic, fmax.cycle,
  fmax.sort, the counts' and the cell indices' handoff.alloc, fmax.lpt
  (holding each table's handoff.alloc), handoff.finish on the dense
  engine; ooc.<phase> per phase of the out-of-core engine, handoff.alloc
  inside ooc.products and inside each displacement set's ooc.rows_set of
  ooc.lpt_rows, which runs on a thread of its own (seen with the
  profiler's profile_all_threads); a join inside the entry's span opens
  no span of its own.
- The counters through a stub kernel library: page-locked bytes rounded up
  to 2 MiB, one call per block, its release by handoff.release_pinned()
  once its last reference went (the block waits in the pool until then),
  the calling thread's allocation seconds, and a block's __del__ run by gc
  on a thread that holds the counters' lock, which must not deadlock.
- d2h bytes equal to the products' bytes on the CPU copy path, on both
  engines (the out-of-core one on one device and on 2 CPU shards).
- handoff_alloc_s at the return, every ``_total`` key after the join
  (read after the entry or joined at once); the dense LPT's event pair
  resolved into timings["lpt"] at the join, the out-of-core row phase's
  into timings["rows_device_s"]; run.write_cputimes's host lines.
- On the card (``cuda``): a 64^3 realization of each engine reads
  positive page-locked counters, their bytes the products' rounded up to
  2 MiB per buffer, and the dense engine a positive device-timed lpt; the
  out-of-core f(R) row phase a device time within its synced wall time.
"""

import ctypes
import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pinocchio_tpu_torch import fmax, fmax_ooc, handoff, kernels
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fmax import Smoothing
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.ops.compact import PDF_BINS
from pinocchio_tpu_torch.parallel.pfft import make_mesh
from pinocchio_tpu_torch.run import write_cputimes
from pinocchio_tpu_torch.scaledep import set_scaledep_gm

torch.set_num_threads(2)

N = 32
MIB2 = handoff.PINNED_ALIGN
KINDS = ("pinned_alloc", "pinned_free", "d2h")
TOTALS = {f"{k}_{f}_total" for k in KINDS
          for f in ("bytes", "seconds", "calls")}
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
JOIN_TIMEOUT = 30.0


def _setup(n=N, **kw):
    p = Params(GridSize=n, BoxSize=float(n), output_z=[2.0, 1.0, 0.5, 0.0],
               norad=True, plc_enabled=False, **kw)
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


def _run(engine, setup, device="cpu", mesh=None):
    p, cosmo, gm = setup
    if engine == "ooc":
        return fmax_ooc.run_fmax_ooc(dataclasses.replace(p, ooc="on"), cosmo,
                                     device, scaledep_gm=gm, mesh=mesh)
    return fmax.run_fmax(p, cosmo, device, scaledep_gm=gm)


def _join(res):
    res.pending_fetch.join()


def _nsets(res):
    sp = res.host_products
    return 1 if sp.segments is None else len(sp.segments)


def _spans(prof, prefixes=("fmax.", "ooc.", "handoff.", "test.")):
    """[(name, thread, parent span name or None)] of the spans named with
    one of ``prefixes``, in the order they started."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(prefixes):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(prefixes):
            parent = parent.cpu_parent
        out.append((e.name, e.thread, None if parent is None
                    else parent.name))
    return out


# ------------------------------------------------------------------
# spans
# ------------------------------------------------------------------

@pytest.mark.parametrize("model", ["classic", "fr"])
def test_dense_spans_and_nesting(model, classic, fr):
    setup = classic if model == "classic" else fr
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.entry"):
            res = _run("dense", setup)
        _join(res)
    spans = _spans(prof)
    nkeys = len(res.host_products.vel)
    nsets = _nsets(res)
    top = [s for s in spans if s[2] == "test.entry"]
    # before fmax.lpt: the counts, then the cell indices and F
    assert [s[0] for s in top] == ["fmax.ic", "fmax.cycle", "fmax.sort",
                                   "handoff.alloc", "handoff.alloc",
                                   "fmax.lpt", "handoff.finish"]
    # inside fmax.lpt: every set's tables
    inner = [s[0] for s in spans if s[2] == "fmax.lpt"]
    assert inner == ["handoff.alloc"] * (nkeys * nsets)
    assert len(spans) == 1 + len(top) + len(inner)
    assert len({s[1] for s in spans}) == 1
    # a realization opens about 50 spans or fewer
    assert len(spans) <= 50


def test_dense_blocking_spans(classic):
    """A run joined inside the entry's span: the join opens no span, and
    the entry's spans are those of the run alone."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.entry"):
            res = _run("dense", classic)
            _join(res)
    assert res.pending_fetch.buf is None
    assert [s[0] for s in _spans(prof) if s[2] in (None, "test.entry")] == [
        "test.entry", "fmax.ic", "fmax.cycle", "fmax.sort", "handoff.alloc",
        "handoff.alloc", "fmax.lpt", "handoff.finish"]


@pytest.mark.parametrize("model", ["classic", "fr"])
@pytest.mark.parametrize("streamed", [True, False])
def test_ooc_spans_and_nesting(streamed, model, classic, fr):
    """streamed: the entry returns before the row phase ends, joined
    after the entry's span; else joined inside it."""
    from torch._C._profiler import _ExperimentalConfig
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with record_function("test.entry"):
            res = _run("ooc", classic if model == "classic" else fr)
            if not streamed:
                _join(res)
        if streamed:
            _join(res)
    spans = _spans(prof)
    nkeys = len(res.host_products.vel)
    main = spans[0][1]
    sets = [s for s in spans if s[0] == "ooc.rows_set"]
    phases = [s for s in spans if s[0].startswith("ooc.")
              and s[0] != "ooc.rows_set"]
    assert [s[0] for s in phases] == ["ooc.fmax_loop", "ooc.sources",
                                      "ooc.fold", "ooc.spectra",
                                      "ooc.products", "ooc.lpt_rows"]
    for name, thread, parent in phases[:-1]:
        assert thread == main and parent == "test.entry"
    rows = phases[-1]
    # the row phase runs on its own thread, outside the entry's span
    assert rows[1] != main and rows[2] is None
    # a span a displacement set inside the row phase, on its thread
    assert len(sets) == _nsets(res) == (4 if model == "fr" else 1)
    assert {(s[1], s[2]) for s in sets} == {(rows[1], "ooc.lpt_rows")}
    allocs = [s for s in spans if s[0] == "handoff.alloc"]
    # the cell indices and F in ooc.products, a table a field and set in
    # its set's ooc.rows_set, each on its phase's thread
    assert [s[2] for s in allocs] == (["ooc.products"] * 2
                                      + ["ooc.rows_set"] * nkeys * len(sets))
    assert {s[1] for s in allocs[:2]} == {main}
    assert {s[1] for s in allocs[2:]} == {rows[1]}
    assert len(spans) <= 50


# ------------------------------------------------------------------
# the host counters through a stub library
# ------------------------------------------------------------------

class _StubLib:
    """host_alloc / host_free over ctypes buffers, in place of
    cudaHostAlloc and cudaFreeHost."""

    def __init__(self):
        self.live = {}

    def host_alloc(self, nbytes):
        buf = ctypes.create_string_buffer(nbytes)
        ptr = ctypes.addressof(buf)
        self.live[ptr] = buf
        return ptr

    def host_free(self, ptr):
        del self.live[ptr]


@pytest.fixture
def stub(monkeypatch):
    """The stub library, over a pool with no idle block (released before
    and after)."""
    handoff.release_pinned()
    lib = _StubLib()
    monkeypatch.setattr(kernels, "_LIB", lib)
    yield lib
    gc.collect()
    handoff.release_pinned()


def _totals():
    return handoff.host_totals()


def _delta(before, key):
    return _totals()[key] - before[key]


@pytest.mark.parametrize("nbytes,rounded", [
    (1, MIB2), (MIB2 - 1, MIB2), (MIB2, MIB2), (MIB2 + 1, 2 * MIB2),
    (5 * MIB2 + 12, 6 * MIB2)])
def test_pinned_counters_round_and_count(stub, nbytes, rounded):
    before = _totals()
    t0 = handoff.thread_alloc_seconds()
    arr = handoff.pinned_empty((nbytes,), np.uint8)
    assert arr.nbytes == nbytes and len(stub.live) == 1
    assert _delta(before, "pinned_alloc_bytes_total") == rounded
    assert _delta(before, "pinned_alloc_calls_total") == 1
    dt = _delta(before, "pinned_alloc_seconds_total")
    assert dt >= 0.0
    assert handoff.thread_alloc_seconds() - t0 == pytest.approx(dt)
    assert _delta(before, "pinned_free_calls_total") == 0
    view = arr[1:]
    del arr
    assert _delta(before, "pinned_free_calls_total") == 0   # a view holds it
    del view
    assert _delta(before, "pinned_free_calls_total") == 0   # in the pool
    handoff.release_pinned()
    assert not stub.live
    assert _delta(before, "pinned_free_bytes_total") == rounded
    assert _delta(before, "pinned_free_calls_total") == 1
    assert _delta(before, "pinned_free_seconds_total") >= 0.0


def test_thread_alloc_seconds_is_per_thread(stub):
    mine = handoff.thread_alloc_seconds()
    got = {}

    def other():
        a = handoff.pinned_empty((MIB2 * 3,), np.uint8)
        got["s"] = handoff.thread_alloc_seconds()
        del a

    t = threading.Thread(target=other)
    t.start()
    t.join(JOIN_TIMEOUT)
    assert not t.is_alive() and got["s"] > 0.0
    assert handoff.thread_alloc_seconds() == mine


def test_del_from_gc_under_the_counters_lock(stub):
    """A block in a reference cycle is given back to the pool by
    gc.collect() on a thread that holds the counters' lock (a plain Lock
    around the pool would deadlock there), and release_pinned() frees
    it."""
    before = _totals()
    was = gc.isenabled()
    gc.disable()
    try:
        holder = [handoff.pinned_empty((100,), np.float32)]
        holder.append(holder)
        del holder
        assert _delta(before, "pinned_free_calls_total") == 0
        done = threading.Event()

        def collect():
            with handoff._HOST_LOCK:
                gc.collect()
                done.set()

        t = threading.Thread(target=collect, daemon=True)
        t.start()
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive() and done.is_set()
    finally:
        if was:
            gc.enable()
    assert _delta(before, "pinned_free_calls_total") == 0
    handoff.release_pinned()
    assert _delta(before, "pinned_free_calls_total") == 1
    assert _delta(before, "pinned_free_bytes_total") == MIB2
    assert not stub.live


def test_count_host_from_many_threads():
    """No update is lost when threads count at once."""
    before = _totals()
    nthreads, each = 16, 500

    def work():
        for _ in range(each):
            handoff.count_host("d2h", 3)

    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _delta(before, "d2h_calls_total") == nthreads * each
    assert _delta(before, "d2h_bytes_total") == 3 * nthreads * each


# ------------------------------------------------------------------
# bytes to the host on the CPU copy path
# ------------------------------------------------------------------

@pytest.mark.parametrize("engine,shards", [("dense", 1), ("ooc", 1),
                                           ("ooc", 2)])
def test_d2h_bytes_equal_the_products(engine, shards, classic):
    mesh = (None if shards == 1
            else make_mesh(shards, devices=["cpu"] * shards))
    before = _totals()
    res = _run(engine, classic, mesh=mesh)
    _join(res)
    c = res.host_products.ci.size
    tables = _nsets(res) * len(res.host_products.vel) * 12 * c
    # int64 cell indices and float32 F, then the tables; the dense
    # engine's FmaxPDF counts besides
    expected = 12 * c + tables + (PDF_BINS * 8 if engine == "dense" else 0)
    assert _delta(before, "d2h_bytes_total") == expected
    # no page-locked memory on the CPU
    assert _delta(before, "pinned_alloc_calls_total") == 0


# ------------------------------------------------------------------
# timings
# ------------------------------------------------------------------

@pytest.mark.parametrize("engine,streamed", [("dense", True),
                                             ("dense", False),
                                             ("ooc", True), ("ooc", False)])
def test_timings_after_join(engine, streamed, classic):
    """streamed: read at the return, then after the join; else joined at
    once."""
    res = _run(engine, classic)
    if streamed:
        assert res.timings["handoff_alloc_s"] == 0.0   # nothing page-locked
        assert not TOTALS & res.timings.keys()
    _join(res)
    assert res.timings["handoff_alloc_s"] == 0.0
    t = res.timings
    assert TOTALS <= t.keys()
    assert t["d2h_bytes_total"] > 0 and t["d2h_calls_total"] > 0
    assert t["lpt"] > 0.0


class _Event:
    """A stand-in for a card's timing event, at ``ms``."""
    synced = 0

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        _Event.synced += 1

    def elapsed_time(self, other):
        return other.ms - self.ms


def _stand_in_timer(marks):
    """An EventTimer whose records append the stand-ins of ``marks`` (one
    list of cards' events each), as it would on cards."""
    todo = list(marks)

    class Timer(handoff.EventTimer):
        def record(self):
            self.marks.append(todo.pop(0))
    return Timer


def test_join_resolves_the_lpt_events(classic, monkeypatch):
    """The dense engine's join reads the device's LPT time from the event
    pair recorded around the LPT (stand-ins here for the card's timing
    events), once the end has synchronized."""
    monkeypatch.setattr(fmax, "EventTimer",
                        _stand_in_timer([[_Event(0.0)], [_Event(250.0)]]))
    synced = _Event.synced
    res = _run("dense", classic)
    cpu_lpt = res.timings["lpt"]
    out = res.pending_fetch.join()
    assert _Event.synced == synced + 1 and out["lpt"] == 0.25
    assert res.timings["lpt"] == 0.25 != cpu_lpt


def test_join_resolves_the_row_events(classic, monkeypatch):
    """The out-of-core engine's join reads the row phase's device time
    from the events recorded on its thread, the longest of its cards'
    event pairs (stand-ins here for the card's timing events)."""
    assert handoff.EventTimer(["cpu"], "k").timings() == {}
    monkeypatch.setattr(fmax_ooc, "EventTimer", _stand_in_timer(
        [[_Event(0.0), _Event(10.0)], [_Event(150.0), _Event(260.0)]]))
    res = _run("ooc", classic)
    assert "rows_device_s" not in res.timings
    out = res.pending_fetch.join()
    assert out["rows_device_s"] == pytest.approx(0.25)
    assert res.timings["rows_device_s"] == out["rows_device_s"]


def test_write_cputimes_host_lines(capsys):
    write_cputimes(dict(total=10.0, pinned_alloc=2.5, pinned_free=1.25,
                        pinned_reuse=0.0625, pinned_alloc_gib=4.5,
                        pinned_free_gib=4.25, pinned_reuse_gib=9.25,
                        d2h_gib=4.5))
    out = capsys.readouterr().out
    assert "HOST MEMORY" in out
    for label, text in (("page-locked allocation", "2.50 s"),
                        ("page-locked reuse", "0.06 s"),
                        ("page-locked release", "1.25 s"),
                        ("page-locked allocated", "4.50 GiB"),
                        ("page-locked reused", "9.25 GiB"),
                        ("page-locked released", "4.25 GiB"),
                        ("copied to the host", "4.50 GiB")):
        line = next(x for x in out.splitlines() if label in x)
        assert text in line


# ------------------------------------------------------------------
# on the card
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked memory and the "
                    "device's timing events")
    return torch.device("cuda", 0)


def _rounded(nbytes):
    return -(-nbytes // MIB2) * MIB2


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_card_counters_and_lpt(dev, engine):
    setup = _setup(64)
    _join(_run(engine, setup, device=dev))        # warm: plans, library
    gc.collect()
    handoff.release_pinned()        # so that every buffer is allocated
    before = _totals()
    res = _run(engine, setup, device=dev)
    _join(res)
    t = res.timings
    c = res.host_products.ci.size
    tables = _nsets(res) * len(res.host_products.vel)
    if engine == "dense":
        # the counts, then the cell indices with F and each table, 12
        # bytes a row
        expected = 4096 + (1 + tables) * _rounded(12 * c)
        assert t["lpt"] > 0.0
    else:
        expected = _rounded(8 * c) + _rounded(4 * c) + tables * _rounded(
            12 * c)
    assert _delta(before, "pinned_alloc_bytes_total") == expected
    assert _delta(before, "pinned_alloc_seconds_total") > 0.0
    assert t["handoff_alloc_s"] > 0.0
    assert _delta(before, "d2h_bytes_total") > 0
    del res
    gc.collect()
    handoff.release_pinned()
    assert _delta(before, "pinned_free_bytes_total") >= expected


@pytest.mark.cuda
def test_card_rows_device_s(dev):
    """f(R) at 64^3 on the out-of-core engine: the row phase's device time,
    read at the join, is positive and within the phase's synced wall
    time."""
    setup = _setup(64, **FR)
    _join(_run("ooc", setup, device=dev))         # warm: plans, library
    res = _run("ooc", setup, device=dev)
    assert "rows_device_s" not in res.timings
    t = res.pending_fetch.join()
    assert _nsets(res) == 4
    assert 0.0 < t["rows_device_s"] <= t["lpt_rows"]
    joined = _run("ooc", setup, device=dev)
    _join(joined)
    b = joined.timings
    assert 0.0 < b["rows_device_s"] <= b["lpt_rows"]


# ------------------------------------------------------------------
# scripts/trace_spans.py on a synthetic chrome trace
# ------------------------------------------------------------------

def test_trace_spans_attributes_kernels_to_spans():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "trace_spans.py")
    spec = importlib.util.spec_from_file_location("trace_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid)
        if corr is not None:
            e["args"] = dict(correlation=corr)
        return e

    events = [
        x("user_annotation", "bench.entry", 0, 1000),
        x("user_annotation", "fmax.cycle", 10, 500),
        x("cpu_op", "aten::fft_irfftn", 20, 100),
        x("cpu_op", "aten::clone", 30, 20),
        x("cpu_op", "aten::copy_", 35, 10),
        x("cuda_runtime", "cudaLaunchKernel", 40, 2, corr=1),
        x("cpu_op", "aten::mul", 200, 10),
        x("cuda_runtime", "cudaLaunchKernel", 205, 2, corr=2),
        x("user_annotation", "fmax.lpt", 600, 100),
        x("cuda_runtime", "cudaLaunchKernel", 650, 2, corr=3),
        # another thread's launch sees that thread's spans alone
        x("cuda_runtime", "cudaLaunchKernel", 45, 2, tid=2, corr=4),
        x("kernel", "void elementwise_kernel_128<2>(int)", 50, 300, tid=7,
          corr=1),
        x("kernel", "void vectorized_elementwise_kernel<4>(int)", 360, 40,
          tid=7, corr=2),
        x("kernel", "window_kernel", 700, 30, tid=7, corr=3),
        x("gpu_memcpy", "Memcpy DtoH", 60, 10, tid=8, corr=4),
        x("kernel", "orphan", 900, 5, tid=7, corr=99),
    ]
    rows = mod.attribute(events)
    assert rows[("fmax.cycle", "aten::fft_irfftn > aten::copy_",
                 "elementwise_kernel_128<2>")] == [pytest.approx(3e-4), 1]
    assert rows[("fmax.cycle", "aten::mul",
                 "vectorized_elementwise_kernel<4>")][1] == 1
    assert rows[("fmax.lpt", "", "window_kernel")][1] == 1
    assert rows[("(no span)", "", "[gpu_memcpy] Memcpy DtoH")][1] == 1
    assert rows[("(no launch in the trace)", "", "orphan")][1] == 1
    assert len(rows) == 5
