"""The pool of page-locked blocks behind handoff.pinned_empty, on the CPU
through a stub kernel library (host_alloc / host_free over ctypes
buffers, in place of cudaHostAlloc and cudaFreeHost):

- a block whose last array went is handed out again with no host_alloc,
  counted as pinned_reuse and not as pinned_alloc, and not while a view of
  it lives or a copy event recorded against it has not completed;
- a request of n bytes takes the smallest idle block of n to n + n/8
  bytes; a miss allocates n plus handoff.PINNED_HEADROOM of it, rounded
  down to the alignment;
- idle and live bytes never pass the live bytes' high-water mark: a miss
  releases idle blocks first; release_pinned() frees every idle block;
- takes and returns from many threads and from gc under the counters'
  lock lose nothing and hand nothing out twice.
"""

import ctypes
import gc
import sys
import threading

import numpy as np
import pytest

from pinocchio_tpu_torch import handoff, kernels

MIB2 = handoff.PINNED_ALIGN
JOIN_TIMEOUT = 60.0


class _StubLib:
    def __init__(self):
        self.live = {}
        self.lock = threading.Lock()

    def host_alloc(self, nbytes):
        buf = ctypes.create_string_buffer(nbytes)
        ptr = ctypes.addressof(buf)
        with self.lock:
            self.live[ptr] = buf
        return ptr

    def host_free(self, ptr):
        with self.lock:
            del self.live[ptr]


class _Event:
    """A copy event whose completion the test sets."""

    def __init__(self, done=False):
        self.done = done

    def query(self):
        return self.done


@pytest.fixture
def stub(monkeypatch):
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


def _ptr(arr):
    return arr.__array_interface__["data"][0]


def _footprint():
    pool = handoff._POOL
    with handoff._HOST_LOCK:
        pool._drain()
        return sum(m.nbytes for m in pool.idle) + pool.live_bytes, pool.high


def test_a_dropped_block_is_handed_out_again(stub):
    before = _totals()
    a = handoff.pinned_empty((MIB2,), np.uint8)
    ptr = _ptr(a)
    del a
    b = handoff.pinned_empty((1000, 3), np.float32)     # 12,000 bytes
    assert _ptr(b) == ptr and b.shape == (1000, 3)
    assert len(stub.live) == 1
    assert _delta(before, "pinned_alloc_calls_total") == 1
    assert _delta(before, "pinned_reuse_calls_total") == 1
    assert _delta(before, "pinned_reuse_bytes_total") == MIB2
    assert _delta(before, "pinned_reuse_seconds_total") >= 0.0
    assert _delta(before, "pinned_free_calls_total") == 0


def test_no_reuse_while_a_view_lives(stub):
    a = handoff.pinned_empty((MIB2,), np.uint8)
    view = a[10:20]
    ptr = _ptr(a)
    del a
    b = handoff.pinned_empty((MIB2,), np.uint8)
    assert _ptr(b) != ptr and len(stub.live) == 2
    del view
    c = handoff.pinned_empty((MIB2,), np.uint8)
    assert _ptr(c) == ptr


def test_no_reuse_before_the_copies_land(stub):
    """A block given back with a copy in flight into it (a pending fetch
    dropped before its join) is skipped until the last event of every
    stream has completed (a query, never a wait), though it is the
    smallest fit."""
    spare = handoff.pinned_empty((18 * MIB2,), np.uint8)
    a = handoff.pinned_empty((16 * MIB2,), np.uint8)
    ptr, ptr_spare = _ptr(a), _ptr(spare)
    first, last = _Event(), _Event()
    handoff._POOL.note_copy(ptr + 100, "copy", first)
    handoff._POOL.note_copy(ptr + 16 * MIB2 - 1, "copy", last)  # replaces
    handoff._POOL.note_copy(ptr, "other", _Event(done=True))
    del a, spare
    before = _totals()
    b = handoff.pinned_empty((16 * MIB2,), np.uint8)
    assert _ptr(b) == ptr_spare
    del b
    c = handoff.pinned_empty((16 * MIB2,), np.uint8)
    assert _ptr(c) == ptr_spare
    last.done = True
    d = handoff.pinned_empty((16 * MIB2,), np.uint8)
    assert _ptr(d) == ptr
    assert _delta(before, "pinned_alloc_calls_total") == 0
    assert _delta(before, "pinned_reuse_calls_total") == 3


def test_note_copy_outside_the_pool_is_ignored(stub):
    a = handoff.pinned_empty((MIB2,), np.uint8)
    handoff._POOL.note_copy(_ptr(a) + MIB2, "copy", _Event())  # past it
    plain = np.empty(10)
    handoff._POOL.note_copy(plain.ctypes.data, "copy", _Event())
    ptr = _ptr(a)
    del a
    assert _ptr(handoff.pinned_empty((MIB2,), np.uint8)) == ptr


@pytest.mark.parametrize("size,request_,fits", [
    (9 * MIB2, 8 * MIB2, True),            # n + n/8 exactly
    (10 * MIB2, 8 * MIB2, False),          # past n + n/8
    (8 * MIB2, 8 * MIB2, True),
    (8 * MIB2, 9 * MIB2, False),           # too small
    (4096 * 9, 4096 * 8, True),            # the FmaxPDF's alignment
    (4096 * 10, 4096 * 8, False)])
def test_the_waste_bound(stub, size, request_, fits):
    align = 4096 if size < MIB2 else MIB2
    a = handoff.pinned_empty((size,), np.uint8, align)
    ptr = _ptr(a)
    del a
    before = _totals()
    b = handoff.pinned_empty((request_,), np.uint8, align)
    if fits:
        assert _ptr(b) == ptr
    assert _delta(before, "pinned_reuse_calls_total") == int(fits)
    assert _delta(before, "pinned_alloc_calls_total") == int(not fits)


def test_the_smallest_fit(stub):
    sizes = (20, 17, 18, 16)   # in 2 MiB units, under the headroom's 32
    arrs = [handoff.pinned_empty((s * MIB2,), np.uint8) for s in sizes]
    ptrs = {s: _ptr(a) for s, a in zip(sizes, arrs)}
    del arrs
    before = _totals()
    got = []
    held = []
    for _ in range(3):
        # 17 units: 17 and 18 fit, 20 passes 17 + 17/8, 16 is too small
        held.append(handoff.pinned_empty((17 * MIB2 - 5,), np.uint8))
        got.append(next((s for s, p in ptrs.items()
                         if p == _ptr(held[-1])), None))
    assert got[:2] == [17, 18]
    assert _delta(before, "pinned_reuse_calls_total") == 2
    assert _delta(before, "pinned_alloc_calls_total") == 1


@pytest.mark.parametrize("nbytes,align,size", [
    (1, MIB2, MIB2),                           # under 32 units: none
    (31 * MIB2, MIB2, 31 * MIB2),
    (32 * MIB2, MIB2, 33 * MIB2),
    (64 * MIB2 - 7, MIB2, 66 * MIB2),
    (100 * 4096, 4096, 103 * 4096),
    (1000, 4096, 4096)])
def test_the_headroom_on_a_miss(stub, nbytes, align, size):
    before = _totals()
    arr = handoff.pinned_empty((nbytes,), np.uint8, align)
    assert arr.nbytes == nbytes
    assert _delta(before, "pinned_alloc_bytes_total") == size
    assert size - -(-nbytes // align) * align <= (
        handoff.PINNED_HEADROOM * nbytes + align)
    # the block serves its own size again
    ptr = _ptr(arr)
    del arr
    assert _ptr(handoff.pinned_empty((nbytes,), np.uint8, align)) == ptr


def test_a_miss_releases_idle_blocks_first(stub):
    a = handoff.pinned_empty((4 * MIB2,), np.uint8)
    b = handoff.pinned_empty((4 * MIB2,), np.uint8)
    c = handoff.pinned_empty((2 * MIB2,), np.uint8)
    assert _footprint() == (10 * MIB2, 10 * MIB2)
    del a, b
    before = _totals()
    # 8 units with both idle blocks kept would pass the mark of 10
    d = handoff.pinned_empty((8 * MIB2,), np.uint8)
    assert _delta(before, "pinned_free_calls_total") == 2
    assert _delta(before, "pinned_free_bytes_total") == 8 * MIB2
    assert len(stub.live) == 2
    assert _footprint() == (10 * MIB2, 10 * MIB2)
    del c, d


def test_a_miss_keeps_what_fits_under_the_mark(stub):
    a = handoff.pinned_empty((4 * MIB2,), np.uint8)
    b = handoff.pinned_empty((4 * MIB2,), np.uint8)
    c = handoff.pinned_empty((2 * MIB2,), np.uint8)
    ptr_c = _ptr(c)
    del a, c                          # idle: a's, then c's
    before = _totals()
    # neither fits one unit; a's, the older, goes and c's stays: 7 <= 10
    d = handoff.pinned_empty((MIB2,), np.uint8)
    assert _delta(before, "pinned_free_calls_total") == 1
    assert _delta(before, "pinned_free_bytes_total") == 4 * MIB2
    assert _footprint() == (7 * MIB2, 10 * MIB2)
    assert ptr_c in stub.live
    # a miss that passes the mark raises it
    e = handoff.pinned_empty((9 * MIB2,), np.uint8)
    assert _footprint() == (14 * MIB2, 14 * MIB2)
    del b, d, e


def test_the_footprint_follows_the_live_peak(stub):
    """Random takes and drops of sizes that drift, as the needed count
    does from seed to seed (in 4 KiB units, from under to past the 32
    units where the headroom starts): idle and live bytes never pass the
    live high-water mark, and the library holds exactly them."""
    unit = 4096
    rng = np.random.default_rng(7)
    held = []
    peak = 0
    for _ in range(400):
        if held and (len(held) > 6 or rng.random() < 0.45):
            held.pop(int(rng.integers(len(held))))
        else:
            units = int(rng.integers(1, 80)) if rng.random() < 0.3 else 48
            drift = int(rng.integers(0, 3 * unit))
            held.append(handoff.pinned_empty((units * unit - drift,),
                                             np.uint8, unit))
        total, high = _footprint()
        peak = max(peak, handoff._POOL.live_bytes)
        assert total <= high == peak
        assert total == sum(len(b) for b in stub.live.values())
        assert handoff._POOL.live_bytes >= sum(
            -(-a.nbytes // unit) * unit for a in held)
    del held


def test_release_pinned_frees_every_idle_block(stub):
    arrs = [handoff.pinned_empty((n * MIB2,), np.uint8) for n in (1, 2, 3)]
    kept = arrs.pop()
    del arrs
    before = _totals()
    handoff.release_pinned()
    assert _delta(before, "pinned_free_calls_total") == 2
    assert _delta(before, "pinned_free_bytes_total") == 3 * MIB2
    assert list(stub.live) == [_ptr(kept)]
    assert _footprint() == (3 * MIB2, 3 * MIB2)
    del kept
    handoff.release_pinned()
    assert not stub.live and _footprint() == (0, 0)


def test_takes_and_returns_from_many_threads(stub):
    """Threads take blocks of a few sizes, fill them with their own mark,
    check it and drop them, while another collects reference cycles of
    blocks under the counters' lock: no block is handed out twice, none is
    lost."""
    nthreads, rounds = 8, 60
    before = _totals()
    owners = {}
    owners_lock = threading.Lock()
    errors = []

    def work(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(rounds):
                n = int(rng.choice([MIB2, 2 * MIB2, 2 * MIB2 - 99]))
                a = handoff.pinned_empty((n,), np.uint8)
                p = _ptr(a)
                with owners_lock:
                    assert p not in owners, "a block handed out twice"
                    owners[p] = tid
                a[:] = tid
                assert (a == tid).all()
                with owners_lock:
                    del owners[p]
                del a
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append(e)

    def cycles():
        for _ in range(rounds // 2):
            holder = [handoff.pinned_empty((MIB2,), np.uint8)]
            holder.append(holder)
            del holder
            with handoff._HOST_LOCK:
                gc.collect()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(nthreads)]
        threads.append(threading.Thread(target=cycles))
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    gc.collect()
    takes = nthreads * rounds + rounds // 2
    assert (_delta(before, "pinned_alloc_calls_total")
            + _delta(before, "pinned_reuse_calls_total")) == takes
    total, high = _footprint()
    assert handoff._POOL.live_bytes == 0 and total <= high
    handoff.release_pinned()
    assert not stub.live
    assert (_delta(before, "pinned_alloc_bytes_total")
            == _delta(before, "pinned_free_bytes_total"))
