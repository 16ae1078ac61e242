"""The hand-off: device-to-host memory and copies, for both fmax engines.

Page-locked host buffers (``pinned_empty``, ``host_empty``) are served from
a pool of blocks that the last array over them gave back (_PinnedPool).
Each card has one device-to-host copy stream (``copy_stream``); a copy on it
ends in an event (``HostCopy``, ``CopyStream``).  A displacement set's rows
stream into their host buffers in N_CHUNKS prefix chunks a table, and a
waiter thread advances the rows_ready watermark that the C sweep starts on
(StreamState, read through StreamingVel views).  PendingFetch is one
engine's hand-off in flight: its copies, an optional background thread (the
out-of-core row phase) and one join() that assembles the hand-off's
timings.

``HOST_COUNTS`` counts this machinery's work, in the shape of
``parallel.multihost.TRAFFIC`` (bytes, seconds, calls per kind), as process
totals that are never reset (a rate is the difference of two readings,
``host_totals``): ``pinned_alloc`` and ``pinned_free`` each page-locked
block allocated or released (bytes after the 2 MiB rounding, host seconds
inside cudaHostAlloc and cudaFreeHost), ``pinned_reuse`` each block handed
out again from the pool (its bytes, host seconds in the search), ``d2h``
each device-to-host copy made by ``HostCopy`` or ``to_host`` or counted by
a caller that copies on its own (bytes and calls).
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import kernels

HOST_COUNTS = {kind: dict(bytes=0, seconds=0.0, calls=0)
               for kind in ("pinned_alloc", "pinned_free", "pinned_reuse",
                            "d2h")}
# re-entrant: the page-locked pool counts (count_host) under it
_HOST_LOCK = threading.RLock()
# per thread: seconds in page-locked allocation (thread_alloc_seconds)
_THREAD = threading.local()
_LOCK = threading.Lock()           # the copy streams

N_CHUNKS = 16       # d2h chunks per displacement table (the watermark's grain)
_STREAM_TEST_DELAY = 0.0    # tests: seconds added before each chunk lands


def count_host(kind: str, nbytes: int, seconds: float = 0.0) -> None:
    """Add one call of ``nbytes`` and ``seconds`` to HOST_COUNTS[kind]."""
    with _HOST_LOCK:
        rec = HOST_COUNTS[kind]
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds
        rec["calls"] += 1


def host_totals() -> dict:
    """A snapshot of HOST_COUNTS as flat ``<kind>_<field>_total`` keys
    (PendingFetch.join copies it into the engine's timings)."""
    with _HOST_LOCK:
        return {f"{kind}_{k}_total": v for kind, rec in HOST_COUNTS.items()
                for k, v in rec.items()}


def thread_alloc_seconds() -> float:
    """The seconds the calling thread has spent in page-locked allocation
    since it started (a difference of two readings times a stretch of the
    thread's own work)."""
    return getattr(_THREAD, "alloc_s", 0.0)


# page-locked allocations are rounded up to a multiple of the host's 2 MiB
# huge page: with an H100 80GB HBM3 that made cudaHostAlloc plus the copy of
# the 1024^3 products 2.6 times faster than at their exact sizes
# (scripts/torch_host_copy.py)
PINNED_ALIGN = 2 ** 21


# a miss allocates the request plus this share of it, rounded down to the
# request's alignment, so that realizations whose needed count differs by
# less reuse the block: the needed count of 512^3 realizations spread by up
# to 0.5 % over a window (benchmark records on an H100)
PINNED_HEADROOM = 1 / 32


class _Pinned:
    """One page-locked allocation (cudaHostAlloc through ``kernels.lib``)
    of ``nbytes`` at ``ptr``, with the last copy event enqueued into it on
    each stream (HostCopy)."""

    __slots__ = ("lib", "ptr", "nbytes", "events")

    def __init__(self, lib, ptr: int, nbytes: int):
        self.lib, self.ptr, self.nbytes = lib, ptr, nbytes
        self.events = {}

    def landed(self) -> bool:
        """Whether every copy into the block has completed (a query of each
        stream's last event, never a wait)."""
        if not all(ev.query() for ev in self.events.values()):
            return False
        self.events.clear()
        return True

    def free(self) -> None:
        t0 = time.perf_counter()
        self.lib.host_free(self.ptr)
        count_host("pinned_free", self.nbytes, time.perf_counter() - t0)


class _PinnedPool:
    """The process's page-locked blocks: those handed out (``live``) and
    the idle ones given back when the last array over them went, oldest
    first.  A request of n bytes takes the smallest idle block of n to
    n + n/8 bytes whose copies have landed.  On a miss, idle blocks are
    released, oldest first, until the idle and live bytes with the new
    block come to no more than the larger of the live bytes' high-water
    mark and the live bytes with the new block, so the footprint follows
    the live peak and not every size ever asked for.  A block comes back
    through ``give``, from a __del__ on any thread and under gc: a deque
    append, no lock and no CUDA call; ``take`` and ``release`` move the
    returns to the idle list under _HOST_LOCK and allocate and release
    outside it."""

    def __init__(self):
        self.returns = collections.deque()
        self.idle = []
        self.live = {}                 # ptr -> _Pinned
        self.live_bytes = self.high = 0

    def give(self, mem: _Pinned) -> None:
        self.returns.append(mem)

    def _drain(self) -> None:
        while self.returns:
            mem = self.returns.popleft()
            del self.live[mem.ptr]
            self.live_bytes -= mem.nbytes
            self.idle.append(mem)

    def _hand_out(self, mem: _Pinned) -> None:
        self.live[mem.ptr] = mem
        self.live_bytes += mem.nbytes
        self.high = max(self.high, self.live_bytes)

    def take(self, n: int, align: int) -> _Pinned:
        """A block of at least ``n`` bytes (a multiple of ``align``)."""
        t0 = time.perf_counter()
        with _HOST_LOCK:
            self._drain()
            best = None
            for mem in self.idle:
                if (n <= mem.nbytes <= n + n // 8
                        and (best is None or mem.nbytes < best.nbytes)
                        and mem.landed()):
                    best = mem
            if best is not None:
                self.idle.remove(best)
                self._hand_out(best)
                count_host("pinned_reuse", best.nbytes,
                           time.perf_counter() - t0)
                return best
            size = n + int(n * PINNED_HEADROOM) // align * align
            stale = []
            while self.idle and (
                    sum(m.nbytes for m in self.idle) + self.live_bytes
                    + size > max(self.high, self.live_bytes + size)):
                stale.append(self.idle.pop(0))
            self.live_bytes += size            # held for the new block
        for mem in stale:
            mem.free()
        lib_ = kernels.lib()
        t0 = time.perf_counter()
        ptr = lib_.host_alloc(size)
        dt = time.perf_counter() - t0
        with _HOST_LOCK:
            self.live_bytes -= size
            if not ptr:
                raise MemoryError(f"cudaHostAlloc of {size} bytes failed")
            mem = _Pinned(lib_, ptr, size)
            self._hand_out(mem)
        _THREAD.alloc_s = thread_alloc_seconds() + dt
        count_host("pinned_alloc", size, dt)
        return mem

    def note_copy(self, ptr: int, stream, event) -> None:
        """Record ``event`` as the last copy on ``stream`` into the live
        block that holds address ``ptr`` (none: not page-locked here)."""
        with _HOST_LOCK:
            for mem in self.live.values():
                if mem.ptr <= ptr < mem.ptr + mem.nbytes:
                    mem.events[stream] = event
                    return

    def release(self) -> None:
        with _HOST_LOCK:
            self._drain()
            stale, self.idle = self.idle, []
            self.high = self.live_bytes
        for mem in stale:
            mem.free()


_POOL = _PinnedPool()


class _PinnedBlock:
    """A pool block as a numpy buffer, given back to the pool when the
    last array over it goes."""

    def __init__(self, mem: _Pinned):
        self.mem, self._give = mem, _POOL.give
        self.__array_interface__ = dict(shape=(mem.nbytes,), typestr="|u1",
                                        data=(mem.ptr, False), version=3)

    def __del__(self):
        self._give(self.mem)


def release_pinned() -> None:
    """Release every idle page-locked block of the pool (cudaFreeHost,
    counted as pinned_free); the live bytes' high-water mark starts again
    from the blocks still held."""
    _POOL.release()


def pinned_empty(shape, dtype, align: int = PINNED_ALIGN) -> np.ndarray:
    """An uninitialized numpy array in page-locked host memory: a block of
    the pool of at least its size rounded up to a multiple of ``align``
    (_PinnedPool; PyTorch's pinned allocator rounds each buffer up to a
    power of two instead)."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    mem = _POOL.take(-(-max(nbytes, 1) // align) * align, align)
    raw = np.asarray(_PinnedBlock(mem))
    return raw[:nbytes].view(dtype).reshape(shape)


def host_empty(shape, dtype, device, align: int = PINNED_ALIGN):
    """An uninitialized host tensor to receive data from ``device``: in
    page-locked memory (pinned_empty, rounded up to ``align`` bytes) for a
    card, plain memory for the CPU."""
    if torch.device(device).type != "cuda":
        return torch.empty(shape, dtype=dtype)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(pinned_empty(tuple(shape), np_dtype, align))


_COPY_STREAMS = {}


def copy_stream(device):
    """The device-to-host copy stream of a card (one per device, made on
    first use); None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    dev = torch.device("cuda", dev.index if dev.index is not None
                       else torch.cuda.current_device())
    with _LOCK:
        if dev not in _COPY_STREAMS:
            _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
        return _COPY_STREAMS[dev]


class HostCopy:
    """One copy of a device tensor ``src`` into a host tensor ``dst``
    (CopyStream.copy).  On a card it is enqueued at once on the device's
    copy stream with non_blocking=True (dst page-locked), followed by an
    event; ``src`` is marked as used by that stream, so the caching
    allocator does not hand its memory to another tensor before the copy
    has read it.  On the CPU it waits in its CopyStream's queue, and a
    wait() makes it and every copy queued before it, in order, on the
    waiting thread: in both cases a copy that has landed means that every
    earlier copy of its stream has.  Counted in HOST_COUNTS["d2h"] when
    made."""

    def __init__(self, dst, src, copier: "CopyStream"):
        count_host("d2h", src.numel() * src.element_size())
        self.event = None
        self._copier = copier
        if copier.stream is None:
            self._args = (dst, src)
            with copier.lock:
                copier.todo.append(self)
            return
        with torch.cuda.stream(copier.stream):
            dst.copy_(src, non_blocking=True)
            src.record_stream(copier.stream)
            # a blocking-sync event: a waiting host thread sleeps rather
            # than spins beside the sweep
            self.event = torch.cuda.Event(blocking=True)
            self.event.record(copier.stream)
        # the pool hands dst's block out again only once this has landed
        _POOL.note_copy(dst.data_ptr(), copier.stream, self.event)

    def wait(self) -> None:
        """Return once the copy has landed in ``dst``."""
        if self.event is not None:
            self.event.synchronize()
            return
        c = self._copier
        with c.lock:
            while self._args is not None:
                first = c.todo.popleft()
                dst, src = first._args
                dst.copy_(src)
                first._args = None

    def before_reuse(self, device) -> None:
        """Make the work enqueued next on ``device``'s current stream wait
        for this copy (before its source is written again); on the CPU,
        wait."""
        if self.event is not None:
            torch.cuda.current_stream(device).wait_event(self.event)
        else:
            self.wait()


class CopyStream:
    """Device-to-host copies of one device, in order (copy_stream on a
    card): after() makes the copy stream wait for the work enqueued so far
    on the calling thread's current stream of the device (PyTorch's side
    streams do not wait for the default stream by themselves), copy()
    enqueues one HostCopy."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = copy_stream(self.device)
        self.todo = collections.deque()      # the CPU's copies not made yet
        self.lock = threading.Lock()

    def after(self) -> None:
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def copy(self, dst, src) -> HostCopy:
        return HostCopy(dst, src, self)


def to_host(t):
    """A host copy of a tensor: from a card, in page-locked memory of its
    own size rounded up to 2 MiB (pinned_empty); a CPU tensor's clone.
    Counted in HOST_COUNTS["d2h"]."""
    count_host("d2h", t.numel() * t.element_size())
    if t.device.type != "cuda":
        return t.clone()
    host = host_empty(t.shape, t.dtype, t.device)
    host.copy_(t)
    return host


def chunk_bounds(n: int, k: int = N_CHUNKS):
    return [n * i // k for i in range(k + 1)]


def stream_key(s: int, key: str):
    """The stream key of displacement set s's table ``key``."""
    return key if s == 0 else ("seg", s, key)


class StreamState:
    """The host side of the displacement tables' streams.

    Each expected table (a key of the first displacement set, ("seg", s,
    key) of set s) lands in a float32 [count, 3] host buffer, chunk after
    chunk in row order.  A waiter thread waits for the chunks' copies
    (HostCopy) in the order they were enqueued, which is the order the
    copy stream runs them in, and advances ``ready[0]``: the rows
    delivered in every expected table, the pointer the C sweep spin-waits
    on (groupsweep.c rows_ready).  The expected tables must be those
    enqueued, or the sweep never starts.  note() adds a copy that is not a
    table (cell indices and F): the waiter records when it landed.
    ``times``: seconds from t0 to each note, to the watermark's first
    advance ("first") and to the last row ("last"); ``allocated`` and
    ``landed``: seconds from t0 to each table's host buffer attached and to
    its last row landed."""

    def __init__(self, count: int, keys, t0: float = None):
        self.count = count
        self.keys = list(keys)
        self.buffers = {}
        self._delivered = dict.fromkeys(self.keys, 0)
        self._events = {k: threading.Event() for k in self.keys}
        self._attached = {k: threading.Event() for k in self.keys}
        self._notes = {}
        self.ready = np.zeros(1, np.int64)
        self.error = None
        self.times, self.allocated, self.landed = {}, {}, {}
        self._t0 = time.perf_counter() if t0 is None else t0
        self._lock = threading.Lock()
        self._queue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def attach(self, key, rows: np.ndarray) -> None:
        """The host buffer [count, 3] that ``key``'s chunks land in."""
        self.buffers[key] = rows
        self.allocated[key] = time.perf_counter() - self._t0
        self._attached[key].set()

    def buffer(self, key) -> np.ndarray:
        """``key``'s host buffer, possibly still filling; waits until it is
        attached."""
        self._attached[key].wait()
        if key not in self.buffers:
            self.check()
        return self.buffers[key]

    def enqueue(self, key, i1: int, copy) -> None:
        """A chunk of ``key`` whose copy ends at row i1."""
        self._queue.put((key, i1, copy))

    def note(self, name: str, copy) -> threading.Event:
        """A copy that is not a table; the event is set once it landed."""
        ev = self._notes[name] = threading.Event()
        self._queue.put((name, None, copy))
        return ev

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            key, i1, copy = item
            try:
                if _STREAM_TEST_DELAY and i1 is not None:
                    time.sleep(_STREAM_TEST_DELAY)
                copy.wait()
            except BaseException as e:       # noqa: BLE001 - check() raises
                self.fail(e)
                return
            if self._advance(key, i1):
                return

    def _advance(self, key, i1) -> bool:
        now = time.perf_counter() - self._t0
        with self._lock:
            if i1 is None:
                self.times[key] = now
                self._notes[key].set()
                return False
            self._delivered[key] = i1
            ready = min(self._delivered.values())
            if ready > self.ready[0] and "first" not in self.times:
                self.times["first"] = now
            self.ready[0] = ready
            if i1 >= self.count:
                self.landed[key] = now
                self._events[key].set()
            done = all(ev.is_set() for ev in self._events.values())
            if done:
                self.times.setdefault("first", now)
                self.times["last"] = now
            return done

    def fail(self, err: BaseException) -> None:
        """Record the error and release every waiter: the sweep reads on
        to its end, and the fragmentation driver re-raises through
        check()."""
        with self._lock:
            if self.error is None:
                self.error = err
            self.ready[0] = self.count
            for evs in (self._events, self._attached, self._notes):
                for ev in evs.values():
                    ev.set()
        self._queue.put(None)

    def wait(self, key) -> None:
        self._events[key].wait()
        self.check()

    def check(self) -> None:
        if self.error is not None:
            raise self.error

    def join(self) -> dict:
        """Wait for every table, re-raise a failed copy, return times."""
        for ev in self._events.values():
            ev.wait()
        self._thread.join()
        self.check()
        return dict(self.times)


class StreamingVel:
    """Dict-like view of one displacement set over a StreamState:
    __getitem__ (and items, values) BLOCKS until that table has
    landed, so the dumps, the snapshot and any other reader keep their
    semantics; the fragmentation driver reads buffer() instead, which does
    not block, and hands the C sweep the rows_ready watermark."""

    def __init__(self, stream: StreamState, keymap: dict, n: int):
        self.stream = stream
        self._keymap = keymap          # public key -> stream key
        self._n = n

    def __contains__(self, k):
        return k in self._keymap

    def __iter__(self):
        return iter(self._keymap)

    def __len__(self):
        return len(self._keymap)

    def keys(self):
        return self._keymap.keys()

    def __getitem__(self, k):
        sk = self._keymap[k]
        self.stream.wait(sk)
        return self.stream.buffer(sk)[:self._n]

    def items(self):
        return [(k, self[k]) for k in self._keymap]

    def values(self):
        return [self[k] for k in self._keymap]

    def buffer(self, k):
        """The table's host buffer, possibly still filling (rows below the
        watermark have landed)."""
        return self.stream.buffer(self._keymap[k])[:self._n]


def streaming_sets(stream: StreamState, keys, nsets: int, n: int):
    """(vel, segments) over ``stream``: the first set's StreamingVel, and
    with several sets the list of all (segments[0] is vel), else None."""
    sets = [StreamingVel(stream, {k: stream_key(s, k) for k in keys}, n)
            for s in range(nsets)]
    return sets[0], (sets if nsets > 1 else None)


class EventTimer:
    """A stretch of device work timed by a timing event on the current
    stream of each card of ``devices`` at each record() (nothing on the
    CPU).  timings(): {key: the longest time between a card's two events},
    once both have completed, or {} without two records."""

    def __init__(self, devices, key: str):
        self.devs = [d for d in dict.fromkeys(map(torch.device, devices))
                     if d.type == "cuda"]
        self.key = key
        self.marks = []

    def record(self) -> None:
        if self.devs:
            events = [torch.cuda.Event(enable_timing=True) for _ in self.devs]
            for ev, d in zip(events, self.devs):
                ev.record(torch.cuda.current_stream(d))
            self.marks.append(events)

    def timings(self) -> dict:
        if len(self.marks) != 2:
            return {}
        for ev in self.marks[1]:
            ev.synchronize()
        return {self.key: 1e-3 * max(
            a.elapsed_time(b) for a, b in zip(*self.marks))}


class PendingFetch:
    """One engine's hand-off in flight (counterpart of the JAX package's
    PendingFetch and _OocPending): the copies of ``nsets`` displacement
    sets of ``keys`` tables, [count, 3] float32 each, on ``device``'s copy
    stream into page-locked host buffers, streaming behind the watermark
    of a StreamState; and other copies (note), which finish() waits for.
    The engine decides what is enqueued and when: host_empty and table()
    allocate under the span handoff.alloc, after() makes the copy stream
    wait for the work enqueued so far, enqueue() adds a table's chunk.
    start() runs the rest of the engine's work on a background thread
    (the out-of-core row phase), whose error join() re-raises.

    The caller's ``timings`` dict receives the hand-off's times in seconds
    from ``t0`` (the end of the collapse cycle): at returned(),
    handoff_return and handoff_alloc_s (the calling thread's page-locked
    allocation seconds since ``alloc0``); at join(), what ``resolve()``
    returns (the engine's own timings, read once its work is done),
    handoff_<note> and handoff_first / handoff_last (the watermark's first
    advance, the last row) and the host_totals() snapshot.  It holds that
    dict, not the engine's result, so that the result and its page-locked
    rows are freed with their last reference."""

    def __init__(self, device, count: int, keys, nsets: int, t0: float,
                 alloc0: float, timings: dict, resolve):
        self.device = torch.device(device)
        self.count, self.keys, self.nsets = count, list(keys), nsets
        self.copier = CopyStream(self.device)
        self.stream = StreamState(
            count, [stream_key(s, k) for s in range(nsets) for k in keys],
            t0)
        self.t0, self.alloc0 = t0, alloc0
        self.timings, self.resolve = timings, resolve
        self.buf = None     # a device buffer the copies read, until join
        self._notes = {}    # name -> (host buffer, event set once landed)
        self._thread = self._error = None

    def host_empty(self, shape, dtype, **kw):
        with record_function("handoff.alloc"):
            return host_empty(shape, dtype, self.device, **kw)

    def table(self, s: int, key: str):
        """(stream key, host buffer) of set s's table ``key``: allocated
        and attached to the stream."""
        skey = stream_key(s, key)
        rows = self.host_empty((self.count, 3), torch.float32)
        self.stream.attach(skey, rows.numpy())
        return skey, rows

    def after(self) -> None:
        self.copier.after()

    def enqueue(self, skey, i1: int, dst, src) -> HostCopy:
        """A chunk of table ``skey`` whose copy ends at row i1."""
        copy = self.copier.copy(dst, src)
        self.stream.enqueue(skey, i1, copy)
        return copy

    def note(self, name: str, dst, src) -> None:
        """A copy that is not a table, into ``dst``; its landing time is
        handoff_<name>, except for "hist"."""
        self._notes[name] = (dst, self.stream.note(
            name, self.copier.copy(dst, src)))

    def finish(self):
        """(the notes' host buffers by name as numpy, vel, segments), once
        the notes have landed: the first set's StreamingVel and, with
        several sets, the list of all (segments[0] is vel), else None."""
        for _, ev in self._notes.values():
            ev.wait()
        if not self._notes.keys() <= self.stream.times.keys():
            self.stream.check()        # a note's copy failed
        # (a table's failed copy raises from the sweep or join())
        host = {k: dst.numpy() for k, (dst, _) in self._notes.items()}
        return (host,) + streaming_sets(self.stream, self.keys, self.nsets,
                                        self.count)

    def abort(self, err: BaseException) -> None:
        """Release the waiters after a failure on the enqueuing side."""
        self.stream.fail(err)

    def returned(self) -> None:
        """Stamp the engine's return (class docstring)."""
        self.timings["handoff_alloc_s"] = thread_alloc_seconds() - self.alloc0
        self.timings["handoff_return"] = time.perf_counter() - self.t0

    def start(self, work) -> None:
        """work() on a background thread; an error aborts the streams."""
        def run():
            try:
                work()
            except BaseException as e:   # noqa: BLE001 - join re-raises
                self._error = e
                self.abort(e)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> dict:
        """Wait for the background work and the last row, re-raise an
        error of either, drop ``buf`` and add the timings (class
        docstring); returns the caller's timings."""
        try:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            times = self.stream.join()
        finally:
            self.buf = None
        if self._error is not None:
            raise self._error
        self.timings.update(self.resolve())
        self.timings.update({f"handoff_{k}": v for k, v in times.items()
                             if k != "hist"})
        self.timings.update(host_totals())
        return self.timings
