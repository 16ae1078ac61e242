"""Hand-written Hopper kernels: build, load and launch counts.

The CUDA C++ sources in ``pinocchio_tpu_torch/csrc`` are compiled by nvcc
into one shared library with a plain C interface, at first use, and loaded
with ctypes (no PyTorch headers: the build takes seconds).  Each source is
compiled by its own nvcc process, all started together, and the objects are
linked into the library.  The library name carries a hash of the sources
and flags, so an edited source is rebuilt.  Every kernel of the port is in
this library: a wrapper looks its entry point up once and calls it with
plain ints, pointers and the stream.

Every wrapper adds one to its entry in ``LAUNCHES`` where it launches its
kernel, and nowhere else; a run resets the counts with ``reset_launches``
and reads them afterwards to show which kernels the path went through.

The module also keeps the device-to-host copy machinery of the hand-off:
page-locked host buffers (``pinned_empty``, served from a pool of blocks
that the last array over them gave back), one copy stream per card
(``copy_stream``) and copies that each end in an event (``HostCopy``,
``CopyStream``).  ``HOST_COUNTS`` counts that machinery's work, in the
shape of ``parallel.multihost.TRAFFIC`` (bytes, seconds, calls per kind),
as process totals that are never reset (a rate is the difference of two
readings, ``host_totals``): ``pinned_alloc`` and ``pinned_free`` each
page-locked block allocated or released (bytes after the 2 MiB rounding,
host seconds inside cudaHostAlloc and cudaFreeHost), ``pinned_reuse``
each block handed out again from the pool (its bytes, host seconds in the
search), ``d2h`` each device-to-host copy made by ``HostCopy`` or
``to_host`` or counted by a caller that copies on its own (bytes and
calls).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("ic_kdensity.cu", "kspace.cu", "collapse.cu", "compact.cu",
           "exchange.cu", "storage.cu", "lpt.cu")
# -fmad=false: no multiply-add contraction, so each kernel rounds op for
# op as its plain PyTorch version does (explicit fmaf stays fused)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC"]

_COLLAPSE = "pinocchio_tpu_torch/csrc/collapse.cu"
_KSPACE = "pinocchio_tpu_torch/csrc/kspace.cu"
_COMPACT = "pinocchio_tpu_torch/csrc/compact.cu"
_LPT = "pinocchio_tpu_torch/csrc/lpt.cu"
_EXCHANGE = "pinocchio_tpu_torch/csrc/exchange.cu"
_STORAGE = "pinocchio_tpu_torch/csrc/storage.cu"
# kernel name -> (route, source in the repo, JAX function it replaces)
KERNELS = {
    "ic_kdensity": ("cuda", "pinocchio_tpu_torch/csrc/ic_kdensity.cu",
                    "pinocchio_tpu/ic.py:50"),
    "kspace_hessian": ("cuda", _KSPACE,
                       "pinocchio_tpu/ops/derivatives.py:120"),
    "kspace_gradient": ("cuda", _KSPACE,
                        "pinocchio_tpu/ops/derivatives.py:151"),
    "kspace_gradient_tab": ("cuda", _KSPACE,
                            "pinocchio_tpu/ops/derivatives.py:169"),
    "collapse_update": ("cuda", _COLLAPSE,
                        "pinocchio_tpu/ops/collapse.py:282"),
    "collapse_update_table_trilinear": (
        "cuda", _COLLAPSE, "pinocchio_tpu/ops/collapse.py:255"),
    "collapse_update_table_bilinear": (
        "cuda", _COLLAPSE, "pinocchio_tpu/ops/collapse.py:255"),
    "collapse_update_table_bicubic": (
        "cuda", _COLLAPSE, "pinocchio_tpu/ops/collapse.py:255"),
    "lpt_sources_pointwise": ("cuda", _LPT, "pinocchio_tpu/ops/lpt.py:34"),
    "lpt_src32_accumulate": ("cuda", _LPT, "pinocchio_tpu/ops/lpt.py:34"),
    "needed_rank": ("cuda", _COMPACT, "pinocchio_tpu/fmax.py:153"),
    "gather_rows": ("cuda", _COMPACT, "pinocchio_tpu/fmax.py:153"),
    "pdf_hist": ("cuda", _COMPACT, "pinocchio_tpu/fmax.py:110"),
    # the out-of-core engine (K9-K14)
    "ic_kdensity_planes": ("cuda", "pinocchio_tpu_torch/csrc/ic_kdensity.cu",
                           "pinocchio_tpu/ic.py:149"),
    "ooc_factors_hessian": ("cuda", _KSPACE,
                            "pinocchio_tpu/fmax_ooc.py:421"),
    "ooc_factors_gradient": ("cuda", _KSPACE,
                             "pinocchio_tpu/fmax_ooc.py:438"),
    "ooc_factors_pair": ("cuda", _KSPACE, "pinocchio_tpu/fmax_ooc.py:469"),
    "collapse_update_slab": ("cuda", _COLLAPSE,
                             "pinocchio_tpu/fmax_ooc.py:506"),
    "vrows_slab": ("cuda", _COMPACT, "pinocchio_tpu/fmax_ooc.py:934"),
    # the out-of-core engine's collapse tables and growth tables (K13, K14)
    "collapse_update_slab_table_trilinear": (
        "cuda", _COLLAPSE, "pinocchio_tpu/fmax_ooc.py:539"),
    "collapse_update_slab_table_bilinear": (
        "cuda", _COLLAPSE, "pinocchio_tpu/fmax_ooc.py:539"),
    "collapse_update_slab_table_bicubic": (
        "cuda", _COLLAPSE, "pinocchio_tpu/fmax_ooc.py:539"),
    "ooc_factors_gradient_tab": ("cuda", _KSPACE,
                                 "pinocchio_tpu/fmax_ooc.py:438"),
    # a shard's window of a mesh's k layout (K1s, K2s, K5s, K8s)
    "ic_kdensity_shard": ("cuda", "pinocchio_tpu_torch/csrc/ic_kdensity.cu",
                          "pinocchio_tpu/parallel/driver.py:42"),
    "kspace_hessian_shard": ("cuda", _KSPACE,
                             "pinocchio_tpu/parallel/pfft.py:333"),
    "kspace_gradient_shard": ("cuda", _KSPACE,
                              "pinocchio_tpu/parallel/pfft.py:355"),
    "kspace_gradient_tab_shard": ("cuda", _KSPACE,
                                  "pinocchio_tpu/parallel/pfft.py:369"),
    # the cross-host product exchange (K15, K16, K17)
    "exchange_count": ("cuda", _EXCHANGE,
                       "pinocchio_tpu/parallel/exchange.py:311"),
    "exchange_pack": ("cuda", _EXCHANGE,
                      "pinocchio_tpu/parallel/exchange.py:339"),
    "exchange_paint": ("cuda", _EXCHANGE,
                       "pinocchio_tpu/parallel/exchange.py:121"),
    # the out-of-core engine's 16-bit stacks and spectra (K18, K19)
    "storage_store": ("cuda", _STORAGE, "pinocchio_tpu/fmax_ooc.py:389"),
    "storage_load": ("cuda", _STORAGE, "pinocchio_tpu/fmax_ooc.py:411"),
}

LAUNCHES = {name: 0 for name in KERNELS}

HOST_COUNTS = {kind: dict(bytes=0, seconds=0.0, calls=0)
               for kind in ("pinned_alloc", "pinned_free", "pinned_reuse",
                            "d2h")}
# re-entrant: the page-locked pool counts (count_host) under it
_HOST_LOCK = threading.RLock()
# per thread: seconds in page-locked allocation (thread_alloc_seconds)
_THREAD = threading.local()

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_L = ctypes.c_int64
_SIGNATURES = {
    # out, pk (scratch), logk, logpk, ntab, kp0, kp1, ka0, ka1, logkf, fac,
    # N, fixed, paired, stream
    "ic_kdensity": [_P, _P, _P, _P, _I, _U, _U, _U, _U, _F, _F, _I, _I, _I,
                    _P],
    # phase, sin, cos, rule, stream
    "ic_phase_check": [_P, _P, _P, _P, _P],
    # which, out[4] (host)
    "ic_kernel_info": [_I, _P],
    # delta, out, N, R_grid, stream
    "kspace_hessian": [_P, _P, _I, _F, _P],
    # src, out, N, growth, stream
    "kspace_gradient": [_P, _P, _I, _F, _P],
    # src, out, N, gtab, ntab, glo, gdx, tmax, stream
    "kspace_gradient_tab": [_P, _P, _I, _P, _I, _F, _F, _F, _P],
    # derivs, Fmax, Rmax, ncell, ismooth, pack[23] (host), then the
    # reduction's partials, max_blocks, ticket, means, stream
    "collapse_update": [_P, _P, _P, _L, _I, _P, _P, _I, _P, _P, _P],
    # derivs, Fmax, Rmax, ncell, ismooth, tab, tab2, dv, idx_map, ampl,
    # interp, then as collapse_update
    "collapse_update_table": [_P, _P, _P, _L, _I, _P, _P, _P, _P, _F, _I,
                              _P, _I, _P, _P, _P],
    # mode, ring, out[4] (host)
    "collapse_kernel_info": [_I, _I, _P],
    # counts[2], stream
    "cbrt_check": [_P, _P],
    # idx, count, ncell, rank, stream
    "needed_rank": [_P, _L, _L, _P, _P],
    # rank, ncell, count, F (or null), stacks[nstack] (host), nstack, out,
    # rec, stream
    "scatter_rows": [_P, _L, _L, _P, _P, _I, _P, _P, _P],
    # which, out[4] (host)
    "compact_kernel_info": [_I, _P],
    # F, n, counts, stream
    "pdf_hist": [_P, _L, _P, _P],
    # out, pk, build, logk, logpk, ntab, keys, kz0, B, logkf, fac, N, fixed,
    # paired, stream
    "ic_kdensity_planes": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _F, _F, _I,
                           _I, _I, _P],
    # K10 rows: src, sb, sx, out, N, kz0, B, R_grid (or growth), stream;
    # kz-fastest: src, sx, sy, then the same
    "ooc_hessian_rows": [_P, _L, _L, _P, _I, _I, _I, _F, _P],
    "ooc_gradient_kz": [_P, _L, _L, _P, _I, _I, _I, _F, _P],
    "ooc_gradient_rows": [_P, _L, _L, _P, _I, _I, _I, _F, _P],
    # src0, s0b, s0x (its iy axis contiguous), then src1 and its form's two
    # strides, out, N, kz0, B, ia, ib, stream
    "ooc_pair_kz": [_P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P],
    "ooc_pair_rows": [_P, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P],
    # derivs, Fmax, n, pack[23] (host), then as collapse_update
    "collapse_update_slab": [_P, _P, _L, _P, _P, _I, _P, _P, _P],
    # rank, comps, n, rows, stream
    "vrows_slab": [_P, _P, _L, _P, _P],
    # nbytes (returns the host pointer); ptr
    "host_alloc": [ctypes.c_size_t],
    "host_free": [_P],
    # derivs, Fmax, n, tab, tab2, dv, idx_map, ampl, interp, then as
    # collapse_update
    "collapse_update_slab_table": [_P, _P, _L, _P, _P, _P, _P, _F, _I, _P,
                                   _I, _P, _P, _P],
    # K14 kz-fastest: src, sx, sy, out, N, kz0, B, gtab, ntab, glo, gdx,
    # tmax, stream; contiguous: src, sb, sx, then the same
    "ooc_gradient_tab_kz": [_P, _L, _L, _P, _I, _I, _I, _P, _I, _F, _F, _F,
                            _P],
    "ooc_gradient_tab_rows": [_P, _L, _L, _P, _I, _I, _I, _P, _I, _F, _F,
                              _F, _P],
    # K1's arguments with the window y0, ny, z0, nz after N
    "ic_kdensity_shard": [_P, _P, _P, _P, _I, _U, _U, _U, _U, _F, _F, _I, _I,
                          _I, _I, _I, _I, _I, _P],
    # src, out, N, y0, ny, z0, nz, then as K2, K5, K8
    "kspace_hessian_shard": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    "kspace_gradient_shard": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    "kspace_gradient_tab_shard": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _F,
                                  _F, _P],
    # cells, n, block[6] (host), N, boxes, nb, box_off, map (or null), H,
    # bits, counts, wide, stream
    "exchange_count": [_P, _L, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P],
    # which, out[4] (host)
    "exchange_kernel_info": [_I, _P],
    # perm, buf, count, bits, W, block_off, H, host_nd, host_devs, ndmax,
    # seg_base, seg_n, nch, out, stream
    "exchange_pack": [_P, _P, _L, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I,
                      _P, _P],
    # rows, nrows, first, nblocks, ncols, block[6] (host), N, pad_boxes,
    # pad_off, t0_boxes, t0_off, map, its bytes, stream
    "exchange_paint": [_P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _L,
                       _P],
    # K18, K19 transposing: src, dst, kind, C, M, B, W, k, stream
    "storage_store_kz": [_P, _P, _I, _L, _L, _L, _L, _L, _P],
    "storage_load_kz": [_P, _P, _I, _L, _L, _L, _L, _L, _P],
    # K18 straight: src, dst, kind, A, W, Ws, col0, stream
    "storage_store_rows": [_P, _P, _I, _L, _L, _L, _L, _P],
    # K19 straight: src, dst, kind, C, n, sc, stream
    "storage_load_rows": [_P, _P, _I, _L, _L, _L, _P],
    # the stack layout's runs alone: buf, load, form, C, M, B, W, k, stream
    "storage_runs_probe": [_P, _I, _I, _L, _L, _L, _L, _L, _P],
    # K4: sd, out, n, stream; phi2, sd, src32, n, stream; phi2, sd, src32,
    # n, w2, stream; which, out[4] (host)
    "lpt_pointwise": [_P, _P, _L, _P],
    "lpt_accumulate": [_P, _P, _P, _L, _P],
    "lpt_accumulate_one": [_P, _P, _P, _L, _F, _P],
    "lpt_kernel_info": [_I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_host(kind: str, nbytes: int, seconds: float = 0.0) -> None:
    """Add one call of ``nbytes`` and ``seconds`` to HOST_COUNTS[kind]."""
    with _HOST_LOCK:
        rec = HOST_COUNTS[kind]
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds
        rec["calls"] += 1


def host_totals() -> dict:
    """A snapshot of HOST_COUNTS as flat ``<kind>_<field>_total`` keys (the
    engines copy it into their timings when the hand-off is joined)."""
    with _HOST_LOCK:
        return {f"{kind}_{k}_total": v for kind, rec in HOST_COUNTS.items()
                for k, v in rec.items()}


def thread_alloc_seconds() -> float:
    """The seconds the calling thread has spent in page-locked allocation
    since it started (a difference of two readings times a stretch of the
    thread's own work)."""
    return getattr(_THREAD, "alloc_s", 0.0)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fd:
            h.update(name.encode() + fd.read())
    return os.path.join(BUILD,
                        f"libpinocchio_kernels-{h.hexdigest()[:16]}.so")


def ptxas_path(library: str = None) -> str:
    """The file beside the library where the build keeps ptxas's -v report
    (each kernel's registers, shared memory and spills)."""
    return (library or library_path()) + ".ptxas.txt"


def build() -> str:
    """Compile the CUDA sources (if this exact source set is not built yet)
    and return the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}"
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    cmds = [[nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", "-o", o,
                                   os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors, report = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{err}")
        report.append(err)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    with open(ptxas_path(path), "w") as fd:
        fd.write("".join(report))
    link = [nvcc] + ARCH + ["-shared", "-o", f"{tmp}.so"] + objs
    res = subprocess.run(link, capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(link)}\n{res.stderr}")
    os.replace(f"{tmp}.so", path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(build()))
        return _LIB


def bind(so: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Declare the argument and result types of so's entry points (those
    of _SIGNATURES, or the named ones)."""
    for name in names or _SIGNATURES:
        fn = getattr(so, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_void_p if name == "host_alloc" else ctypes.c_int
    return so


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
    """One page-locked allocation (cudaHostAlloc through ``lib``) of
    ``nbytes`` at ``ptr``, with the last copy event enqueued into it on
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
        import collections
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
        lib_ = lib()
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
    import torch
    if torch.device(device).type != "cuda":
        return torch.empty(shape, dtype=dtype)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(pinned_empty(tuple(shape), np_dtype, align))


_COPY_STREAMS = {}


def copy_stream(device):
    """The device-to-host copy stream of a card (one per device, made on
    first use); None for the CPU."""
    import torch
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
        import torch
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
        import torch
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
        import collections

        import torch
        self.device = torch.device(device)
        self.stream = copy_stream(self.device)
        self.todo = collections.deque()      # the CPU's copies not made yet
        self.lock = threading.Lock()

    def after(self) -> None:
        import torch
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


def check(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")


def stream_ptr(device) -> int:
    """The current stream of ``device`` (a torch.device or a card's index),
    read at every launch, as a stream kept from an earlier call would miss
    a ``torch.cuda.stream`` context: through torch's raw query where it has
    one."""
    import torch
    query = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if query is None:
        return torch.cuda.current_stream(device).cuda_stream
    if not isinstance(device, int):
        device = torch.device(device).index
    return query(torch.cuda.current_device() if device is None else device)


def current_device() -> int:
    """The index of the current card, on which the C library's kernels
    launch."""
    import torch
    return torch.cuda.current_device()


def on_device(device):
    """A context that makes ``device`` current for the launches inside it:
    a kernel of the C library launches on the current device, so a launch
    for a shard on another card than the current one runs under it (a no-op
    context for a CPU device)."""
    import contextlib

    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def require_cuda(name: str, *tensors) -> None:
    """Wrapper guard: every tensor on one CUDA device and contiguous (read
    through is_cuda and get_device, which make no device object: the guard
    runs at every launch)."""
    first = tensors[0]
    dev = first.get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def plain_or_kernel(name: str, t) -> bool:
    """True when ``t`` lies on a CUDA device (launch the kernel), False on
    the CPU (run the plain PyTorch version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
