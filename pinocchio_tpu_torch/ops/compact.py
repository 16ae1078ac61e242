"""Needed-particle hand-off on the device (counterpart of the compaction
helpers of pinocchio_tpu/fmax.py: _compact_idx, _gather_rows, the segment
gathers of displacement_stage_fetch and _pdf_bincount; and of
pinocchio_tpu/fmax_ooc.py's vrows_slab).

``needed_order`` sorts with ``torch.sort`` (a library call, as the JAX
package calls XLA's sort).  ``needed_rank``, ``gather_rows``, ``pdf_hist``
and the out-of-core engine's ``vrows_slab`` are the wrappers of the kernels
of ``csrc/compact.cu``: on a CUDA tensor they launch the kernel, on a CPU
tensor they run the plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

PDF_BINS = 210
MAX_STACKS = 8
# floats of the kernel's row record (one 32-byte sector): gather_rows holds
# [count, ROW_RECORD] float32 of scratch while it runs
ROW_RECORD = 8


def needed_order(Fmax, Flast: float):
    """The cells with F >= Flast in the sweep's order, descending F with
    ties by ascending cell index (stable sort on the key
    where(F >= Flast, -F, +inf)): int64 indices [count]."""
    Ff = Fmax.reshape(-1)
    mask = Ff >= Flast
    key = torch.where(mask, -Ff, float("inf"))
    order = torch.sort(key, stable=True).indices
    count = int(mask.sum())                         # device sync
    return order[:count]


def packed_size(count: int, nstack: int, with_F: bool) -> int:
    """Floats a gather_rows call writes: (cell index, F) per row when F is
    given, then 3 per row and stack."""
    return (2 * count if with_F else 0) + 3 * nstack * count


def gather_rows_plain(idx, stacks, out, F=None, rank=None):
    """Plain version of K6a: see gather_rows (rank is not read)."""
    count = idx.numel()
    off = 0
    if F is not None:
        out[:count] = idx.to(torch.int32).view(torch.float32)
        out[count:2 * count] = F.reshape(-1)[idx]
        off = 2 * count
    for v in stacks:
        out[off:off + 3 * count] = v.reshape(3, -1)[:, idx].T.reshape(-1)
        off += 3 * count
    return out


def gather_rows(idx, stacks, out, F=None, rank=None):
    """Write the needed rows into the packed host-bound buffer ``out``
    (float32, 1-D, packed_size floats): when F (the Fmax grid) is given,
    first the cell indices as int32 bits and F[idx], then for each
    [3, N, N, N] float32 stack its [count, 3] rows at idx (int64, from
    needed_order).  rank: needed_rank(idx, N^3), built here when not given;
    a caller with several displacement sets builds it once.  On the card
    the cells are walked in order and each needed cell's columns land as
    one 32-byte record at its row, then the records are copied into the
    packed layout (scatter_rows, csrc/compact.cu)."""
    if not kernels.plain_or_kernel("gather_rows", idx):
        return gather_rows_plain(idx, stacks, out, F)
    tensors = [idx, out] + list(stacks) + ([F] if F is not None else [])
    kernels.require_cuda("gather_rows", *tensors)
    count = idx.numel()
    ncell = (stacks[0].numel() // 3 if stacks
             else (F.numel() if F is not None else 0))
    if (idx.dtype != torch.int64 or out.dtype != torch.float32
            or out.dim() != 1 or len(stacks) > MAX_STACKS
            or any(v.dtype != torch.float32 or v.numel() != 3 * ncell
                   for v in stacks)
            or (F is not None and (F.dtype != torch.float32
                                   or F.numel() != ncell))
            or out.numel() != packed_size(count, len(stacks),
                                          F is not None)):
        raise ValueError("gather_rows: idx i64[count], stacks f32[3, *S] "
                         f"(at most {MAX_STACKS}), F f32[*S] and a 1-D f32 "
                         "out of packed_size floats expected")
    if rank is None:
        rank = needed_rank(idx, ncell)
    kernels.require_cuda("gather_rows", idx, rank)
    if rank.dtype != torch.int32 or rank.numel() != ncell:
        raise ValueError(f"gather_rows: rank i32[{ncell}] expected")
    ptrs = np.array([v.data_ptr() for v in stacks] + [0], np.uint64)
    rec = torch.empty((count, ROW_RECORD), dtype=torch.float32,
                      device=idx.device)
    err = kernels.lib().scatter_rows(
        rank.data_ptr(), ctypes.c_int64(ncell), ctypes.c_int64(count),
        F.data_ptr() if F is not None else None,
        ptrs.ctypes.data_as(ctypes.c_void_p), len(stacks), out.data_ptr(),
        rec.data_ptr(), kernels.stream_ptr(idx.device))
    kernels.check("gather_rows", err)
    kernels.LAUNCHES["gather_rows"] += 1
    return out


def needed_rank_plain(idx, ncell: int):
    """Plain version of the rank kernel: see needed_rank."""
    rank = torch.full((ncell,), -1, dtype=torch.int32, device=idx.device)
    rank[idx] = torch.arange(idx.numel(), dtype=torch.int32,
                             device=idx.device)
    return rank


def needed_rank(idx, ncell: int):
    """Each cell's position in the order idx (int64, from needed_order), -1
    for a cell that is not needed: int32 [ncell]."""
    if not kernels.plain_or_kernel("needed_rank", idx):
        return needed_rank_plain(idx, ncell)
    kernels.require_cuda("needed_rank", idx)
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.numel() > ncell:
        raise ValueError(f"needed_rank: idx i64[count <= {ncell}] expected")
    rank = torch.empty(ncell, dtype=torch.int32, device=idx.device)
    err = kernels.lib().needed_rank(idx.data_ptr(),
                                    ctypes.c_int64(idx.numel()),
                                    ctypes.c_int64(ncell), rank.data_ptr(),
                                    kernels.stream_ptr(idx.device))
    kernels.check("needed_rank", err)
    kernels.LAUNCHES["needed_rank"] += 1
    return rank


def kernel_info():
    """Registers, spill (local) bytes, shared bytes and resident 256-thread
    blocks per SM of the K6a kernels and K6b's, as the card's runtime
    reports them: {name: (regs, local, shared, blocks)}."""
    out = {}
    for which, name in enumerate(("needed_rank", "record pass (quads)",
                                  "record pass (cells)", "column pass",
                                  "pdf_hist")):
        info = (ctypes.c_int * 4)()
        kernels.check("compact_kernel_info",
                      kernels.lib().compact_kernel_info(which, info))
        out[name] = tuple(info)
    return out


def vrows_slab_plain(rank, comps, rows):
    """Plain version of K12: see vrows_slab."""
    sel = rank >= 0
    rows[rank[sel].long()] = comps[:, sel].T
    return rows


def vrows_slab(rank, comps, rows):
    """Scatter the needed cells of one slab of a displacement field into
    their rows: rows[rank[i]] = comps[:, i] for every i with rank[i] >= 0
    (rank int32 [n] from needed_rank, comps float32 [3, n], rows float32
    [count, 3], written IN PLACE)."""
    if not comps.is_cuda:
        kernels.plain_or_kernel("vrows_slab", comps)
        return vrows_slab_plain(rank, comps, rows)
    return launch_vrows(rank, comps, rows)


_VROWS = []


def _vrows_entry():
    """K12's C entry point, looked up in the kernel library once."""
    if not _VROWS:
        _VROWS.append(kernels.lib().vrows_slab)
    return _VROWS[0]


def launch_vrows(rank, comps, rows):
    """K12's launch: check the three tensors (one device, contiguous, their
    types and shapes), hand the C entry point their pointers, n and the
    comps device's current stream, and count the launch."""
    n = rank.numel()
    dev = comps.device
    if (rank.device != dev or rows.device != dev
            or rank.dtype != torch.int32 or comps.dtype != torch.float32
            or rows.dtype != torch.float32 or rank.dim() != 1
            or comps.shape != (3, n) or rows.dim() != 2
            or rows.shape[1] != 3 or not rank.is_contiguous()
            or not comps.is_contiguous() or not rows.is_contiguous()):
        raise ValueError("vrows_slab: contiguous rank i32[n], comps "
                         "f32[3, n] and rows f32[count, 3] on one device "
                         f"expected, got {rank.dtype} {tuple(rank.shape)} "
                         f"on {rank.device}, {comps.dtype} "
                         f"{tuple(comps.shape)} on {dev}, {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    err = _vrows_entry()(rank.data_ptr(), comps.data_ptr(), n,
                         rows.data_ptr(), kernels.stream_ptr(dev))
    if err:
        kernels.check("vrows_slab", err)
    kernels.LAUNCHES["vrows_slab"] += 1
    return rows


def pdf_hist_plain(Fmax):
    """Plain version of K6b: see pdf_hist."""
    x = torch.nan_to_num(Fmax.reshape(-1) * 10.0, nan=0.0)
    b = torch.clamp(x, 0.0, PDF_BINS - 1.0).to(torch.int64)
    return torch.bincount(b, minlength=PDF_BINS)


def pdf_hist(Fmax):
    """The FmaxPDF histogram on the device: int64 counts of
    clamp(int(F * 10), 0, 209), PDF_BINS bins of 0.1 in F.  The clamp is
    taken before the truncation (NaN gives bin 0): for every float that is
    the JAX package's clip of XLA's saturating float-to-int conversion."""
    if not kernels.plain_or_kernel("pdf_hist", Fmax):
        return pdf_hist_plain(Fmax)
    kernels.require_cuda("pdf_hist", Fmax)
    if Fmax.dtype != torch.float32:
        raise ValueError("pdf_hist: float32 Fmax expected")
    # the call zeroes the counts, then counts
    counts = torch.empty(PDF_BINS, dtype=torch.int64, device=Fmax.device)
    err = kernels.lib().pdf_hist(Fmax.data_ptr(),
                                 ctypes.c_int64(Fmax.numel()),
                                 counts.data_ptr(),
                                 kernels.stream_ptr(Fmax.device))
    kernels.check("pdf_hist", err)
    kernels.LAUNCHES["pdf_hist"] += 1
    return counts
