"""The out-of-core engine's 16-bit storage (the astype(self.dtype) stores and
the float32 upcasts of pinocchio_tpu/fmax_ooc.py's bfloat16 and float16
half-transform stacks and source spectra).

A 16-bit stack is [ncomp, N, N, nkz, 2] and a 16-bit spectrum [N, N, nkz, 2]
(x, y, kz, then the real and imaginary parts) in torch.bfloat16 or
torch.float16.  K18 (``store_kz``, ``store_rows``) rounds complex64 values
into such an array, to nearest even; K19 (``load_kz``, ``load_rows``) widens
a window of it back to complex64, exactly.  ``*_kz`` move a kz batch
[C, B, N, N] (the layout of an ifft2 or fft2 over (x, y)) to or from the
planes k..k+B-1, transposing; ``*_rows`` move rows whose kz axis is last.
The wrappers launch the kernels of ``csrc/storage.cu`` on CUDA tensors and
run the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import kernels

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_KIND = {torch.bfloat16: 0, torch.float16: 1}


def _kind(name, t):
    if t.dtype not in _KIND or t.shape[-1] != 2:
        raise ValueError(f"{name}: (re, im) pairs of bfloat16 or float16 "
                         f"expected, got {t.dtype} {tuple(t.shape)}")
    return _KIND[t.dtype]


def _launch(name, src, dst, kind, transpose, dims, src_off=0, dst_off=0):
    """One launch of K18 (name storage_store) or K19 (storage_load): dims
    (C, A, B, sc, sa, dc, da) in complex values, the pointers advanced by
    src_off and dst_off bytes, each aligned to its element (8 bytes for
    complex64, 4 for a pair)."""
    sp, dp = src.data_ptr() + src_off, dst.data_ptr() + dst_off
    for p, t in ((sp, src), (dp, dst)):
        if p % (8 if t.is_complex() else 4):
            raise ValueError(f"{name}: a misaligned window")
    err = getattr(kernels.lib(), name)(
        sp, dp, kind, int(transpose), *(ctypes.c_int64(int(d)) for d in dims),
        kernels.stream_ptr(src.device))
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1


def _check_batch(name, batch, stack):
    if batch.dtype != torch.complex64 or batch.dim() != 4 or stack.dim() != 5:
        raise ValueError(f"{name}: a complex64 batch [C, B, N, N] and a stack "
                         "[C, N, N, W, 2] expected")
    C, B, n1, n2 = batch.shape
    if tuple(stack.shape[:3]) != (C, n1, n2):
        raise ValueError(f"{name}: batch {tuple(batch.shape)} does not fit "
                         f"the stack {tuple(stack.shape)}")


def store_kz_plain(batch, stack, k: int):
    """Plain version of store_kz."""
    B = batch.shape[1]
    stack[:, :, :, k:k + B] = torch.view_as_real(batch).permute(
        0, 2, 3, 1, 4).to(stack.dtype)
    return stack


def store_kz(batch, stack, k: int):
    """K18, transposing: the complex64 kz batch [C, B, N, N] rounded into
    the planes k..k+B-1 of the 16-bit stack [C, N, N, W, 2], IN PLACE."""
    _check_batch("storage_store", batch, stack)
    kind = _kind("storage_store", stack)
    C, B = batch.shape[:2]
    W = stack.shape[3]
    if not 0 <= k <= k + B <= W:
        raise ValueError(f"storage_store: planes {k}..{k + B - 1} outside "
                         f"the stack's {W}")
    if not kernels.plain_or_kernel("storage_store", batch):
        return store_kz_plain(batch, stack, k)
    kernels.require_cuda("storage_store", batch, stack)
    M = batch.shape[2] * batch.shape[3]
    _launch("storage_store", batch, stack, kind, True,
            (C, M, B, B * M, M, M * W, W), dst_off=4 * k)
    return stack


def store_rows_plain(src, dst, col0: int):
    """Plain version of store_rows."""
    W = dst.shape[-2]
    dst[...] = torch.view_as_real(src[..., col0:col0 + W]).to(dst.dtype)
    return dst


def store_rows(src, dst, col0: int):
    """K18, straight: columns col0..col0+W-1 of the complex64 rows src
    [..., Ws] rounded into the 16-bit dst [..., W, 2] (the same leading
    shape), IN PLACE."""
    kind = _kind("storage_store", dst)
    W, Ws = dst.shape[-2], src.shape[-1]
    if (src.dtype != torch.complex64 or src.shape[:-1] != dst.shape[:-2]
            or not 0 <= col0 <= col0 + W <= Ws):
        raise ValueError(f"storage_store: rows {tuple(src.shape)} "
                         f"{src.dtype} do not fit {tuple(dst.shape)} at "
                         f"column {col0}")
    if not kernels.plain_or_kernel("storage_store", src):
        return store_rows_plain(src, dst, col0)
    kernels.require_cuda("storage_store", src, dst)
    A = math.prod(src.shape[:-1])
    _launch("storage_store", src, dst, kind, False, (1, A, W, 0, Ws, 0, W),
            src_off=8 * col0)
    return dst


def load_kz_plain(stack, k: int, B: int):
    """Plain version of load_kz."""
    return torch.view_as_complex(stack[:, :, :, k:k + B].permute(
        0, 3, 1, 2, 4).to(torch.float32, memory_format=torch.contiguous_format))


def load_kz(stack, k: int, B: int):
    """K19, transposing: the planes k..k+B-1 of the 16-bit stack
    [C, N, N, W, 2] as a complex64 kz batch [C, B, N, N]."""
    kind = _kind("storage_load", stack)
    if stack.dim() != 5:
        raise ValueError("storage_load: a stack [C, N, N, W, 2] expected")
    C, n1, n2, W = stack.shape[:4]
    if not 0 <= k <= k + B <= W:
        raise ValueError(f"storage_load: planes {k}..{k + B - 1} outside "
                         f"the stack's {W}")
    if not kernels.plain_or_kernel("storage_load", stack):
        return load_kz_plain(stack, k, B)
    kernels.require_cuda("storage_load", stack)
    out = torch.empty((C, B, n1, n2), dtype=torch.complex64,
                      device=stack.device)
    M = n1 * n2
    _launch("storage_load", stack, out, kind, True,
            (C, B, M, M * W, W, B * M, M), src_off=4 * k)
    return out


def load_rows_plain(src):
    """Plain version of load_rows."""
    return torch.view_as_complex(src.to(
        torch.float32, memory_format=torch.contiguous_format))


def load_rows(src):
    """K19, straight: the 16-bit src [C, ..., W, 2] (each src[c]
    contiguous, as an x-slab of a stack is) as complex64 [C, ..., W]."""
    kind = _kind("storage_load", src)
    if src.dim() < 3:
        raise ValueError("storage_load: rows [C, ..., W, 2] expected")
    if not kernels.plain_or_kernel("storage_load", src):
        return load_rows_plain(src)
    if not src[0].is_contiguous() or src.stride(0) % 2:
        raise ValueError("storage_load: each src[c] must be contiguous")
    kernels.require_cuda("storage_load", src[0])
    C, W = src.shape[0], src.shape[-2]
    A = math.prod(src.shape[1:-2])
    out = torch.empty(src.shape[:-1], dtype=torch.complex64,
                      device=src.device)
    _launch("storage_load", src, out, kind, False,
            (C, A, W, src.stride(0) // 2, W, A * W, W))
    return out
