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

The engine issues these launches one at a time between cuFFT calls, so a
wrapper's host time is part of each call: the four C entry points are
looked up once (``_entry``) and called with plain ints (their ctypes
argtypes declared in ``kernels``), the C side checks the alignment its
kernel's form depends on, and the launch goes to the current stream, read
at every call through torch's raw-stream query (a stream kept from an
earlier call would miss a ``torch.cuda.stream`` context).
"""

from __future__ import annotations

import torch

from .. import kernels

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_KIND = {torch.bfloat16: 0, torch.float16: 1}
_C64 = torch.complex64


def _kind(name, t, shape):
    kind = _KIND.get(t.dtype)
    if kind is None or shape[-1] != 2:
        raise ValueError(f"{name}: (re, im) pairs of bfloat16 or float16 "
                         f"expected, got {t.dtype} {tuple(shape)}")
    return kind


_ENTRY = None


def _entry():
    """K18's and K19's C entry points, store_kz, store_rows, load_kz and
    load_rows, looked up in the kernel library once."""
    global _ENTRY
    if _ENTRY is None:
        so = kernels.lib()
        _ENTRY = (so.storage_store_kz, so.storage_store_rows,
                  so.storage_load_kz, so.storage_load_rows)
    return _ENTRY


def _done(name, err):
    """After a launch: raise on its cudaError_t, else count it."""
    if err:
        kernels.check(name, err)
    kernels.LAUNCHES[name] += 1


def store_kz_plain(batch, stack, k: int):
    """Plain version of store_kz."""
    B = batch.shape[1]
    stack[:, :, :, k:k + B] = torch.view_as_real(batch).permute(
        0, 2, 3, 1, 4).to(stack.dtype)
    return stack


def store_kz(batch, stack, k: int):
    """K18, transposing: the complex64 kz batch [C, B, N, N] rounded into
    the planes k..k+B-1 of the 16-bit stack [C, N, N, W, 2], IN PLACE."""
    bs, ss = batch.shape, stack.shape
    kind = _kind("storage_store", stack, ss)
    if batch.dtype != _C64 or len(bs) != 4 or len(ss) != 5:
        raise ValueError("storage_store: a complex64 batch [C, B, N, N] and "
                         "a stack [C, N, N, W, 2] expected")
    C, B, n1, n2 = bs
    if ss[0] != C or ss[1] != n1 or ss[2] != n2:
        raise ValueError(f"storage_store: batch {tuple(bs)} does not fit "
                         f"the stack {tuple(ss)}")
    W = ss[3]
    if not 0 <= k <= k + B <= W:
        raise ValueError(f"storage_store: planes {k}..{k + B - 1} outside "
                         f"the stack's {W}")
    dev = batch.get_device()
    if dev < 0:
        kernels.plain_or_kernel("storage_store", batch)
        return store_kz_plain(batch, stack, k)
    if not (stack.get_device() == dev and batch.is_contiguous()
            and stack.is_contiguous()):
        kernels.require_cuda("storage_store", batch, stack)
    _done("storage_store", _entry()[0](
        batch.data_ptr(), stack.data_ptr(), kind, C, n1 * n2, B, W, k,
        kernels.stream_ptr(dev)))
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
    ss, ds = src.shape, dst.shape
    kind = _kind("storage_store", dst, ds)
    W, Ws = ds[-2], ss[-1]
    if (src.dtype != _C64 or ss[:-1] != ds[:-2]
            or not 0 <= col0 <= col0 + W <= Ws):
        raise ValueError(f"storage_store: rows {tuple(ss)} "
                         f"{src.dtype} do not fit {tuple(ds)} at "
                         f"column {col0}")
    dev = src.get_device()
    if dev < 0:
        kernels.plain_or_kernel("storage_store", src)
        return store_rows_plain(src, dst, col0)
    if not (dst.get_device() == dev and src.is_contiguous()
            and dst.is_contiguous()):
        kernels.require_cuda("storage_store", src, dst)
    _done("storage_store", _entry()[1](
        src.data_ptr(), dst.data_ptr(), kind, src.numel() // Ws if Ws else 0,
        W, Ws, col0, kernels.stream_ptr(dev)))
    return dst


def load_kz_plain(stack, k: int, B: int):
    """Plain version of load_kz."""
    return torch.view_as_complex(stack[:, :, :, k:k + B].permute(
        0, 3, 1, 2, 4).to(torch.float32, memory_format=torch.contiguous_format))


def load_kz(stack, k: int, B: int):
    """K19, transposing: the planes k..k+B-1 of the 16-bit stack
    [C, N, N, W, 2] as a complex64 kz batch [C, B, N, N]."""
    ss = stack.shape
    kind = _kind("storage_load", stack, ss)
    if len(ss) != 5:
        raise ValueError("storage_load: a stack [C, N, N, W, 2] expected")
    C, n1, n2, W = ss[0], ss[1], ss[2], ss[3]
    if not 0 <= k <= k + B <= W:
        raise ValueError(f"storage_load: planes {k}..{k + B - 1} outside "
                         f"the stack's {W}")
    dev = stack.get_device()
    if dev < 0:
        kernels.plain_or_kernel("storage_load", stack)
        return load_kz_plain(stack, k, B)
    if not stack.is_contiguous():
        kernels.require_cuda("storage_load", stack)
    out = stack.new_empty((C, B, n1, n2), dtype=_C64)
    _done("storage_load", _entry()[2](
        stack.data_ptr(), out.data_ptr(), kind, C, n1 * n2, B, W, k,
        kernels.stream_ptr(dev)))
    return out


def load_rows_plain(src, x0: int, Bx: int):
    """Plain version of load_rows."""
    return torch.view_as_complex(src[:, x0:x0 + Bx].to(
        torch.float32, memory_format=torch.contiguous_format))


def load_rows(src, x0: int, Bx: int):
    """K19, straight: the x window x0..x0+Bx-1 of the contiguous 16-bit
    src [C, X, ..., W, 2] (a stack, or an x-slab gathered from a stack's kz
    pieces) as complex64 [C, Bx, ..., W]."""
    ss = src.shape
    kind = _kind("storage_load", src, ss)
    if len(ss) < 3 or not 0 <= x0 <= x0 + Bx <= ss[1]:
        raise ValueError(f"storage_load: rows [C, X, ..., W, 2] with x "
                         f"{x0}..{x0 + Bx - 1} expected, got {tuple(ss)}")
    dev = src.get_device()
    if dev < 0:
        kernels.plain_or_kernel("storage_load", src)
        return load_rows_plain(src, x0, Bx)
    if not src.is_contiguous():
        kernels.require_cuda("storage_load", src)
    C, X = ss[0], ss[1]
    out = src.new_empty((C, Bx) + ss[2:-1], dtype=_C64)
    row = src.numel() // (2 * C * X) if C * X else 0
    _done("storage_load", _entry()[3](
        src.data_ptr() + 4 * x0 * row, out.data_ptr(), kind, C, Bx * row,
        X * row, kernels.stream_ptr(dev)))
    return out
