"""k-space derivatives of the smoothed potential (counterpart of
pinocchio_tpu/ops/derivatives.py, FFT branch).

Conventions (greens_function, fmax-pfft.c:444-456):
  second derivative:  +k_a k_b / k^2
  first derivative:   +i k_a / k^2
with k in grid units 2*pi*m/N and the smoothing radius in cell units.
Hessian component order ('ider'): xx yy zz xy xz yz.

``hessian_kspace``, ``gradient_kspace`` and ``gradient_kspace_tab`` are the
wrappers of the three entry points of the CUDA kernels ``csrc/kspace.cu``;
on a CPU tensor they run the plain PyTorch multiply.  Their ``*_shard``
versions (K2s, K5s, K8s) apply the same multipliers to one shard of a
mesh's k layout, the window [N, y0:y0+ny, z0:z0+nz] of [N, N, Nhp] (Nhp >=
N//2+1 pads the kz axis so that it splits evenly; the padded planes are
zero in and out); the full-grid functions are the window (0, 0).  The c2r
transforms are ``torch.fft`` (cuFFT on the card) in the two-step
decomposition of ``grids.irfft3``.  ``ooc_hessian``, ``ooc_gradient`` and ``ooc_pair`` are
the wrappers of the out-of-core engine's per-kz-batch factors (K10, also in
``csrc/kspace.cu``), ``ooc_gradient_tab`` that of its gradient with a growth
table (K14).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..grids import irfft3, k_batch, k_window

SECOND_DERIV_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _plain_window(src, N: int, y0: int, z0: int, ncomp: int, fn):
    """A plain twin over the shard src [N, ny, nz] at (y0, z0): fn(src of
    the planes kz < N//2+1, their k_window) -> [ncomp, N, ny, nz'], the
    padded planes exactly zero."""
    ny, nz = src.shape[1], src.shape[2]
    nzv = max(0, min(nz, N // 2 + 1 - z0))
    kv = k_window(N, y0, ny, z0, nzv, src.device)
    got = fn(src[..., :nzv], kv)
    if nzv == nz:
        return got
    out = torch.zeros((ncomp,) + tuple(src.shape), dtype=got.dtype,
                      device=src.device)
    out[..., :nzv] = got
    return out


def hessian_kspace_shard_plain(src, R_grid: float, N: int, y0: int,
                               z0: int):
    """Plain version of K2s: see hessian_kspace_shard."""
    def fn(s, kv):
        R = torch.tensor(R_grid, dtype=torch.float32)
        base = s * (torch.exp(-0.5 * kv[3] * R * R) * kv[4])
        return torch.stack([base * (kv[a] * kv[b])
                            for a, b in SECOND_DERIV_PAIRS])
    return _plain_window(src, N, y0, z0, 6, fn)


def hessian_kspace_plain(kdensity, R_grid: float, N: int):
    return hessian_kspace_shard_plain(kdensity, R_grid, N, 0, 0)


def gradient_kspace_shard_plain(src, growth: float, N: int, y0: int,
                                z0: int):
    """Plain version of K5s: see gradient_kspace_shard."""
    g = float(torch.tensor(growth, dtype=torch.float32))

    def fn(s, kv):
        base = s * complex(0.0, g) * kv[4]
        return torch.stack([base * kv[0], base * kv[1], base * kv[2]])
    return _plain_window(src, N, y0, z0, 3, fn)


def gradient_kspace_plain(kvector, growth: float, N: int):
    return gradient_kspace_shard_plain(kvector, growth, N, 0, 0)


def _scalar(x, device):
    """A float32 0-dim tensor on ``device``: dividing by it is a true
    division on every backend (PyTorch's CUDA division by a Python or CPU
    scalar multiplies by the reciprocal), as for the JAX package's traced
    scalars."""
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _growth_lookup(k2, gtab, glo: float, gdx: float):
    """The growth of each mode, interpolated linearly in gtab over
    log10 |k| from glo in steps of gdx."""
    logk = 0.5 * torch.log10(torch.clamp(k2, min=1e-12))
    t = torch.clamp((logk - _scalar(glo, k2.device))
                    / _scalar(gdx, k2.device), 0.0, gtab.shape[0] - 1.001)
    i = t.to(torch.int32)
    w = t - i.float()
    i = i.long()
    return gtab[i] * (1.0 - w) + gtab[i + 1] * w


def gradient_kspace_tab_shard_plain(src, gtab, glo: float, gdx: float,
                                    N: int, y0: int, z0: int):
    """Plain version of K8s: see gradient_kspace_tab_shard."""
    def fn(s, kv):
        base = s * (1j * _growth_lookup(kv[3], gtab, glo, gdx)) * kv[4]
        return torch.stack([base * kv[0], base * kv[1], base * kv[2]])
    return _plain_window(src, N, y0, z0, 3, fn)


def gradient_kspace_tab_plain(kvector, gtab, glo: float, gdx: float, N: int):
    return gradient_kspace_tab_shard_plain(kvector, gtab, glo, gdx, N, 0, 0)


def _check_kspace(name, src, N):
    kernels.require_cuda(name, src)
    if src.dtype != torch.complex64 or tuple(src.shape) != (
            N, N, N // 2 + 1):
        raise ValueError(f"{name}: expected complex64 [{N}, {N}, "
                         f"{N // 2 + 1}], got {src.dtype} "
                         f"{tuple(src.shape)}")


def hessian_kspace(kdensity, R_grid: float, N: int):
    """The 6 smoothed second-derivative multipliers applied to delta(k):
    complex64 [6, N, N, N//2+1] in ider order."""
    if not kernels.plain_or_kernel("kspace_hessian", kdensity):
        return hessian_kspace_plain(kdensity, R_grid, N)
    _check_kspace("kspace_hessian", kdensity, N)
    out = torch.empty((6,) + tuple(kdensity.shape), dtype=torch.complex64,
                      device=kdensity.device)
    err = kernels.lib().kspace_hessian(
        kdensity.data_ptr(), out.data_ptr(), N, float(R_grid),
        kernels.stream_ptr(kdensity.device))
    kernels.check("kspace_hessian", err)
    kernels.LAUNCHES["kspace_hessian"] += 1
    return out


def gradient_kspace(kvector, growth: float, N: int):
    """i k_a / k^2 * growth applied to a k-space source: complex64
    [3, N, N, N//2+1]."""
    if not kernels.plain_or_kernel("kspace_gradient", kvector):
        return gradient_kspace_plain(kvector, growth, N)
    _check_kspace("kspace_gradient", kvector, N)
    out = torch.empty((3,) + tuple(kvector.shape), dtype=torch.complex64,
                      device=kvector.device)
    err = kernels.lib().kspace_gradient(
        kvector.data_ptr(), out.data_ptr(), N, float(growth),
        kernels.stream_ptr(kvector.device))
    kernels.check("kspace_gradient", err)
    kernels.LAUNCHES["kspace_gradient"] += 1
    return out


def _table_args(name, gtab, glo: float, gdx: float, device):
    """(gtab, ntab, glo, gdx, tmax) of a growth-table kernel whose source
    lies on ``device``: the float32 scalars and tmax, the float32 clip of
    the table coordinate."""
    kernels.require_cuda(name, gtab)
    if gtab.device != device:
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {gtab.device} and {device}")
    if gtab.dtype != torch.float32 or gtab.dim() != 1 or gtab.numel() < 2:
        raise ValueError(f"{name}: gtab must be f32[ntab], ntab >= 2")
    ntab = gtab.numel()
    return (gtab.data_ptr(), ntab, float(np.float32(glo)),
            float(np.float32(gdx)), float(np.float32(ntab - 1.001)))


def gradient_kspace_tab(kvector, gtab, glo: float, gdx: float, N: int):
    """i k_a / k^2 * growth(|k|) applied to a k-space source, the growth
    interpolated linearly in a table gtab [ntab] float32 over log10 |k|
    (|k| in grid units) from glo in steps of gdx: complex64
    [3, N, N, N//2+1]."""
    if not kernels.plain_or_kernel("kspace_gradient_tab", kvector):
        return gradient_kspace_tab_plain(kvector, gtab, glo, gdx, N)
    _check_kspace("kspace_gradient_tab", kvector, N)
    out = torch.empty((3,) + tuple(kvector.shape), dtype=torch.complex64,
                      device=kvector.device)
    err = kernels.lib().kspace_gradient_tab(
        kvector.data_ptr(), out.data_ptr(), N,
        *_table_args("kspace_gradient_tab", gtab, glo, gdx, kvector.device),
        kernels.stream_ptr(kvector.device))
    kernels.check("kspace_gradient_tab", err)
    kernels.LAUNCHES["kspace_gradient_tab"] += 1
    return out


def _shard_launch(name, src, ncomp, N, y0, z0, *tail):
    """Launch the window kernel ``name`` on the shard src [N, ny, nz] at
    (y0, z0) of a mesh's k layout, on the shard's device and stream: a
    complex64 [ncomp, N, ny, nz] result."""
    kernels.require_cuda(name, src)
    if (src.dtype != torch.complex64 or src.dim() != 3 or src.shape[0] != N
            or not 0 <= y0 <= y0 + src.shape[1] <= N or z0 < 0):
        raise ValueError(f"{name}: a complex64 [{N}, ny, nz] shard inside "
                         f"the k layout expected, got {src.dtype} "
                         f"{tuple(src.shape)} at ({y0}, {z0})")
    out = torch.empty((ncomp,) + tuple(src.shape), dtype=torch.complex64,
                      device=src.device)
    with kernels.on_device(src.device):
        err = getattr(kernels.lib(), name)(
            src.data_ptr(), out.data_ptr(), N, int(y0), src.shape[1],
            int(z0), src.shape[2], *tail, kernels.stream_ptr(src.device))
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def hessian_kspace_shard(src, R_grid: float, N: int, y0: int, z0: int):
    """K2 on one shard of a mesh's k layout: src complex64 [N, ny, nz], the
    window of modes (all kx, ky y0..y0+ny-1, kz z0..z0+nz-1), gives the 6
    smoothed second-derivative multipliers [6, N, ny, nz] in ider order,
    zero on the padded planes kz > N/2."""
    if not kernels.plain_or_kernel("kspace_hessian_shard", src):
        return hessian_kspace_shard_plain(src, R_grid, N, y0, z0)
    return _shard_launch("kspace_hessian_shard", src, 6, N, y0, z0,
                         float(R_grid))


def gradient_kspace_shard(src, growth: float, N: int, y0: int, z0: int):
    """K5 on one shard (see hessian_kspace_shard): i k_a / k^2 * growth,
    complex64 [3, N, ny, nz]."""
    if not kernels.plain_or_kernel("kspace_gradient_shard", src):
        return gradient_kspace_shard_plain(src, growth, N, y0, z0)
    return _shard_launch("kspace_gradient_shard", src, 3, N, y0, z0,
                         float(growth))


def gradient_kspace_tab_shard(src, gtab, glo: float, gdx: float, N: int,
                              y0: int, z0: int):
    """K8 on one shard (see hessian_kspace_shard): i k_a / k^2 *
    growth(|k|) with the growth table gtab [ntab] on the shard's device,
    complex64 [3, N, ny, nz]."""
    if not kernels.plain_or_kernel("kspace_gradient_tab_shard", src):
        return gradient_kspace_tab_shard_plain(src, gtab, glo, gdx, N, y0,
                                               z0)
    return _shard_launch("kspace_gradient_tab_shard", src, 3, N, y0, z0,
                         *_table_args("kspace_gradient_tab_shard", gtab, glo,
                                      gdx, src.device))


def second_derivatives(kdensity, R_grid: float, N: int):
    """All 6 second derivatives of the smoothed inverse-Laplacian
    potential: float32 [6, N, N, N] in ider order (one batched c2r)."""
    return irfft3(hessian_kspace(kdensity, R_grid, N), N)


def first_derivatives(kvector, growth: float, N: int):
    """The 3 first derivatives i k_a/k^2 of a k-space source scaled by a
    scalar growth factor: one displacement field float32 [3, N, N, N]."""
    return irfft3(gradient_kspace(kvector, growth, N), N)


def first_derivatives_tab(kvector, gtab, glo: float, gdx: float, N: int):
    """first_derivatives with a per-mode growth factor from a table over
    log10 |k| (scale-dependent growth, fmax-pfft.c:344-364)."""
    return irfft3(gradient_kspace_tab(kvector, gtab, glo, gdx, N), N)


def density_field(kdensity, N: int):
    """The real-space linear density contrast, float32 [N, N, N]: the c2r
    transform of delta(k) (a library call, cuFFT on the card)."""
    return irfft3(kdensity, N)


# ------------------------------------------------------------------
# K10: the out-of-core engine's factors on one batch of kz planes.  A source
# batch is a complex64 [B, N, N] tensor or view in (kz, x, y) order: K9's
# planes, or spectrum[:, :, kz0:kz0+B].permute(2, 0, 1) of a resident
# [N, N, N//2+1] spectrum.  The result, [ncomp, B, N, N], is the input of
# one batched ifft2 over (x, y).
# ------------------------------------------------------------------

def ooc_hessian_plain(src, kz0: int, R_grid: float, N: int):
    kx, ky, kz, k2, inv_k2 = k_batch(N, kz0, src.shape[0], src.device)
    R = torch.tensor(R_grid, dtype=torch.float32)
    base = src * (torch.exp(-0.5 * k2 * R * R) * inv_k2)
    kvec = (kx, ky, kz)
    return torch.stack([base * (kvec[a] * kvec[b])
                        for a, b in SECOND_DERIV_PAIRS])


def ooc_gradient_plain(src, kz0: int, growth: float, N: int):
    kx, ky, kz, _, inv_k2 = k_batch(N, kz0, src.shape[0], src.device)
    g = float(torch.tensor(growth, dtype=torch.float32))
    base = src * complex(0.0, g) * inv_k2
    return torch.stack([base * kx, base * ky, base * kz])


def ooc_gradient_tab_plain(src, kz0: int, gtab, glo: float, gdx: float,
                           N: int):
    kx, ky, kz, k2, inv_k2 = k_batch(N, kz0, src.shape[0], src.device)
    growth = _growth_lookup(k2, gtab, glo, gdx)
    base = src * (1j * growth) * inv_k2
    return torch.stack([base * kx, base * ky, base * kz])


def ooc_pair_plain(src0, src1, kz0: int, ia: int, ib: int, N: int):
    kvec = k_batch(N, kz0, src0.shape[0], src0.device)
    f = kvec[ia] * kvec[ib]
    return torch.stack([src0 * kvec[4] * f, src1 * kvec[4] * f])


def _batch_args(name, src, N):
    if src.device.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {src.device}")
    if (src.dtype != torch.complex64 or src.dim() != 3
            or tuple(src.shape[1:]) != (N, N)):
        raise ValueError(f"{name}: a complex64 [B, {N}, {N}] source batch "
                         f"expected, got {src.dtype} {tuple(src.shape)}")
    return [src.data_ptr()] + [ctypes.c_int64(s) for s in src.stride()]


def _launch_batch(name, srcs, ncomp, kz0, N, *tail):
    dev = srcs[0].device
    B = srcs[0].shape[0]
    if any(s.device != dev or s.shape[0] != B for s in srcs):
        raise ValueError(f"{name}: sources of one batch on one device "
                         "expected")
    if not 0 <= kz0 <= kz0 + B <= N // 2 + 1:
        raise ValueError(f"{name}: planes {kz0}..{kz0 + B - 1} outside "
                         f"0..{N // 2}")
    args = [a for s in srcs for a in _batch_args(name, s, N)]
    out = torch.empty((ncomp, B, N, N), dtype=torch.complex64, device=dev)
    err = getattr(kernels.lib(), name)(*args, out.data_ptr(), N, int(kz0),
                                       int(B), *tail,
                                       kernels.stream_ptr(dev))
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def ooc_hessian(src, kz0: int, R_grid: float, N: int):
    """The 6 smoothed Hessian factors k_a k_b exp(-k^2 R^2/2) / k^2 on a
    source batch: complex64 [6, B, N, N] in ider order."""
    if not kernels.plain_or_kernel("ooc_factors_hessian", src):
        return ooc_hessian_plain(src, kz0, R_grid, N)
    return _launch_batch("ooc_factors_hessian", [src], 6, kz0, N,
                         float(R_grid))


def ooc_gradient(src, kz0: int, growth: float, N: int):
    """i k_a / k^2 * growth on a source batch: complex64 [3, B, N, N]."""
    if not kernels.plain_or_kernel("ooc_factors_gradient", src):
        return ooc_gradient_plain(src, kz0, growth, N)
    return _launch_batch("ooc_factors_gradient", [src], 3, kz0, N,
                         float(growth))


def ooc_gradient_tab(src, kz0: int, gtab, glo: float, gdx: float, N: int):
    """i k_a / k^2 * growth(|k|) on a source batch, the growth interpolated
    linearly in a table gtab [ntab] float32 over log10 |k| (as
    gradient_kspace_tab): complex64 [3, B, N, N]."""
    if not kernels.plain_or_kernel("ooc_factors_gradient_tab", src):
        return ooc_gradient_tab_plain(src, kz0, gtab, glo, gdx, N)
    return _launch_batch("ooc_factors_gradient_tab", [src], 3, kz0, N,
                         *_table_args("ooc_factors_gradient_tab", gtab, glo,
                                      gdx, src.device))


def ooc_pair(src0, src1, kz0: int, ia: int, ib: int, N: int):
    """k_a k_b / k^2 of one Hessian component (ia, ib in 0..2) on two
    source batches: complex64 [2, B, N, N]."""
    if not kernels.plain_or_kernel("ooc_factors_pair", src0):
        return ooc_pair_plain(src0, src1, kz0, ia, ib, N)
    return _launch_batch("ooc_factors_pair", [src0, src1], 2, kz0, N,
                         int(ia), int(ib))
