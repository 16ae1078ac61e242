"""Grid descriptors and k-space utilities (counterpart of
pinocchio_tpu/grids.py).

Real fields are [N, N, N] float32 tensors in (x, y, z) order; k-space fields
are rfftn-layout [N, N, N//2+1] complex64 tensors.  The c2r convention is
1/N^3, which is torch.fft's default.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Grid:
    N: int                      # grid points per side
    BoxSize: float              # true Mpc

    @property
    def CellSize(self) -> float:
        return self.BoxSize / self.N


def signed_modes(N: int) -> np.ndarray:
    """Signed integer mode numbers m for an FFT axis: 0..N/2, -(N/2-1)..-1."""
    m = np.arange(N)
    return np.where(m <= N // 2, m, m - N)


def k_window(N: int, y0: int, ny: int, z0: int, nz: int, device):
    """(kx, ky, kz, k^2, 1/k^2 with the k=0 mode set to 0) in grid units
    (2*pi*m/N, computed in float64 and rounded to float32), broadcastable to
    the window [N, y0:y0+ny, z0:z0+nz] of the rfftn layout; the kz axis is
    |kz|.  The whole layout is the window (0, N, 0, N//2+1); a mesh's shard
    is the window its k block covers (planes beyond N//2 get the k of their
    index, which a caller zeroes)."""
    two_pi = 2.0 * np.pi / N
    m = signed_modes(N)
    f32 = dict(dtype=torch.float32, device=device)
    kx = torch.tensor(two_pi * m, **f32).reshape(N, 1, 1)
    ky = torch.tensor(two_pi * m[y0:y0 + ny], **f32).reshape(1, ny, 1)
    kz = torch.tensor(two_pi * np.arange(z0, z0 + nz), **f32
                      ).reshape(1, 1, nz)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0),
                         0.0)
    return kx, ky, kz, k2, inv_k2


def inverse_k2(N: int, device):
    """(kx, ky, kz, k^2, 1/k^2 with the k=0 mode set to 0), float32, over
    the whole rfftn layout [N, N, N//2+1]."""
    return k_window(N, 0, N, 0, N // 2 + 1, device)


def irfft_z(u, n: int):
    """c2r over the last axis, [.., n//2+1] -> [.., n], of a tensor the
    caller owns: the imaginary parts of the kz=0 and kz=n/2 planes are
    zeroed IN PLACE first, numpy's documented semantics, so that every FFT
    backend computes the same thing."""
    u[..., 0].imag.zero_()
    if n % 2 == 0:
        u[..., n // 2].imag.zero_()
    return torch.fft.irfft(u, n=n, dim=-1)


def rfft3(x):
    """3-D r2c transform over the last three axes, [.., N, N, N] ->
    [.., N, N, N//2+1], as a 1-D rfft over z then a 2-D fft over (x, y)
    (the JAX package's backend.rfft3 decomposition).  The result is
    contiguous (cuFFT may hand back permuted strides)."""
    return torch.fft.fft2(torch.fft.rfft(x, dim=-1),
                          dim=(-3, -2)).contiguous()


def irfft3(k, n: int):
    """3-D c2r transform over the last three axes, [.., N, N, N//2+1] ->
    [.., N, N, N]: a 2-D ifft over (x, y), then a 1-D irfft over z.

    The input need not be Hermitian on the kx and ky Nyquist planes (an
    i*k_a multiply breaks that), so the 3-D C2R of a library may treat
    those planes differently from the JAX package's two-step transform.
    The 1-D irfft discards the imaginary part of the kz=0 and kz=N/2
    planes (numpy's documented semantics); it is zeroed here explicitly so
    that every FFT backend computes the same thing (irfft_z)."""
    return irfft_z(torch.fft.ifft2(k, dim=(-3, -2)), n)


def k_batch(N: int, kz0: int, B: int, device):
    """(kx, ky, kz, k^2, 1/k^2 with k=0 set to 0) in grid units, float32,
    broadcastable to a [B, N, N] batch of the kz planes kz0..kz0+B-1 in
    (kz, x, y) order (the out-of-core engine's plane batches)."""
    k1 = (2.0 * np.pi / N) * signed_modes(N)
    kz = (2.0 * np.pi / N) * np.arange(kz0, kz0 + B)
    f32 = dict(dtype=torch.float32, device=device)
    kx = torch.tensor(k1, **f32).reshape(1, N, 1)
    ky = torch.tensor(k1, **f32).reshape(1, 1, N)
    kz = torch.tensor(kz, **f32).reshape(B, 1, 1)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0),
                         0.0)
    return kx, ky, kz, k2, inv_k2
