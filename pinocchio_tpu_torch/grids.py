"""Grid descriptors, k-space utilities and the 3-D grid transforms
(counterpart of pinocchio_tpu/grids.py and backend.rfft3/irfft3).

Real fields are [N, N, N] float32 tensors in (x, y, z) order; k-space fields
are rfftn-layout [N, N, N//2+1] complex64 tensors, a stack of c of them
[c, N, N, N//2+1].  The c2r convention is 1/N^3, which is torch.fft's
default.

The 3-D transforms (``rfft3``, ``irfft3``, ``irfft3_``) take one of two
routes, picked by the tensor's device: on a card, cuFFT plans of the
port's own (``csrc/gridfft.cu``), whose layouts are the ones K2, K5 and K8
write and K3, K4 and K6a read, with no copy, clone or normalization pass
around the transforms; on the CPU, ``torch.fft``.  ``FFT_COUNTS`` counts
the 3-D transforms of each route ("direct", "torch").
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels


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
    _zero_real_planes(u, n)
    return torch.fft.irfft(u, n=n, dim=-1)


# 3-D transforms a process made, by route: "direct" through the port's
# cuFFT plans, "torch" through torch.fft (kernels.LAUNCHES counts the
# hand-written kernels alone)
FFT_COUNTS = {"direct": 0, "torch": 0}

# cufftType and the c2c directions (cufft.h)
CUFFT_R2C, CUFFT_C2R, CUFFT_C2C = 0x2a, 0x2c, 0x29
FORWARD, INVERSE = -1, 1


def plan_geometry(N: int, c: int) -> dict:
    """The cuFFT plans of a c-component 3-D transform at N^3, for
    cufftMakePlanMany64: {"c2c": the 2-D transform over (x, y), "z": the
    1-D c2r over z (the r2c is its mirror, input and output swapped)}, each
    rank, n, inembed, istride, idist, onembed, ostride, odist and batch,
    with ``calls``, the executions a transform makes (one a component), and
    ``step_in``, ``step_out``, the elements between two calls' inputs and
    outputs.  The spectrum lies kz outermost, [c, N//2+1, N, N], as K2, K5
    and K8 write it: each kz plane's (x, y) contiguous, z at stride N^2 (the
    2-D c2c at element stride N//2+1 on [c, N, N, N//2+1] runs about 12x
    slower at 512^3, PERF.md).  The real stack is [c, N, N, N] in (x, y, z)
    order."""
    Nh = N // 2 + 1
    c2c = dict(rank=2, n=(N, N), inembed=(N, N), istride=1, idist=N * N,
               onembed=(N, N), ostride=1, odist=N * N, batch=Nh, calls=c,
               step_in=Nh * N * N, step_out=Nh * N * N)
    z = dict(rank=1, n=(N,), inembed=(Nh,), istride=N * N, idist=1,
             onembed=(N,), ostride=1, odist=N, batch=N * N, calls=c,
             step_in=Nh * N * N, step_out=N ** 3)
    return dict(c2c=c2c, z=z)


def mirrored(g: dict) -> dict:
    """The r2c of a c2r geometry (plan_geometry's "z"): input and output
    swapped."""
    swap = dict(inembed="onembed", istride="ostride", idist="odist",
                step_in="step_out")
    swap.update({v: k for k, v in swap.items()})
    return {swap.get(k, k): v for k, v in g.items()}


# the keys of a geometry that its plan is made from (the rest say how a
# transform steps the plan through its components)
_PLAN_KEYS = ("rank", "n", "inembed", "istride", "idist", "onembed",
              "ostride", "odist", "batch")


class _Plans:
    """The port's cuFFT plans, made once per (device, type, geometry) and
    kept for the process (one serves every component count); a plan's
    stream and work area are set at each execution, under one lock (a plan
    is shared by every caller)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.made = {}                      # key -> (handle, work bytes)

    def get(self, dev: int, ctype: int, g: dict):
        key = (dev, ctype) + tuple(g[k] for k in _PLAN_KEYS)
        with self.lock:
            got = self.made.get(key)
            if got is None:
                got = self.made[key] = _make_plan(ctype, g)
        return got

    def execute(self, handle: int, ctype: int, direction: int, src: int,
                dst: int, work, stream: int) -> None:
        with self.lock:
            err = kernels.lib().gridfft_exec(handle, ctype, direction, src,
                                             dst, work, stream)
        if err:
            raise RuntimeError(f"cuFFT execution failed: cufftResult {err}")


def _make_plan(ctype: int, g: dict):
    """(handle, work-area bytes) of a new plan of geometry g on the current
    card."""
    def arr(v):
        return (ctypes.c_longlong * len(v))(*v)
    handle, work = ctypes.c_int(), ctypes.c_size_t()
    err = kernels.lib().gridfft_plan(
        g["rank"], arr(g["n"]), arr(g["inembed"]), g["istride"], g["idist"],
        arr(g["onembed"]), g["ostride"], g["odist"], ctype, g["batch"],
        ctypes.byref(handle), ctypes.byref(work))
    if err:
        raise RuntimeError(f"cuFFT plan {g} failed: cufftResult {err}")
    return handle.value, work.value


PLANS = _Plans()


def _run(plan, ctype: int, direction: int, g: dict, src, dst, work,
         stream: int) -> None:
    """Execute ``plan`` (PLANS.get's) g["calls"] times, stepping through
    src and dst, on ``stream`` with the work-area tensor ``work`` (or
    None)."""
    si = src.element_size() * g["step_in"]
    so = dst.element_size() * g["step_out"]
    ptr = None if work is None else work.data_ptr()
    for i in range(g["calls"]):
        PLANS.execute(plan[0], ctype, direction, src.data_ptr() + i * si,
                      dst.data_ptr() + i * so, ptr, stream)


def _work(plans, device):
    """One work area for every plan of a transform, from PyTorch's
    allocator on ``device`` (so that its peak counts it), or None where no
    plan asks for one."""
    size = max(p[1] for p in plans)
    return torch.empty(size, dtype=torch.uint8, device=device) if size \
        else None


def _direct_irfft3(spec, n: int, out) -> None:
    """The direct route of irfft3_: spec [c, n//2+1, n, n] (transformed in
    place over (x, y), then consumed by the c2r) into out [c, n, n, n]."""
    g = plan_geometry(n, spec.shape[0])
    dev = spec.get_device()
    xy = PLANS.get(dev, CUFFT_C2C, g["c2c"])
    z = PLANS.get(dev, CUFFT_C2R, g["z"])
    work, stream = _work((xy, z), spec.device), kernels.stream_ptr(dev)
    _run(xy, CUFFT_C2C, INVERSE, g["c2c"], spec, spec, work, stream)
    _zero_real_planes(spec, n, 1)
    _run(z, CUFFT_C2R, 0, g["z"], spec, out, work, stream)


def _direct_rfft3(x, n: int, spec) -> None:
    """The direct route of rfft3: x [c, n, n, n] into spec [c, n//2+1, n,
    n] over z, then over (x, y) in place."""
    g = plan_geometry(n, x.shape[0])
    gz = mirrored(g["z"])
    dev = x.get_device()
    z = PLANS.get(dev, CUFFT_R2C, gz)
    xy = PLANS.get(dev, CUFFT_C2C, g["c2c"])
    work, stream = _work((z, xy), x.device), kernels.stream_ptr(dev)
    _run(z, CUFFT_R2C, 0, gz, x, spec, work, stream)
    _run(xy, CUFFT_C2C, FORWARD, g["c2c"], spec, spec, work, stream)


def _zero_real_planes(u, n: int, dim: int = -1) -> None:
    """Zero the imaginary parts of the kz=0 and kz=n/2 planes (kz the axis
    ``dim``) in place: the 1-D irfft discards them (numpy's documented
    semantics), made explicit so that every FFT backend computes the same
    thing."""
    u.select(dim, 0).imag.zero_()
    if n % 2 == 0:
        u.select(dim, n // 2).imag.zero_()


def _on_card(t, fn, *args) -> None:
    """fn(*args) with t's card current (the plans are made and launched on
    the current card)."""
    if t.get_device() == kernels.current_device():
        fn(*args)
    else:
        with kernels.on_device(t.device):
            fn(*args)


def _kz_view(k, n: int):
    """k [.., n, n, n//2+1] complex64 viewed as [c, n//2+1, n, n] (c the
    product of its leading dims)."""
    nh = n // 2 + 1
    if k.dtype != torch.complex64 or tuple(k.shape[-3:]) != (n, n, nh):
        raise ValueError(f"irfft3: a complex64 [.., {n}, {n}, {nh}] "
                         f"spectrum expected, got {k.dtype} "
                         f"{tuple(k.shape)}")
    return k.reshape(-1, n, n, nh).permute(0, 3, 1, 2)


def rfft3(x):
    """3-D r2c transform over the last three axes, [.., N, N, N] float32 ->
    [.., N, N, N//2+1] complex64, contiguous, as a 1-D rfft over z then a
    2-D fft over (x, y) (the JAX package's backend.rfft3 decomposition).
    The input is left as it was.  On a card the plans work kz outermost,
    and the result is transposed into place once."""
    n = x.shape[-1]
    if not x.is_cuda:
        FFT_COUNTS["torch"] += 1
        return torch.fft.fft2(torch.fft.rfft(x, dim=-1),
                              dim=(-3, -2)).contiguous()
    if x.dtype != torch.float32 or tuple(x.shape[-3:]) != (n, n, n):
        raise ValueError(f"rfft3: a float32 [.., {n}, {n}, {n}] field "
                         f"expected, got {x.dtype} {tuple(x.shape)}")
    xs = x.reshape(-1, n, n, n).contiguous()
    spec = torch.empty((xs.shape[0], n // 2 + 1, n, n), dtype=torch.complex64,
                       device=x.device)
    _on_card(x, _direct_rfft3, xs, n, spec)
    FFT_COUNTS["direct"] += 1
    return spec.permute(0, 2, 3, 1).contiguous().view(
        x.shape[:-1] + (n // 2 + 1,))


def irfft3_scale(k, n: int) -> float:
    """The factor by which a spectrum headed for irfft3_ has to have been
    multiplied: 1/n^3 on a card, whose plans do not normalize (K2, K5 and
    K8 take it as their ``scale``), and 1 on the CPU, where torch.fft
    normalizes."""
    return 1.0 / n ** 3 if k.is_cuda else 1.0


def irfft3_(k, n: int):
    """3-D c2r transform over the last three axes, [.., N, N, N//2+1] ->
    [.., N, N, N], of a spectrum already multiplied by irfft3_scale(k, n):
    a 2-D ifft over (x, y), then a 1-D irfft over z.  It CONSUMES k: on a
    card a spectrum that lies kz outermost (K2's, K5's, K8's output) is
    transformed in its own memory and cuFFT's c2r overwrites it, so only a
    caller that drops k may hand it in (any other layout is first copied
    into that one).

    The input need not be Hermitian on the kx and ky Nyquist planes (an
    i*k_a multiply breaks that), so the 3-D C2R of a library may treat
    those planes differently from the JAX package's two-step transform.
    The 1-D irfft discards the imaginary part of the kz=0 and kz=N/2
    planes (numpy's documented semantics); it is zeroed here explicitly so
    that every FFT backend computes the same thing (irfft_z)."""
    if not k.is_cuda:
        FFT_COUNTS["torch"] += 1
        return irfft_z(torch.fft.ifft2(k, dim=(-3, -2)), n)
    spec = _kz_view(k, n).contiguous()      # k's memory if kz outermost
    out = torch.empty((spec.shape[0], n, n, n), dtype=torch.float32,
                      device=k.device)
    _on_card(k, _direct_irfft3, spec, n, out)
    FFT_COUNTS["direct"] += 1
    return out.view(k.shape[:-1] + (n,))


def irfft3(k, n: int):
    """irfft3_ of a spectrum that the caller keeps: the normalized 3-D c2r
    transform, k left as it was (on a card, the scaled copy that irfft3_
    consumes is made kz outermost in one pass)."""
    if not k.is_cuda:
        return irfft3_(k, n)
    src = _kz_view(k, n)
    buf = torch.empty(src.shape, dtype=torch.complex64, device=k.device)
    torch.mul(torch.view_as_real(src), irfft3_scale(k, n),
              out=torch.view_as_real(buf))
    return irfft3_(buf.permute(0, 2, 3, 1), n).view(k.shape[:-1] + (n,))


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
