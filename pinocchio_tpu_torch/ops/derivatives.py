"""k-space derivatives of the smoothed potential (counterpart of
pinocchio_tpu/ops/derivatives.py, FFT branch).

Conventions (greens_function, fmax-pfft.c:444-456):
  second derivative:  +k_a k_b / k^2
  first derivative:   +i k_a / k^2
with k in grid units 2*pi*m/N and the smoothing radius in cell units.
Hessian component order ('ider'): xx yy zz xy xz yz.

``hessian_kspace``, ``gradient_kspace`` and ``gradient_kspace_tab`` are the
wrappers of the three entry points of the CUDA kernels ``csrc/kspace.cu``;
on a CPU tensor they run the plain PyTorch multiply.  On the card their
output lies kz outermost in memory (the [ncomp, N, N, N//2+1] result is a
view of [ncomp, N//2+1, N, N]), which is what the c2r plans read.  Their
``*_shard`` versions (K2s, K5s, K8s) apply the same multipliers to one
shard of a mesh's k layout, the window [N, y0:y0+ny, z0:z0+nz] of [N, N,
Nhp] (Nhp >= N//2+1 pads the kz axis so that it splits evenly; the padded
planes are zero in and out); the full-grid plain twins are the window
(0, 0).  The shard wrappers look their entry point up once (``_shard_entry``) and hand
it plain ints and floats; K8s takes its table as a tensor or as a
``GrowthTable`` whose scalars are made once (``pfft`` makes one per device
for the shards of a call).  The c2r
transforms are ``grids.irfft3_`` (the port's cuFFT plans on the card, in
the two-step decomposition), which consumes the multipliers' output: the
full-grid multipliers take its normalization as their ``scale``
(``grids.irfft3_scale``: 1/N^3 on the card, folded into the kernel's
multiply; 1 on the CPU); the shard forms keep 1 (their transforms are
``parallel.pfft``'s).  ``ooc_hessian``, ``ooc_gradient`` and
``ooc_pair`` are the wrappers of the out-of-core engine's per-kz-batch
factors (K10, also in ``csrc/kspace.cu``), ``ooc_gradient_tab`` that of its
gradient with a growth table (K14, a ``GrowthTable``).  Each of their modes
has two forms, picked by ``launch_factors`` from the strides of the source
batch: a resident spectrum's window (kz contiguous) or contiguous planes
(iy contiguous); the Hessian mode, which only reads K9's planes, has the
planes' form alone; any other layout raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..grids import irfft3, irfft3_, irfft3_scale, k_batch, k_window

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


def _scaled(out, scale: float):
    """out with both parts of every value times the real ``scale`` (the
    kernels' last multiply; the identity at 1), in place."""
    if scale != 1.0:
        torch.view_as_real(out).mul_(float(np.float32(scale)))
    return out


def hessian_kspace_plain(kdensity, R_grid: float, N: int,
                         scale: float = 1.0):
    return _scaled(hessian_kspace_shard_plain(kdensity, R_grid, N, 0, 0),
                   scale)


def gradient_kspace_shard_plain(src, growth: float, N: int, y0: int,
                                z0: int):
    """Plain version of K5s: see gradient_kspace_shard."""
    g = float(torch.tensor(growth, dtype=torch.float32))

    def fn(s, kv):
        base = s * complex(0.0, g) * kv[4]
        return torch.stack([base * kv[0], base * kv[1], base * kv[2]])
    return _plain_window(src, N, y0, z0, 3, fn)


def gradient_kspace_plain(kvector, growth: float, N: int,
                          scale: float = 1.0):
    return _scaled(gradient_kspace_shard_plain(kvector, growth, N, 0, 0),
                   scale)


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


def gradient_kspace_tab_plain(kvector, gtab, glo: float, gdx: float, N: int,
                              scale: float = 1.0):
    return _scaled(gradient_kspace_tab_shard_plain(kvector, gtab, glo, gdx, N,
                                                   0, 0), scale)


def _check_kspace(name, src, N):
    kernels.require_cuda(name, src)
    if src.dtype != torch.complex64 or tuple(src.shape) != (
            N, N, N // 2 + 1):
        raise ValueError(f"{name}: expected complex64 [{N}, {N}, "
                         f"{N // 2 + 1}], got {src.dtype} "
                         f"{tuple(src.shape)}")


def _kz_first_out(ncomp: int, src, N: int):
    """The [ncomp, N//2+1, N, N] output of K2, K5 or K8 (kz outermost, the
    layout grids.irfft3_ transforms in place); the wrappers hand it back as
    its [ncomp, N, N, N//2+1] view."""
    return torch.empty((ncomp, N // 2 + 1, N, N), dtype=torch.complex64,
                       device=src.device)


def hessian_kspace(kdensity, R_grid: float, N: int, scale: float = 1.0):
    """The 6 smoothed second-derivative multipliers applied to delta(k),
    each value's parts times the real ``scale`` last: complex64
    [6, N, N, N//2+1] in ider order."""
    if not kernels.plain_or_kernel("kspace_hessian", kdensity):
        return hessian_kspace_plain(kdensity, R_grid, N, scale)
    _check_kspace("kspace_hessian", kdensity, N)
    out = _kz_first_out(6, kdensity, N)
    err = kernels.lib().kspace_hessian(
        kdensity.data_ptr(), out.data_ptr(), N, float(R_grid), float(scale),
        kernels.stream_ptr(kdensity.device))
    kernels.check("kspace_hessian", err)
    kernels.LAUNCHES["kspace_hessian"] += 1
    return out.permute(0, 2, 3, 1)


def gradient_kspace(kvector, growth: float, N: int, scale: float = 1.0):
    """i k_a / k^2 * growth applied to a k-space source, times the real
    ``scale`` last: complex64 [3, N, N, N//2+1]."""
    if not kernels.plain_or_kernel("kspace_gradient", kvector):
        return gradient_kspace_plain(kvector, growth, N, scale)
    _check_kspace("kspace_gradient", kvector, N)
    out = _kz_first_out(3, kvector, N)
    err = kernels.lib().kspace_gradient(
        kvector.data_ptr(), out.data_ptr(), N, float(growth), float(scale),
        kernels.stream_ptr(kvector.device))
    kernels.check("kspace_gradient", err)
    kernels.LAUNCHES["kspace_gradient"] += 1
    return out.permute(0, 2, 3, 1)


def _table_args(name, gtab, glo: float, gdx: float, device):
    """(gtab, ntab, glo, gdx, tmax) of a growth-table kernel whose source
    lies on ``device``: the float32 scalars and tmax, the float32 clip of
    the table coordinate."""
    kernels.require_cuda(name, gtab)
    if gtab.device != device:
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {gtab.device} and {device}")
    return _table_scalars(name, gtab, glo, gdx)


def _table_scalars(name, gtab, glo: float, gdx: float):
    """_table_args without the device checks."""
    if gtab.dtype != torch.float32 or gtab.dim() != 1 or gtab.numel() < 2:
        raise ValueError(f"{name}: gtab must be f32[ntab], ntab >= 2")
    if not gtab.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous")
    ntab = gtab.numel()
    return (gtab.data_ptr(), ntab, float(np.float32(glo)),
            float(np.float32(gdx)), float(np.float32(ntab - 1.001)))


def gradient_kspace_tab(kvector, gtab, glo: float, gdx: float, N: int,
                        scale: float = 1.0):
    """i k_a / k^2 * growth(|k|) applied to a k-space source, the growth
    interpolated linearly in a table gtab [ntab] float32 over log10 |k|
    (|k| in grid units) from glo in steps of gdx, times the real ``scale``
    last: complex64 [3, N, N, N//2+1]."""
    if not kernels.plain_or_kernel("kspace_gradient_tab", kvector):
        return gradient_kspace_tab_plain(kvector, gtab, glo, gdx, N, scale)
    _check_kspace("kspace_gradient_tab", kvector, N)
    out = _kz_first_out(3, kvector, N)
    err = kernels.lib().kspace_gradient_tab(
        kvector.data_ptr(), out.data_ptr(), N,
        *_table_args("kspace_gradient_tab", gtab, glo, gdx, kvector.device),
        float(scale), kernels.stream_ptr(kvector.device))
    kernels.check("kspace_gradient_tab", err)
    kernels.LAUNCHES["kspace_gradient_tab"] += 1
    return out.permute(0, 2, 3, 1)


# the shard window kernels' C entry points, each looked up once
_SHARD_ENTRIES = {}


def _shard_entry(name: str):
    """The C entry point ``name`` of K2s, K5s or K8s, looked up in the
    kernel library once."""
    fn = _SHARD_ENTRIES.get(name)
    if fn is None:
        fn = _SHARD_ENTRIES[name] = getattr(kernels.lib(), name)
    return fn


def _shard_launch(name, src, ncomp: int, N: int, y0: int, z0: int, tail):
    """Launch the window kernel ``name`` on the shard src [N, ny, nz] at
    (y0, z0) of a mesh's k layout, on the shard's device and its current
    stream, with the kernel's own arguments ``tail`` (plain floats and
    ints): a complex64 [ncomp, N, ny, nz] result.  The device guard is
    entered only where another card is current."""
    shape = src.shape
    if (src.dtype != torch.complex64 or len(shape) != 3 or shape[0] != N
            or not 0 <= y0 <= y0 + shape[1] <= N or z0 < 0
            or not src.is_contiguous()):
        raise ValueError(f"{name}: a contiguous complex64 [{N}, ny, nz] "
                         f"shard inside the k layout expected, got "
                         f"{src.dtype} {tuple(shape)} at ({y0}, {z0})")
    dev = src.get_device()
    out = src.new_empty((ncomp, N, shape[1], shape[2]))
    args = (src.data_ptr(), out.data_ptr(), N, y0, shape[1], z0, shape[2],
            *tail, kernels.stream_ptr(dev))
    fn = _shard_entry(name)
    if dev == kernels.current_device():
        err = fn(*args)
    else:
        with kernels.on_device(src.device):
            err = fn(*args)
    if err:
        kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def hessian_kspace_shard(src, R_grid: float, N: int, y0: int, z0: int):
    """K2 on one shard of a mesh's k layout: src complex64 [N, ny, nz], the
    window of modes (all kx, ky y0..y0+ny-1, kz z0..z0+nz-1), gives the 6
    smoothed second-derivative multipliers [6, N, ny, nz] in ider order,
    zero on the padded planes kz > N/2."""
    if not src.is_cuda:
        kernels.plain_or_kernel("kspace_hessian_shard", src)
        return hessian_kspace_shard_plain(src, R_grid, N, y0, z0)
    return _shard_launch("kspace_hessian_shard", src, 6, N, int(y0),
                         int(z0), (float(R_grid),))


def gradient_kspace_shard(src, growth: float, N: int, y0: int, z0: int):
    """K5 on one shard (see hessian_kspace_shard): i k_a / k^2 * growth,
    complex64 [3, N, ny, nz]."""
    if not src.is_cuda:
        kernels.plain_or_kernel("kspace_gradient_shard", src)
        return gradient_kspace_shard_plain(src, growth, N, y0, z0)
    return _shard_launch("kspace_gradient_shard", src, 3, N, int(y0),
                         int(z0), (float(growth),))


def gradient_kspace_tab_shard(src, gtab, glo: float, gdx: float, N: int,
                              y0: int, z0: int):
    """K8 on one shard (see hessian_kspace_shard): i k_a / k^2 *
    growth(|k|) with the growth table gtab [ntab] on the shard's device,
    complex64 [3, N, ny, nz].  gtab may be a GrowthTable of glo and gdx,
    made once for the shards of a call: its float32 scalars are then
    computed on its first launch only."""
    if isinstance(gtab, GrowthTable):
        table = gtab
        if (table.glo, table.gdx) != (glo, gdx):
            raise ValueError("kspace_gradient_tab_shard: the GrowthTable's "
                             f"(glo, gdx) {(table.glo, table.gdx)} differ "
                             f"from {(glo, gdx)}")
    else:
        table = GrowthTable(gtab, glo, gdx)
    if not src.is_cuda:
        kernels.plain_or_kernel("kspace_gradient_tab_shard", src)
        return gradient_kspace_tab_shard_plain(src, table.gtab, glo, gdx, N,
                                               y0, z0)
    if table.gtab.device != src.device:
        raise ValueError(f"kspace_gradient_tab_shard: the shard and its "
                         f"table on one CUDA device expected, got "
                         f"{src.device} and {table.gtab.device}")
    return _shard_launch("kspace_gradient_tab_shard", src, 3, N, int(y0),
                         int(z0), table.args("kspace_gradient_tab_shard"))


def second_derivatives(kdensity, R_grid: float, N: int):
    """All 6 second derivatives of the smoothed inverse-Laplacian
    potential: float32 [6, N, N, N] in ider order (one batched c2r)."""
    return irfft3_(hessian_kspace(kdensity, R_grid, N,
                                  irfft3_scale(kdensity, N)), N)


def first_derivatives(kvector, growth: float, N: int):
    """The 3 first derivatives i k_a/k^2 of a k-space source scaled by a
    scalar growth factor: one displacement field float32 [3, N, N, N]."""
    return irfft3_(gradient_kspace(kvector, growth, N,
                                   irfft3_scale(kvector, N)), N)


def first_derivatives_tab(kvector, gtab, glo: float, gdx: float, N: int):
    """first_derivatives with a per-mode growth factor from a table over
    log10 |k| (scale-dependent growth, fmax-pfft.c:344-364)."""
    return irfft3_(gradient_kspace_tab(kvector, gtab, glo, gdx, N,
                                       irfft3_scale(kvector, N)), N)


def density_field(kdensity, N: int):
    """The real-space linear density contrast, float32 [N, N, N]: the c2r
    transform of delta(k), which is left as it was (cuFFT on the card)."""
    return irfft3(kdensity, N)


# ------------------------------------------------------------------
# K10 and K14: the out-of-core engine's factors on one batch of kz planes.
# A source batch is a complex64 [B, N, N] tensor or view in (kz, x, y)
# order: K9's planes and K19's widened batches (iy contiguous), or
# spectrum[:, :, kz0:kz0+B].permute(2, 0, 1) of a resident [N, N, N//2+1]
# spectrum (kz contiguous).  The result, [ncomp, B, N, N], is the input of
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


class GrowthTable:
    """One growth table of K14 or K8s: gtab [ntab] float32 over log10 |k|
    (|k| in grid units) from glo in steps of gdx, with the kernel's scalars
    (the float32 glo, gdx and coordinate clip ntab - 1.001) made once, on
    the first launch, for every launch after it."""

    def __init__(self, gtab, glo: float, gdx: float):
        self.gtab, self.glo, self.gdx = gtab, glo, gdx
        self._args = None

    def args(self, name: str = "ooc_factors_gradient_tab"):
        """(gtab pointer, ntab, glo, gdx, tmax) in the C prototype's order
        (_table_args'; the launch checks the table's device); ``name``
        names the kernel in the error of a table it refuses."""
        if self._args is None:
            self._args = _table_scalars(name, self.gtab, self.glo, self.gdx)
        return self._args


def growth_tables(gtabs, glo: float, gdx: float) -> list:
    """The GrowthTable of each row of growth_k_tables' [4, ntab] tables."""
    return [GrowthTable(gtabs[i], glo, gdx) for i in range(gtabs.shape[0])]


def ooc_gradient_tab_plain(src, kz0: int, table: GrowthTable, N: int):
    kx, ky, kz, k2, inv_k2 = k_batch(N, kz0, src.shape[0], src.device)
    growth = _growth_lookup(k2, table.gtab, table.glo, table.gdx)
    base = src * (1j * growth) * inv_k2
    return torch.stack([base * kx, base * ky, base * kz])


def ooc_pair_plain(src0, src1, kz0: int, ia: int, ib: int, N: int):
    kvec = k_batch(N, kz0, src0.shape[0], src0.device)
    f = kvec[ia] * kvec[ib]
    return torch.stack([src0 * kvec[4] * f, src1 * kvec[4] * f])


def _check_batch(name, src, kz0: int, N: int) -> None:
    """Raise unless src is a complex64 [B, N, N] batch of the planes
    kz0..kz0+B-1 of 0..N/2."""
    shape = src.shape
    if (src.dtype != torch.complex64 or len(shape) != 3
            or shape[1] != N or shape[2] != N
            or not 0 <= kz0 <= kz0 + shape[0] <= N // 2 + 1):
        raise ValueError(f"{name}: a complex64 [B, {N}, {N}] source batch "
                         f"of planes in 0..{N // 2} expected, got "
                         f"{src.dtype} {tuple(shape)} at kz {kz0}")


def _launch(name, mode, src, kz0: int, N: int, ncomp: int, tail,
            src0=None):
    """Check a CUDA source batch (and the pair mode's src0), launch the
    form of ``mode`` that its strides pick and count the launch: the
    complex64 [ncomp, B, N, N] factors."""
    dev = src.get_device()
    _check_batch(name, src, kz0, N)
    if src0 is not None:
        _check_batch(name, src0, kz0, N)
        if src0.get_device() != dev or src0.shape[0] != src.shape[0]:
            raise ValueError(f"{name}: sources of one batch on one device "
                             "expected")
    out = src.new_empty((ncomp,) + tuple(src.shape))
    err = launch_factors(mode, src, kz0, N, out, tail,
                         kernels.stream_ptr(dev), src0)
    if err:
        kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return out


def ooc_hessian(src, kz0: int, R_grid: float, N: int):
    """The 6 smoothed Hessian factors k_a k_b exp(-k^2 R^2/2) / k^2 on a
    source batch: complex64 [6, B, N, N] in ider order.  The source (K9's
    planes) has its iy axis contiguous; any other layout raises."""
    if src.get_device() < 0:
        kernels.plain_or_kernel("ooc_factors_hessian", src)
        return ooc_hessian_plain(src, kz0, R_grid, N)
    return _launch("ooc_factors_hessian", "hessian", src, kz0, N, 6,
                   (float(R_grid),))


def ooc_gradient(src, kz0: int, growth: float, N: int):
    """i k_a / k^2 * growth on a source batch: complex64 [3, B, N, N].  The
    source's strides pick the kernel's form (see ooc_gradient_tab)."""
    if src.get_device() < 0:
        kernels.plain_or_kernel("ooc_factors_gradient", src)
        return ooc_gradient_plain(src, kz0, growth, N)
    return _launch("ooc_factors_gradient", "gradient", src, kz0, N, 3,
                   (float(growth),))


def ooc_gradient_tab(src, kz0: int, table: GrowthTable, N: int):
    """i k_a / k^2 * growth(|k|) on a source batch, the growth interpolated
    linearly in a GrowthTable (as gradient_kspace_tab): complex64
    [3, B, N, N].  The source's strides pick the kernel's form: its iy axis
    contiguous (K9's planes, a 16-bit spectrum's widened batch) or its kz
    axis (a resident spectrum's window); any other layout raises."""
    if src.get_device() < 0:
        kernels.plain_or_kernel("ooc_factors_gradient_tab", src)
        return ooc_gradient_tab_plain(src, kz0, table, N)
    if table.gtab.get_device() != src.get_device():
        raise ValueError(f"ooc_factors_gradient_tab: the source batch and "
                         f"its table on one CUDA device expected, got "
                         f"{src.device} and {table.gtab.device}")
    return _launch("ooc_factors_gradient_tab", "gradient_tab", src, kz0, N,
                   3, table.args())


def ooc_pair(src0, src1, kz0: int, ia: int, ib: int, N: int):
    """k_a k_b / k^2 of one Hessian component (ia, ib in 0..2) on two
    source batches: complex64 [2, B, N, N].  src0 (K9's planes) has its iy
    axis contiguous; src1's strides pick the kernel's form (see
    ooc_gradient_tab)."""
    if src0.get_device() < 0:
        kernels.plain_or_kernel("ooc_factors_pair", src0)
        return ooc_pair_plain(src0, src1, kz0, ia, ib, N)
    return _launch("ooc_factors_pair", "pair", src1, kz0, N, 2,
                   (int(ia), int(ib)), src0)


# each mode's C entry points: its kz-fastest form, its rows form (the
# Hessian mode only ever reads K9's planes: rows alone)
FORMS = {"hessian": (None, "ooc_hessian_rows"),
         "gradient": ("ooc_gradient_kz", "ooc_gradient_rows"),
         "gradient_tab": ("ooc_gradient_tab_kz", "ooc_gradient_tab_rows"),
         "pair": ("ooc_pair_kz", "ooc_pair_rows")}
_ENTRIES = {}


def _entry(mode: str):
    """The C entry points of a K10 or K14 mode, (kz-fastest, rows), looked
    up in the kernel library once (None for a form the mode lacks)."""
    got = _ENTRIES.get(mode)
    if got is None:
        so = kernels.lib()
        got = _ENTRIES[mode] = tuple(nm and getattr(so, nm)
                                     for nm in FORMS[mode])
    return got


def launch_factors(mode: str, src, kz0: int, N: int, out, tail,
                   stream: int, src0=None) -> int:
    """Hand the form of a K10 or K14 mode that the strides of src [B, N, N]
    pick its arguments: the pair mode's src0 pointer and its kz and x
    strides (its iy axis contiguous), the source pointer and strides, out,
    N, kz0, B, the mode's own (tail) and the stream; returns the
    cudaError_t."""
    head = ()
    if src0 is not None:
        sb0, sx0, sy0 = src0.stride()
        if sy0 != 1:
            raise ValueError(f"ooc_factors_{mode}: a first source batch with "
                             f"its iy axis contiguous expected, got strides "
                             f"{tuple(src0.stride())}")
        head = (src0.data_ptr(), sb0, sx0)
    sb, sx, sy = src.stride()
    B = src.shape[0]
    if sy == 1:
        return _entry(mode)[1](*head, src.data_ptr(), sb, sx, out.data_ptr(),
                               N, kz0, B, *tail, stream)
    if sb == 1 and FORMS[mode][0]:
        return _entry(mode)[0](*head, src.data_ptr(), sx, sy, out.data_ptr(),
                               N, kz0, B, *tail, stream)
    axes = "iy or its kz axis" if FORMS[mode][0] else "iy axis"
    raise ValueError(f"ooc_factors_{mode}: a source batch with its {axes} "
                     f"contiguous expected, got strides "
                     f"{tuple(src.stride())}")
