"""Initial conditions: Gaussian linear density field in k-space
(counterpart of pinocchio_tpu/ic.py).

delta(k) = Box^{-3/2} N^3 sqrt(P(|k|) E) exp(i phase), E ~ Exp(1), with the
Nyquist and spherical cut, the kz=0 Hermitian mirror and the Fixed/Paired
switches (GenIC.c:188-446).  The draws reproduce the JAX package's exactly:
a plain threefry2x32 replicates ``jax.random.split`` and
``jax.random.uniform`` (partitionable threefry), so the same seed gives the
same bits and, up to float32 rounding of the transcendentals, the same
field.

``kdensity`` is the wrapper of the CUDA kernel ``csrc/ic_kdensity.cu``; on
CPU tables it runs ``kdensity_plain``.  ``kdensity_shard`` (K1s) computes one
shard of a mesh's k layout with the same kernel: each mode draws at its
global counter, so every shard holds the single-device field's values.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import kernels
from .grids import Grid

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
AMPL_MIN = 1.1754944e-38


def threefry2x32(k0: int, k1: int, x0, x1):
    """threefry2x32 (20 rounds) on int64 tensors holding uint32 values;
    returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) as two python ints, as JAX builds it in its
    default 32-bit mode (the JAX package's): the low 32 bits of the seed."""
    return (0, seed & _M32)


def split(key):
    """jax.random.split(key) -> (key_a, key_b)."""
    o0, o1 = threefry2x32(key[0], key[1], torch.tensor([0, 0]),
                          torch.tensor([0, 1]))
    return ((int(o0[0]), int(o1[0])), (int(o0[1]), int(o1[1])))


def random_bits(key, counters):
    """jax.random.bits for the flat indices ``counters`` (int64 tensor)."""
    b1, b2 = threefry2x32(key[0], key[1], counters >> 32, counters & _M32)
    return b1 ^ b2


def uniform(key, counters, minval: float, maxval: float):
    """jax.random.uniform (float32) at the flat indices ``counters``."""
    return uniform_of_bits(random_bits(key, counters), minval, maxval)


def uniform_of_bits(bits, minval: float, maxval: float):
    """jax.random.uniform's float32 of the generator's bits (int64 tensor
    holding uint32 values)."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(lo.to(f.device), f * span.item() + lo.item())


def pk_table(cosmo, grid: Grid, npts: int = 4096):
    """Dense log-log P(k) table covering the grid's k-range (host, fp64,
    returned as float32 numpy arrays)."""
    kf = 2.0 * math.pi / grid.BoxSize
    logk = np.linspace(math.log10(kf) - 3.0,
                       math.log10(kf * grid.N * 2.0), npts)
    pk = cosmo.PowerSpectrum(10.0 ** logk)
    logpk = np.log10(np.maximum(pk, 1e-300))
    return logk.astype(np.float32), logpk.astype(np.float32)


def _interp(x, xp, fp):
    """jnp.interp for a sorted 1-D table: searchsorted right, clamped."""
    n = xp.numel()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def kdensity_shard_plain(N, logk, logpk, kp, ka, logkf, fac, fixed, paired,
                         y0, ny, z0, nz):
    """Plain version of K1s: see kdensity_shard."""
    dev = logk.device
    Nh = N // 2 + 1
    half = N // 2
    nzv = max(0, min(nz, Nh - z0))
    i64 = dict(dtype=torch.int64, device=dev)
    ix = torch.arange(N, **i64).reshape(N, 1, 1)
    iy = torch.arange(y0, y0 + ny, **i64).reshape(1, ny, 1)
    iz = torch.arange(z0, z0 + nzv, **i64).reshape(1, 1, nzv)
    mx = torch.where(ix <= half, ix, ix - N)
    my = torch.where(iy <= half, iy, iy - N)
    m2 = mx * mx + my * my + iz * iz
    alive = (~((mx.abs() == half) | (my.abs() == half) | (iz == half))
             & (m2 > 0) & (m2 <= half * half))
    # global counter of the draw: the mirrored mode's on the dependent part
    # of the kz=0 plane, which also conjugates
    dep = (iz == 0) & ((ix > half) | ((ix == 0) & (iy > half)))
    flat = (ix * N + iy) * Nh + iz
    mirror = (((N - ix) % N) * N + (N - iy) % N) * Nh
    draw = torch.where(dep, mirror, flat).reshape(-1)
    sign = torch.where(dep, -1.0, 1.0).to(torch.float32)

    shape = (N, ny, nzv)
    phase = uniform(kp, draw, 0.0, 2.0 * np.pi).reshape(shape)
    ampl = uniform(ka, draw, AMPL_MIN, 1.0).reshape(shape)
    got = _modes(m2, alive, sign, phase, ampl, logk, logpk, logkf, fac,
                 fixed, paired)
    if nzv == nz:
        return got
    out = torch.zeros((N, ny, nz), dtype=torch.complex64, device=dev)
    out[..., :nzv] = got
    return out


def kdensity_plain(N, logk, logpk, kp, ka, logkf, fac, fixed, paired):
    return kdensity_shard_plain(N, logk, logpk, kp, ka, logkf, fac, fixed,
                                paired, 0, N, 0, N // 2 + 1)


def _modes(m2, alive, sign, phase, ampl, logk, logpk, logkf, fac, fixed,
           paired):
    """delta of each mode from its integer |m|^2, its draws and the P(k)
    table (GenIC.c:188-446), shared by K1's and K9's plain versions."""
    logkm = logkf + 0.5 * torch.log10(
        torch.clamp(m2, min=1).to(torch.float32))
    pofk = torch.pow(10.0, _interp(logkm, logk, logpk))
    if not fixed:
        pofk = pofk * (-torch.log(ampl))
    if paired:
        phase = phase + float(np.float32(np.pi))
    amp = torch.where(alive, fac * torch.sqrt(pofk), 0.0)
    return torch.complex(amp * torch.cos(phase),
                         sign * amp * torch.sin(phase))


def _power_table(N: int, device):
    """Scratch for the kernels' P(k) table: float32 for every |m|^2 a live
    mode can have, 0..(N/2)^2, written by the launch."""
    return torch.empty((N // 2) ** 2 + 1, dtype=torch.float32,
                       device=device)


def kdensity(N: int, logk, logpk, kp, ka, logkf: float, fac: float,
             fixed: bool, paired: bool):
    """delta(k) complex64 [N, N, N//2+1] on the device of the P(k) tables
    (float32 tensors); kp, ka: the phase and amplitude keys."""
    if not kernels.plain_or_kernel("ic_kdensity", logk):
        return kdensity_plain(N, logk, logpk, kp, ka, logkf, fac, fixed,
                              paired)
    kernels.require_cuda("ic_kdensity", logk, logpk)
    if (logk.dtype != torch.float32 or logpk.shape != logk.shape
            or logk.dim() != 1):
        raise ValueError("ic_kdensity: float32 1-D tables of one length "
                         "expected")
    out = torch.empty((N, N, N // 2 + 1), dtype=torch.complex64,
                      device=logk.device)
    pk = _power_table(N, logk.device)
    err = kernels.lib().ic_kdensity(
        out.data_ptr(), pk.data_ptr(), logk.data_ptr(), logpk.data_ptr(),
        logk.numel(), kp[0], kp[1], ka[0], ka[1], float(logkf), float(fac),
        N, int(bool(fixed)), int(bool(paired)),
        kernels.stream_ptr(logk.device))
    kernels.check("ic_kdensity", err)
    kernels.LAUNCHES["ic_kdensity"] += 1
    return out


def kdensity_shard(N: int, logk, logpk, kp, ka, logkf: float, fac: float,
                   fixed: bool, paired: bool, y0: int, ny: int, z0: int,
                   nz: int):
    """delta(k) of one shard of a mesh's k layout [N, N, Nhp], complex64
    [N, ny, nz]: the modes of every kx, ky y0..y0+ny-1 and kz z0..z0+nz-1
    (exact zeros for kz > N/2, the layout's padding), on the device of the
    P(k) tables; the other arguments as kdensity."""
    if not kernels.plain_or_kernel("ic_kdensity_shard", logk):
        return kdensity_shard_plain(N, logk, logpk, kp, ka, logkf, fac, fixed,
                                    paired, y0, ny, z0, nz)
    kernels.require_cuda("ic_kdensity_shard", logk, logpk)
    if (logk.dtype != torch.float32 or logpk.shape != logk.shape
            or logk.dim() != 1 or not 0 <= y0 <= y0 + ny <= N or z0 < 0
            or nz < 0):
        raise ValueError("ic_kdensity_shard: float32 1-D tables of one "
                         "length and a window inside the k layout expected")
    out = torch.empty((N, ny, nz), dtype=torch.complex64, device=logk.device)
    pk = _power_table(N, logk.device)
    with kernels.on_device(logk.device):
        err = kernels.lib().ic_kdensity_shard(
            out.data_ptr(), pk.data_ptr(), logk.data_ptr(), logpk.data_ptr(),
            logk.numel(), kp[0], kp[1], ka[0], ka[1], float(logkf),
            float(fac), N, int(y0), int(ny), int(z0), int(nz),
            int(bool(fixed)), int(bool(paired)),
            kernels.stream_ptr(logk.device))
    kernels.check("ic_kdensity_shard", err)
    kernels.LAUNCHES["ic_kdensity_shard"] += 1
    return out


def kdensity_args(grid: Grid, cosmo, seed: int):
    """The host inputs of K1 and K1s: (logk, logpk) float32 numpy P(k)
    tables, the phase and amplitude keys, log10 of the fundamental mode and
    the amplitude factor, both rounded to float32."""
    logk, logpk = pk_table(cosmo, grid)
    kp, ka = split(prng_key(seed))
    kf = 2.0 * math.pi / grid.BoxSize
    logkf = float(np.float32(math.log10(kf)))
    fac = float(np.float32(grid.BoxSize ** -1.5 * float(grid.N) ** 3))
    return logk, logpk, kp, ka, logkf, fac


def generate_kdensity(grid: Grid, cosmo, seed: int, device,
                      fixed: bool = False, paired: bool = False):
    """delta(k) on the rfftn grid [N, N, N//2+1], complex64, on ``device``."""
    logk, logpk, kp, ka, logkf, fac = kdensity_args(grid, cosmo, seed)
    return kdensity(grid.N, torch.from_numpy(logk).to(device),
                    torch.from_numpy(logpk).to(device), kp, ka, logkf, fac,
                    fixed, paired)


# ------------------------------------------------------------------
# kz-plane generator of the out-of-core engine (K9): delta(k) is never
# resident there, each pass regenerates the kz planes it needs.  The draws
# of plane kz come from the seed's key folded with kz (jax.random.fold_in),
# then split into the phase and amplitude keys, so any batching of planes
# gives the same field, the JAX package's kdensity_plane_fn realization
# (a different one from generate_kdensity's: same statistics, same math).
# ------------------------------------------------------------------

def plane_keys(seed: int, nplanes: int) -> np.ndarray:
    """The (phase, amplitude) keys of planes kz = 0..nplanes-1 as uint32
    [nplanes, 4]: fold_in(PRNGKey(seed), kz), then split."""
    k0, k1 = prng_key(seed)
    kz = torch.arange(nplanes, dtype=torch.int64)
    zero = torch.zeros_like(kz)
    f0, f1 = threefry2x32(k0, k1, zero, kz)            # fold_in
    kp0, kp1 = threefry2x32(f0, f1, zero, zero)        # split: first key
    ka0, ka1 = threefry2x32(f0, f1, zero, zero + 1)    # second key
    return torch.stack([kp0, kp1, ka0, ka1], 1).numpy().astype(np.uint32)


def kdensity_planes_plain(N, logk, logpk, keys, kz0, B, logkf, fac, fixed,
                          paired):
    dev = logk.device
    half = N // 2
    i64 = dict(dtype=torch.int64, device=dev)
    kz = torch.arange(kz0, kz0 + B, **i64).reshape(B, 1, 1)
    ix = torch.arange(N, **i64).reshape(1, N, 1)
    iy = torch.arange(N, **i64).reshape(1, 1, N)
    mx = torch.where(ix <= half, ix, ix - N)
    my = torch.where(iy <= half, iy, iy - N)
    m2 = mx * mx + my * my + kz * kz
    alive = (~((mx.abs() == half) | (my.abs() == half) | (kz == half))
             & (m2 > 0) & (m2 <= half * half))
    # the dependent half of the kz=0 plane draws its mirrored mode's
    # counter and conjugates (GenIC.c:293-368)
    dep = (kz == 0) & ((ix > half) | ((ix == 0) & (iy > half)))
    draw = torch.where(dep, ((N - ix) % N) * N + (N - iy) % N, ix * N + iy)
    sign = torch.where(dep, -1.0, 1.0).to(torch.float32)
    k = keys[kz0:kz0 + B].to(torch.int64) & _M32
    kp = (k[:, 0].reshape(B, 1, 1), k[:, 1].reshape(B, 1, 1))
    ka = (k[:, 2].reshape(B, 1, 1), k[:, 3].reshape(B, 1, 1))
    phase = uniform(kp, draw, 0.0, 2.0 * np.pi)
    ampl = uniform(ka, draw, AMPL_MIN, 1.0)
    return _modes(m2, alive, sign, phase, ampl, logk, logpk, logkf, fac,
                  fixed, paired)


def _check_planes(N, logk, logpk, keys, kz0, B):
    kernels.require_cuda("ic_kdensity_planes", logk, logpk, keys)
    if (logk.dtype != torch.float32 or logpk.shape != logk.shape
            or logk.dim() != 1 or keys.dtype != torch.int32
            or keys.dim() != 2 or keys.shape[1] != 4
            or not 0 <= kz0 <= kz0 + B <= min(keys.shape[0], N // 2 + 1)):
        raise ValueError("ic_kdensity_planes: float32 1-D tables of one "
                         "length and int32 [nplanes, 4] keys covering the "
                         "batch expected")


def _planes(N, logk, logpk, keys, kz0, B, logkf, fac, fixed, paired, pk,
            build):
    """Launch K9 into a new [B, N, N] tensor with the P(k) table pk, which
    the launch writes first when ``build``."""
    out = torch.empty((B, N, N), dtype=torch.complex64, device=logk.device)
    err = kernels.lib().ic_kdensity_planes(
        out.data_ptr(), pk.data_ptr(), int(build), logk.data_ptr(),
        logpk.data_ptr(), logk.numel(), keys.data_ptr(), int(kz0), int(B),
        float(logkf), float(fac), N, int(bool(fixed)), int(bool(paired)),
        kernels.stream_ptr(logk.device))
    kernels.check("ic_kdensity_planes", err)
    kernels.LAUNCHES["ic_kdensity_planes"] += 1
    return out


def kdensity_planes(N: int, logk, logpk, keys, kz0: int, B: int,
                    logkf: float, fac: float, fixed: bool, paired: bool):
    """delta(k) of the kz planes kz0..kz0+B-1, complex64 [B, N, N] (x, y
    order within a plane), on the device of the P(k) tables; keys: the
    int32 [>= kz0+B, 4] plane keys (plane_keys' bits).  On the card each
    call builds the kernel's P(k) table (a PlaneGenerator keeps its own)."""
    if not kernels.plain_or_kernel("ic_kdensity_planes", logk):
        return kdensity_planes_plain(N, logk, logpk, keys, kz0, B, logkf,
                                     fac, fixed, paired)
    _check_planes(N, logk, logpk, keys, kz0, B)
    return _planes(N, logk, logpk, keys, kz0, B, logkf, fac, fixed, paired,
                   _power_table(N, logk.device), True)


class PlaneGenerator:
    """kz-plane batches of one realization on ``device`` (the counterpart
    of the JAX package's ic.kdensity_plane_fn): ``gen(kz0, B)`` is
    delta(k) [B, N, N] of planes kz0..kz0+B-1."""

    def __init__(self, grid: Grid, cosmo, seed: int, device,
                 fixed: bool = False, paired: bool = False):
        N = grid.N
        logk, logpk = pk_table(cosmo, grid)
        self.N = N
        self.logk = torch.from_numpy(logk).to(device)
        self.logpk = torch.from_numpy(logpk).to(device)
        self.keys = torch.from_numpy(
            plane_keys(seed, N // 2 + 1).view(np.int32)).to(device)
        self.logkf = float(np.float32(math.log10(2.0 * math.pi
                                                 / grid.BoxSize)))
        self.fac = float(np.float32(grid.BoxSize ** -1.5 * float(N) ** 3))
        self.fixed, self.paired = bool(fixed), bool(paired)
        self._pk = None          # the kernel's P(k) table, built once

    def __call__(self, kz0: int, B: int):
        if not kernels.plain_or_kernel("ic_kdensity_planes", self.logk):
            return kdensity_planes_plain(self.N, self.logk, self.logpk,
                                         self.keys, kz0, B, self.logkf,
                                         self.fac, self.fixed, self.paired)
        build = self._pk is None
        if build:
            _check_planes(self.N, self.logk, self.logpk, self.keys, 0, 0)
            self._pk = _power_table(self.N, self.logk.device)
        if not 0 <= kz0 <= kz0 + B <= self.N // 2 + 1:
            raise ValueError(f"ic_kdensity_planes: planes {kz0}..{kz0 + B} "
                             f"outside 0..{self.N // 2 + 1}")
        return _planes(self.N, self.logk, self.logpk, self.keys, kz0, B,
                       self.logkf, self.fac, self.fixed, self.paired,
                       self._pk, build)

    def assemble(self):
        """The whole field on the rfftn grid [N, N, N//2+1]: the dense
        engine's delta(k) of this realization."""
        return self(0, self.N // 2 + 1).permute(1, 2, 0).contiguous()


# ------------------------------------------------------------------
# the proof of the kernels' dead-mode zeros and sincosf (on the card)
# ------------------------------------------------------------------

PHASES = 2 ** 24


def phase_check(device):
    """Every phase the generator can draw (the 2^23 uniforms of [0, 2 pi),
    and the same shifted by float32(pi) as PairedIC draws them) through the
    kernel's phase, sincosf and dead-mode signs on the card, against the
    plain version's phase, sin and cos of it: returns (phases whose value
    differs, phases whose sin or cos differs in any bit, the parts of a
    dead mode's zero whose sign differs from the plain version's)."""
    f32 = dict(dtype=torch.float32, device=device)
    phase, sinv, cosv = (torch.empty(PHASES, **f32) for _ in range(3))
    rule = torch.empty(PHASES, dtype=torch.uint8, device=device)
    kernels.check("ic_phase_check", kernels.lib().ic_phase_check(
        phase.data_ptr(), sinv.data_ptr(), cosv.data_ptr(), rule.data_ptr(),
        kernels.stream_ptr(device)))
    bits = (torch.arange(PHASES // 2, dtype=torch.int64, device=device)
            << 9)
    want = uniform_of_bits(bits, 0.0, 2.0 * np.pi)
    want = torch.cat([want, want + float(np.float32(np.pi))])
    i32 = torch.int32
    phases = int((phase.view(i32) != want.view(i32)).sum())
    s, c = torch.sin(want), torch.cos(want)
    values = int(((sinv.view(i32) != s.view(i32))
                  | (cosv.view(i32) != c.view(i32))).sum())
    # a dead mode is (+0 * cos, +0 * sin): the signs of cos and sin
    zeros = int((((rule & 1) != 0) != torch.signbit(c)).sum()
                + (((rule & 2) != 0) != torch.signbit(s)).sum())
    return phases, values, zeros


def kernel_info():
    """Registers, spill (local) bytes, static shared bytes and resident
    256-thread blocks per SM of K1's modes kernel (also K1s'), K9's and the
    P(k) table's, as the card's runtime reports them: {name: (regs, local,
    shared, blocks)}."""
    out = {}
    for which, name in enumerate(("ic modes (K1, K1s)", "ic planes (K9)",
                                  "ic P(k) table")):
        info = (ctypes.c_int * 4)()
        kernels.check("ic_kernel_info",
                      kernels.lib().ic_kernel_info(which, info))
        out[name] = tuple(info)
    return out
