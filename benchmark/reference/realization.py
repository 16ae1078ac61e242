"""The plain reference of one realization of the device stage: from the
seed and the parameters, the initial conditions, the collapse cycle over the
smoothing radii, the LPT displacement sets and the products the hand-off
lands on the host (the needed cells in the sweep's order, F, each set's rows
of each field, the FmaxPDF counts).

Plain PyTorch, float32 as the configuration states, on whatever device its
tensors live on; computed in x-slab blocks where a whole-grid pass would not
fit beside its temporaries.  It imports nothing of the program: the
operations are the benchmark's frozen copy of the port's plain versions
(the JAX package's math op for op), the cosmology is this folder's copy.

``store``: the precision of every field kept between stages (the initial
conditions, each radius's Hessian stack, the LPT sources and their
spectra, each displacement field).  ``float32`` is the reference;
``bfloat16`` rounds each stored field to bfloat16 and back (the control:
the nearest precision below the configuration's, as a 16-bit ledger would
keep them); ``float64`` computes everything after the draws in float64 (how
far float32 itself lies from the mathematics, a scale for the limits).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
AMPL_MIN = 1.1754944e-38
NSIGMA = 6.0
STEP_VAR = 0.3
PDF_BINS = 210
GROWTH_INDEX = {"v1": 0, "v2": 1, "v31": 2, "v32": 3}
SECOND_DERIV_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
PHI2_WEIGHTS = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
SMALL = 1e-20
BIG = 1e10
INVGROW_DEG = 16
HALF_SQRT3 = 0.8660254037844386
THIRD = float(np.float32(1.0 / 3.0))
INV9 = float(np.float32(1.0 / 9.0))
INV14 = float(np.float32(1.0 / 14.0))
INV54 = float(np.float32(1.0 / 54.0))
INV84 = float(np.float32(1.0 / 84.0))
INV126 = float(np.float32(1.0 / 126.0))
SLAB = 32          # x-planes per block of the pointwise passes


# ------------------------------------------------------------------
# precision of the stored fields
# ------------------------------------------------------------------

def keep(x, store: str):
    """x as it is kept between stages in precision ``store``."""
    if store in ("float32", "float64"):
        return x
    if store != "bfloat16":
        raise ValueError(f"unknown storage precision {store!r}")
    if x.is_complex():
        r = torch.view_as_real(x)
        return torch.view_as_complex(
            r.to(torch.bfloat16).to(torch.float32).contiguous())
    return x.to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------
# the initial conditions: threefry2x32 as jax.random draws it
# ------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
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
    return (0, seed & _M32)


def split(key):
    o0, o1 = threefry2x32(key[0], key[1], torch.tensor([0, 0]),
                          torch.tensor([0, 1]))
    return ((int(o0[0]), int(o1[0])), (int(o0[1]), int(o1[1])))


def uniform(key, counters, minval: float, maxval: float):
    b1, b2 = threefry2x32(key[0], key[1], counters >> 32, counters & _M32)
    bits = b1 ^ b2
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(lo.to(f.device), f * span.item() + lo.item())


def pk_table(cosmo, N: int, box: float, npts: int = 4096):
    kf = 2.0 * math.pi / box
    logk = np.linspace(math.log10(kf) - 3.0, math.log10(kf * N * 2.0), npts)
    pk = cosmo.PowerSpectrum(10.0 ** logk)
    logpk = np.log10(np.maximum(pk, 1e-300))
    return logk.astype(np.float32), logpk.astype(np.float32)


def _interp(x, xp, fp):
    n = xp.numel()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _modes(m2, alive, sign, phase, ampl, logk, logpk, logkf, fac, fixed,
           paired):
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


def _ic_tables(cosmo, N, box, device):
    logk, logpk = pk_table(cosmo, N, box)
    logkf = float(np.float32(math.log10(2.0 * math.pi / box)))
    fac = float(np.float32(box ** -1.5 * float(N) ** 3))
    return (torch.from_numpy(logk).to(device),
            torch.from_numpy(logpk).to(device), logkf, fac)


def kdensity_dense(cosmo, N, box, seed, device, fixed=False, paired=False):
    """delta(k) [N, N, N//2+1] of the dense engine's realization: the
    phase and amplitude keys split from the seed's key, each mode drawn at
    its flat counter (the kz=0 plane's dependent half at its mirror's)."""
    logk, logpk, logkf, fac = _ic_tables(cosmo, N, box, device)
    kp, ka = split(prng_key(seed))
    Nh, half = N // 2 + 1, N // 2
    i64 = dict(dtype=torch.int64, device=device)
    out = torch.empty((N, N, Nh), dtype=torch.complex64, device=device)
    iy = torch.arange(N, **i64).reshape(1, N, 1)
    iz = torch.arange(Nh, **i64).reshape(1, 1, Nh)
    my = torch.where(iy <= half, iy, iy - N)
    for x0 in range(0, N, SLAB):
        ix = torch.arange(x0, min(N, x0 + SLAB), **i64).reshape(-1, 1, 1)
        mx = torch.where(ix <= half, ix, ix - N)
        m2 = mx * mx + my * my + iz * iz
        alive = (~((mx.abs() == half) | (my.abs() == half) | (iz == half))
                 & (m2 > 0) & (m2 <= half * half))
        dep = (iz == 0) & ((ix > half) | ((ix == 0) & (iy > half)))
        flat = (ix * N + iy) * Nh + iz
        mirror = (((N - ix) % N) * N + (N - iy) % N) * Nh
        draw = torch.where(dep, mirror, flat)
        sign = torch.where(dep, -1.0, 1.0).to(torch.float32)
        shape = draw.shape
        draw = draw.reshape(-1)
        phase = uniform(kp, draw, 0.0, 2.0 * np.pi).reshape(shape)
        ampl = uniform(ka, draw, AMPL_MIN, 1.0).reshape(shape)
        out[x0:x0 + SLAB] = _modes(m2, alive, sign, phase, ampl, logk,
                                   logpk, logkf, fac, fixed, paired)
    return out


def plane_keys(seed: int, nplanes: int):
    k0, k1 = prng_key(seed)
    kz = torch.arange(nplanes, dtype=torch.int64)
    zero = torch.zeros_like(kz)
    f0, f1 = threefry2x32(k0, k1, zero, kz)
    kp0, kp1 = threefry2x32(f0, f1, zero, zero)
    ka0, ka1 = threefry2x32(f0, f1, zero, zero + 1)
    return torch.stack([kp0, kp1, ka0, ka1], 1)


def kdensity_planes(cosmo, N, box, seed, device, fixed=False, paired=False):
    """delta(k) [N, N, N//2+1] of the out-of-core engine's realization:
    the seed's key folded with kz, split per plane, each mode drawn at its
    in-plane counter."""
    logk, logpk, logkf, fac = _ic_tables(cosmo, N, box, device)
    Nh, half = N // 2 + 1, N // 2
    keys = plane_keys(seed, Nh).to(device)
    i64 = dict(dtype=torch.int64, device=device)
    ix = torch.arange(N, **i64).reshape(1, N, 1)
    iy = torch.arange(N, **i64).reshape(1, 1, N)
    mx = torch.where(ix <= half, ix, ix - N)
    my = torch.where(iy <= half, iy, iy - N)
    out = torch.empty((N, N, Nh), dtype=torch.complex64, device=device)
    B = 8
    for kz0 in range(0, Nh, B):
        b = min(B, Nh - kz0)
        kz = torch.arange(kz0, kz0 + b, **i64).reshape(b, 1, 1)
        m2 = mx * mx + my * my + kz * kz
        alive = (~((mx.abs() == half) | (my.abs() == half) | (kz == half))
                 & (m2 > 0) & (m2 <= half * half))
        dep = (kz == 0) & ((ix > half) | ((ix == 0) & (iy > half)))
        draw = torch.where(dep, ((N - ix) % N) * N + (N - iy) % N,
                           ix * N + iy)
        sign = torch.where(dep, -1.0, 1.0).to(torch.float32)
        k = keys[kz0:kz0 + b]
        kp = (k[:, 0].reshape(b, 1, 1), k[:, 1].reshape(b, 1, 1))
        ka = (k[:, 2].reshape(b, 1, 1), k[:, 3].reshape(b, 1, 1))
        phase = uniform(kp, draw, 0.0, 2.0 * np.pi)
        ampl = uniform(ka, draw, AMPL_MIN, 1.0)
        got = _modes(m2, alive, sign, phase, ampl, logk, logpk, logkf, fac,
                     fixed, paired)
        out[:, :, kz0:kz0 + b] = got.permute(1, 2, 0)
    return out


# ------------------------------------------------------------------
# k space and the transforms
# ------------------------------------------------------------------

def k_grid(N: int, device, dtype=torch.float32):
    two_pi = 2.0 * np.pi / N
    m = np.arange(N)
    m = np.where(m <= N // 2, m, m - N)
    f32 = dict(dtype=dtype, device=device)
    kx = torch.tensor(two_pi * m, **f32).reshape(N, 1, 1)
    ky = torch.tensor(two_pi * m, **f32).reshape(1, N, 1)
    kz = torch.tensor(two_pi * np.arange(N // 2 + 1), **f32
                      ).reshape(1, 1, N // 2 + 1)
    k2 = kx * kx + ky * ky + kz * kz
    inv_k2 = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0),
                         0.0)
    return kx, ky, kz, k2, inv_k2


def irfft3(k, n: int):
    u = torch.fft.ifft2(k, dim=(-3, -2))
    u[..., 0].imag.zero_()
    if n % 2 == 0:
        u[..., n // 2].imag.zero_()
    return torch.fft.irfft(u, n=n, dim=-1)


def rfft3(x):
    return torch.fft.fft2(torch.fft.rfft(x, dim=-1),
                          dim=(-3, -2)).contiguous()


def hessian(kdensity, R_grid: float, kv, N: int):
    """The 6 smoothed second derivatives in real space, [6, N, N, N] (one
    batched transform of the six)."""
    R = torch.tensor(R_grid, dtype=torch.float32)
    base = kdensity * (torch.exp(-0.5 * kv[3] * R * R) * kv[4])
    return irfft3(torch.stack([base * (kv[a] * kv[b])
                               for a, b in SECOND_DERIV_PAIRS]), N)


def _scalar(x, device):
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def growth_lookup(k2, gtab, glo: float, gdx: float):
    logk = 0.5 * torch.log10(torch.clamp(k2, min=1e-12))
    t = torch.clamp((logk - _scalar(glo, k2.device))
                    / _scalar(gdx, k2.device), 0.0, gtab.shape[0] - 1.001)
    i = t.to(torch.int32)
    w = t - i.float()
    i = i.long()
    return gtab[i] * (1.0 - w) + gtab[i + 1] * w


def displacement(kvec, growth, kv, N: int):
    """The 3 first derivatives i k_a / k^2 * growth of a k-space source,
    [3, N, N, N]; growth a scalar or a (table, glo, gdx) triple."""
    if isinstance(growth, tuple):
        gtab, glo, gdx = growth
        base = kvec * (1j * growth_lookup(kv[3], gtab, glo, gdx)) * kv[4]
    else:
        g = float(torch.tensor(growth, dtype=torch.float32))
        base = kvec * complex(0.0, g) * kv[4]
    return irfft3(torch.stack([base * kv[a] for a in range(3)]), N)


# ------------------------------------------------------------------
# the ellipsoidal collapse (classic)
# ------------------------------------------------------------------

def _safe_div(a, b):
    ok = b.abs() > 0
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _cbrt(x):
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


def eigenvalues_descending(d):
    d0, d1, d2, d3, d4, d5 = (d[i] for i in range(6))
    mu1 = d0 + d1 + d2
    mu1_2 = mu1 * mu1
    mu2 = (0.5 * mu1_2 - 0.5 * (d0 * d0 + d1 * d1 + d2 * d2)
           - (d3 * d3 + d4 * d4 + d5 * d5))
    mu3 = (d0 * d1 * d2 + 2.0 * d3 * d4 * d5
           - d0 * d5 * d5 - d1 * d4 * d4 - d2 * d3 * d3)
    q = (mu1_2 - 3.0 * mu2) * INV9
    r = -(2.0 * mu1_2 * mu1 - 9.0 * mu1 * mu2 + 27.0 * mu3) * INV54
    diagonal = q == 0.0
    fail = (~diagonal) & ((q * q * q < r * r) | (q < 0.0))
    sq = 2.0 * _safe_sqrt(q)
    arg = torch.clamp(_safe_div(2.0 * r, q * sq), -1.0, 1.0)
    t = torch.acos(arg)
    c = torch.cos(t * THIRD)
    sn = _safe_sqrt(1.0 - c * c)
    third = mu1 * THIRD
    x1 = -sq * c + third
    x2 = -sq * (-0.5 * c - HALF_SQRT3 * sn) + third
    x3 = -sq * (-0.5 * c + HALF_SQRT3 * sn) + third
    x1 = torch.where(diagonal, d0, x1)
    x2 = torch.where(diagonal, d1, x2)
    x3 = torch.where(diagonal, d2, x3)
    hi = torch.maximum(torch.maximum(x1, x2), x3)
    lo = torch.minimum(torch.minimum(x1, x2), x3)
    mid = x1 + x2 + x3 - hi - lo
    return hi, mid, lo, fail


def ell_classic(l1, l2, l3):
    delta = l1 + l2 + l3
    det = l1 * l2 * l3
    den = det * INV126 + 5.0 * l1 * delta * (delta - l1) * INV84
    zeldovich = torch.where(l1 > 0.0, _safe_div(torch.ones_like(l1), l1),
                            -0.1)
    dis = 7.0 * l1 * (l1 + 6.0 * delta)
    ell2 = _safe_div(7.0 * l1 - _safe_sqrt(dis), 3.0 * l1 * (l1 - delta))
    ell2 = torch.where((dis < 0.0) | (ell2 < 0.0), -0.1, ell2)
    ell_den0 = torch.where((delta - l1).abs() < SMALL, zeldovich, ell2)
    rden = _safe_div(torch.ones_like(den), den)
    a1 = 3.0 * l1 * (delta - l1) * INV14 * rden
    a2 = l1 * rden
    a3 = -rden
    q = (a1 * a1 - 3.0 * a2) * INV9
    r = (2.0 * (a1 * a1 * a1) - 9.0 * a1 * a2 + 27.0 * a3) * INV54
    r2q3 = r * r - q * q * q
    sq1 = _cbrt(_safe_sqrt(r2q3) + r.abs())
    ell_a = -torch.sign(r) * (sq1 + _safe_div(q, sq1)) - a1 * THIRD
    ell_a = torch.where(ell_a < 0.0, -0.1, ell_a)
    sq2 = 2.0 * _safe_sqrt(q)
    t = torch.acos(torch.clamp(_safe_div(2.0 * r, q * sq2), -1.0, 1.0))
    c = torch.cos(t * THIRD)
    sn = _safe_sqrt(1.0 - c * c)
    a13 = a1 * THIRD
    s1 = -sq2 * c - a13
    s2 = -sq2 * (-0.5 * c - HALF_SQRT3 * sn) - a13
    s3 = -sq2 * (-0.5 * c + HALF_SQRT3 * sn) - a13
    s1 = torch.where(s1 < 0.0, BIG, s1)
    s2 = torch.where(s2 < 0.0, BIG, s2)
    s3 = torch.where(s3 < 0.0, BIG, s3)
    ell_b = torch.minimum(torch.minimum(s1, s2), s3)
    ell_b = torch.where(ell_b == BIG, -0.1, ell_b)
    ell3 = torch.where(r2q3 > 0.0, ell_a, ell_b)
    out = torch.where(den.abs() < SMALL, ell_den0, ell3)
    out = torch.where(l1.abs() < SMALL, -0.1, out)
    inv_del = _safe_div(torch.ones_like(delta), delta)
    corr = -0.364 * inv_del * torch.exp(
        -6.5 * (l1 - l2) * inv_del - 2.8 * (l2 - l3) * inv_del)
    return torch.where((delta > 0.0) & (out > 0.0), out + corr, out)


def fit_inverse_growth(logD_curve, loga_grid) -> np.ndarray:
    logD = np.asarray(logD_curve, np.float64)
    loga = np.asarray(loga_grid, np.float64)
    keep_ = np.concatenate([[True], np.diff(logD) > 0])
    logD, loga = logD[keep_], loga[keep_]
    lo, hi = logD[0], logD[-1]
    xs = np.linspace(lo, hi, 4096)
    ys = np.interp(xs, logD, loga)
    ts = (2.0 * xs - (lo + hi)) / (hi - lo)
    coeffs = np.polynomial.chebyshev.chebfit(ts, ys, INVGROW_DEG)
    poly = np.polynomial.chebyshev.cheb2poly(coeffs)[::-1]
    a_lo = (loga[1] - loga[0]) / (logD[1] - logD[0])
    b_lo = loga[0] - a_lo * lo
    a_hi = (loga[-1] - loga[-2]) / (logD[-1] - logD[-2])
    b_hi = loga[-1] - a_hi * hi
    out = np.concatenate([poly, [lo, hi, a_lo, b_lo, a_hi, b_hi]])
    return out.astype(np.float32)


def eval_inverse_growth(pack, x):
    p = [float(np.float32(v)) for v in pack]
    lo = p[INVGROW_DEG + 1]
    hi = p[INVGROW_DEG + 2]
    f32 = np.float32
    lo_plus_hi = float(f32(lo) + f32(hi))
    hi_minus_lo = float(f32(hi) - f32(lo))
    t = torch.clamp((2.0 * x - lo_plus_hi)
                    / torch.tensor(hi_minus_lo, dtype=x.dtype,
                                   device=x.device), -1.0, 1.0)
    t64 = t.double()
    acc = torch.full_like(t64, p[0])
    for k in range(1, INVGROW_DEG + 1):
        acc = (acc * t64 + p[k]).to(x.dtype).double()
    acc = acc.to(x.dtype)
    below = p[INVGROW_DEG + 3] * x + p[INVGROW_DEG + 4]
    above = p[INVGROW_DEG + 5] * x + p[INVGROW_DEG + 6]
    return torch.where(x < lo, below, torch.where(x > hi, above, acc))


def collapse_F(derivs, pack):
    l1, l2, l3, fail = eigenvalues_descending(derivs)
    bc = ell_classic(l1, l2, l3)
    loga_c = eval_inverse_growth(pack, torch.log10(torch.clamp(bc,
                                                               min=1e-30)))
    F = torch.where(bc > 0.0, torch.exp2(-3.321928094887362 * loga_c), 0.0)
    return torch.where(fail, -10.0, F)


# ------------------------------------------------------------------
# the radius ladder, the growth tables and the LPT sources
# ------------------------------------------------------------------

@dataclass
class Ladder:
    radii: np.ndarray       # true Mpc, the last 0
    packs: np.ndarray       # [n, 23] inverse-growth fits

    @property
    def n(self) -> int:
        return len(self.radii)


def largest_halo_mass(params, cosmo) -> float:
    """Largest halo expected in the box (set_subboxes,
    initialization.c:940-948), the scale of the scale-dependent growth's
    displacement radii."""
    m = 1.e18
    cc = 1.0 / params.BoxSize_htrue ** 3
    while cosmo.AnalyticMassFunction(m, params.zlast) * m < cc:
        m *= 0.99
        if m < 1e6:
            break
    return m


def smoothing_radii(params, cosmo) -> np.ndarray:
    D = float(cosmo.GrowingMode(params.zlast, params.k_for_GM))
    var_min = (1.686 / NSIGMA / D) ** 2
    rmin = params.InterPartDist / 6.0
    var_max = float(cosmo.var_gauss.MassVariance(rmin))
    n = int((math.log10(var_max) - math.log10(var_min)) / STEP_VAR + 2)
    n = max(n, 1)
    radii = np.zeros(n)
    for i in range(n - 1):
        radii[i] = cosmo.var_gauss.Radius(
            10.0 ** (math.log10(var_min) + STEP_VAR * i))
    return radii


def ladder(params, cosmo, scaledep_gm=None) -> Ladder:
    radii = smoothing_radii(params, cosmo)
    if scaledep_gm is not None:
        packs = np.stack([fit_inverse_growth(scaledep_gm.invgrow_logD[i],
                                             scaledep_gm.loga_grid)
                          for i in range(len(radii))])
    else:
        packs = np.tile(fit_inverse_growth(cosmo.sp_grow1.y,
                                           cosmo.sp_grow1.x)[None, :],
                        (len(radii), 1))
    return Ladder(radii=radii, packs=packs)


def growth_k_tables(cosmo, z0: float, N: int, device, ntab: int = 512):
    lo = math.log10(2.0 * math.pi / N) - 2.0
    hi = math.log10(math.pi * math.sqrt(3.0)) + 0.1
    logk = np.linspace(lo, hi, ntab)
    k = 10.0 ** logk
    tabs = np.stack([
        np.asarray(cosmo.GrowingMode(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_2LPT(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_3LPT_1(z0, k), np.float32),
        np.asarray(cosmo.GrowingMode_3LPT_2(z0, k), np.float32)])
    return (torch.from_numpy(tabs).to(device), float(np.float32(lo)),
            float(np.float32(logk[1] - logk[0])))


def lpt_sources(sd, kv, N: int, store: str):
    """k-space 2LPT and 3LPT sources (kvec2, kvec31, kvec32) from the R=0
    Hessian stack, the pointwise passes in x-slab blocks."""
    src2 = torch.empty((N, N, N), dtype=sd.dtype, device=sd.device)
    src31 = torch.empty_like(src2)
    src32 = torch.empty_like(src2)
    for x0 in range(0, N, SLAB):
        sxx, syy, szz, sxy, sxz, syz = (sd[i, x0:x0 + SLAB]
                                        for i in range(6))
        s2 = (sxx * syy + sxx * szz + syy * szz
              - sxy * sxy - sxz * sxz - syz * syz)
        src2[x0:x0 + SLAB] = s2
        src31[x0:x0 + SLAB] = 3.0 * (sxx * (syy * szz - syz * syz)
                                     - sxy * (sxy * szz - sxz * syz)
                                     + sxz * (sxy * syz - sxz * syy))
        src32[x0:x0 + SLAB] = 2.0 * (sxx + syy + szz) * s2
    src2, src31, src32 = (keep(s, store) for s in (src2, src31, src32))
    kvec2 = keep(rfft3(src2), store)
    del src2
    phi2 = keep(hessian(kvec2, 0.0, kv, N), store)
    for x0 in range(0, N, SLAB):
        acc = src32[x0:x0 + SLAB]
        for ider, w in enumerate(PHI2_WEIGHTS):
            acc = acc - 2.0 * w * phi2[ider, x0:x0 + SLAB] * sd[ider,
                                                                 x0:x0 + SLAB]
        src32[x0:x0 + SLAB] = acc
    del phi2
    src32 = keep(src32, store)
    return kvec2, keep(rfft3(src31), store), keep(rfft3(src32), store)


def pdf_hist(F):
    x = torch.nan_to_num(F.reshape(-1) * 10.0, nan=0.0)
    b = torch.clamp(x, 0.0, PDF_BINS - 1.0).to(torch.int64)
    return torch.bincount(b, minlength=PDF_BINS)


# ------------------------------------------------------------------
# one realization
# ------------------------------------------------------------------

class Realization:
    """The reference's realization of ``seed``: ``Fmax`` [N^3] on
    ``device`` after ``cycle()``, then ``rows(ci)`` gives each displacement
    set's rows of each field at the cells ci (int64), set by set."""

    def __init__(self, params, cosmo, ladder_: Ladder, seed: int, device,
                 engine: str, store: str = "float32"):
        self.p, self.cosmo, self.lad = params, cosmo, ladder_
        self.N = params.GridSize
        self.box = params.BoxSize_htrue
        self.device = torch.device(device)
        self.store = store
        self.dtype = torch.float64 if store == "float64" else torch.float32
        gen = kdensity_planes if engine == "ooc" else kdensity_dense
        self.kv = k_grid(self.N, self.device, self.dtype)
        kd = gen(cosmo, self.N, self.box, seed, self.device, params.FixedIC,
                 params.PairedIC)
        if self.dtype == torch.float64:
            kd = kd.to(torch.complex128)
        self.kdensity = keep(kd, store)
        self.Fmax = None
        self.sd = None

    def cycle(self):
        N = self.N
        Fmax = torch.full((N, N, N), -10.0, dtype=self.dtype,
                          device=self.device)
        radii = (self.lad.radii / (self.box / N)).astype(np.float32)
        for ism, R in enumerate(radii):
            self.sd = None
            sd = keep(hessian(self.kdensity, float(R), self.kv, N),
                      self.store)
            for x0 in range(0, N, SLAB):
                F = collapse_F(sd[:, x0:x0 + SLAB], self.lad.packs[ism])
                blk = Fmax[x0:x0 + SLAB]
                blk.copy_(torch.where(blk < F, F, blk))
            self.sd = sd
        self.Fmax = Fmax.reshape(-1)
        return self.Fmax

    def zs(self):
        p = self.p
        return (list(p.output_z) if p.recompute_displacements
                else [p.zlast])

    def keys(self):
        return sorted(GROWTH_INDEX)[:{1: 1, 2: 2, 3: 4}[self.p.lpt_order]]

    def rows(self, ci):
        """[set][key] -> [len(ci), 3] rows at the cells ci (the
        realization's precision); the R=0 Hessian stack is kept, so that
        another call may ask for other cells."""
        N, p, store = self.N, self.p, self.store
        sources = {}
        order = p.lpt_order
        if order >= 2:
            k2, k31, k32 = lpt_sources(self.sd, self.kv, N, store)
            sources["v2"] = k2
            if order >= 3:
                sources["v31"], sources["v32"] = k31, k32
        sources["v1"] = self.kdensity
        scaledep = bool(getattr(self.cosmo, "scale_dep", False))
        out = []
        for z in self.zs():
            if scaledep:
                gt, glo, gdx = growth_k_tables(self.cosmo, z, N, self.device)
            else:
                g = (self.cosmo.GrowingMode(z),
                     self.cosmo.GrowingMode_2LPT(z),
                     self.cosmo.GrowingMode_3LPT_1(z),
                     self.cosmo.GrowingMode_3LPT_2(z))
            rows = {}
            for key in self.keys():
                i = GROWTH_INDEX[key]
                growth = (gt[i], glo, gdx) if scaledep else float(g[i])
                v = keep(displacement(sources[key], growth, self.kv, N),
                         store).reshape(3, -1)
                rows[key] = v[:, ci].T.contiguous()
                del v
            out.append(rows)
        return out
