"""Ellipsoidal collapse-time update (counterpart of
pinocchio_tpu/ops/collapse.py).

The plain PyTorch functions below are the branch-free math of the JAX
package, op for op.  ``collapse_update`` (classic ellipsoid, K3),
``collapse_update_table`` (TABULATED_CT / ELL_SNG table lookups, K7),
``collapse_update_slab`` and ``collapse_update_slab_table`` (one x-slab of
the out-of-core cycle, classic K11 and tabulated K13) are the wrappers of
the CUDA kernel ``csrc/collapse.cu``: on a CUDA tensor they launch the
kernel, on a CPU tensor they run their ``*_plain`` versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import tabulated

SMALL = 1e-20
BIG = 1e10
INVGROW_DEG = 16
INVGROW_PACK = INVGROW_DEG + 1 + 6     # coeffs + lo,hi + 2 linear tails
HALF_SQRT3 = 0.8660254037844386
# divisions by constants are multiplications by their float32 reciprocals,
# written out: XLA rewrites them so in the JAX package, and PyTorch's CUDA
# division by a python scalar does the same, so every version rounds alike
THIRD = float(np.float32(1.0 / 3.0))
INV9 = float(np.float32(1.0 / 9.0))
INV14 = float(np.float32(1.0 / 14.0))
INV54 = float(np.float32(1.0 / 54.0))
INV84 = float(np.float32(1.0 / 84.0))
INV126 = float(np.float32(1.0 / 126.0))


def _safe_div(a, b):
    ok = b.abs() > 0
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def eigenvalues_descending(d):
    """Eigenvalues of the symmetric Hessian given its 6 components
    [6, ...] in ider order (xx, yy, zz, xy, xz, yz), sorted descending,
    and the fail flag (q^3 < r^2 or q < 0) that maps to F = -10."""
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
    """Growing mode b_c at collapse; -0.1 when the ellipsoid never
    collapses (ell_classic, collapse_times.c:114-221)."""
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


def _cbrt(x):
    """Cube root of a non-negative tensor (torch has no cbrt): a float64
    power rounded once to the input's dtype, within an ulp of cbrtf; the
    CUDA kernel gives the same floats (its cube_root: a float64 cbrt, and
    this power only near a float32 rounding midpoint)."""
    return torch.pow(x.double(), 1.0 / 3.0).to(x.dtype)


# ------------------------------------------------------------------
# inverse growing mode as a host-fitted polynomial (copied from the JAX
# package: the pack is a kernel argument, evaluated by Horner's rule)
# ------------------------------------------------------------------

def fit_inverse_growth(logD_curve, loga_grid) -> np.ndarray:
    """Packed fp32 parameters [coeffs(deg+1 desc), lo, hi, a_lo, b_lo,
    a_hi, b_hi] such that log10 a(x) = poly(x) on [lo, hi] and the linear
    tails continue the curve outside."""
    logD = np.asarray(logD_curve, np.float64)
    loga = np.asarray(loga_grid, np.float64)
    keep = np.concatenate([[True], np.diff(logD) > 0])
    logD, loga = logD[keep], loga[keep]
    lo, hi = logD[0], logD[-1]
    xs = np.linspace(lo, hi, 4096)
    ys = np.interp(xs, logD, loga)
    ts = (2.0 * xs - (lo + hi)) / (hi - lo)
    coeffs = np.polynomial.chebyshev.chebfit(ts, ys, INVGROW_DEG)
    poly = np.polynomial.chebyshev.cheb2poly(coeffs)[::-1]  # descending
    a_lo = (loga[1] - loga[0]) / (logD[1] - logD[0])
    b_lo = loga[0] - a_lo * lo
    a_hi = (loga[-1] - loga[-2]) / (logD[-1] - logD[-2])
    b_hi = loga[-1] - a_hi * hi
    out = np.concatenate([poly, [lo, hi, a_lo, b_lo, a_hi, b_hi]])
    return out.astype(np.float32)


def make_inverse_growth_fit(cosmo) -> np.ndarray:
    return fit_inverse_growth(cosmo.sp_grow1.y, cosmo.sp_grow1.x)


def eval_inverse_growth(pack, x):
    """log10 a at log10 D = x from a packed fit (a float32 numpy array or
    a sequence of python floats)."""
    p = [float(np.float32(v)) for v in pack]
    lo = p[INVGROW_DEG + 1]
    hi = p[INVGROW_DEG + 2]
    f32 = np.float32
    lo_plus_hi = float(f32(lo) + f32(hi))      # float32 sums, as on device
    hi_minus_lo = float(f32(hi) - f32(lo))
    # a true division (a 0-d tensor divisor, as the JAX pack element is)
    t = torch.clamp((2.0 * x - lo_plus_hi)
                    / torch.tensor(hi_minus_lo, dtype=x.dtype,
                                   device=x.device), -1.0, 1.0)
    # each Horner step is one fused multiply-add, as the compiled JAX
    # function and the CUDA kernel (fmaf) evaluate it: the degree-16
    # monomial form cancels heavily in float32, so unfused steps can move
    # F by percent.  A float64 multiply-add rounded once to the working
    # dtype is the fma (a float64 input keeps float64 throughout).
    t64 = t.double()
    acc = torch.full_like(t64, p[0])
    for k in range(1, INVGROW_DEG + 1):
        acc = (acc * t64 + p[k]).to(x.dtype).double()
    acc = acc.to(x.dtype)
    below = p[INVGROW_DEG + 3] * x + p[INVGROW_DEG + 4]
    above = p[INVGROW_DEG + 5] * x + p[INVGROW_DEG + 6]
    return torch.where(x < lo, below, torch.where(x > hi, above, acc))


def collapse_F(derivs, pack):
    """Collapse time F = 1 + z_c per cell from the Hessian stack, -10 on
    the eigenvalue fail branch, 0 where the ellipsoid never collapses."""
    l1, l2, l3, fail = eigenvalues_descending(derivs)
    bc = ell_classic(l1, l2, l3)
    loga_c = eval_inverse_growth(pack, torch.log10(torch.clamp(bc,
                                                               min=1e-30)))
    F = torch.where(bc > 0.0, torch.exp2(-3.321928094887362 * loga_c), 0.0)
    return torch.where(fail, -10.0, F)


def _running_max(F, derivs, Fmax, Rmax, ismooth: int):
    """Strict running max of F into Fmax/Rmax IN PLACE (a tie keeps the
    earlier radius; Rmax None keeps no radius); returns the float64 tensor
    [mean delta, mean delta^2] (sums taken in float64)."""
    delta = derivs[0] + derivs[1] + derivs[2]
    upd = Fmax < F
    Fmax.copy_(torch.where(upd, F, Fmax))
    if Rmax is not None:
        Rmax.copy_(torch.where(upd, ismooth, Rmax))
    dd = delta * delta
    n = delta.numel()
    return torch.stack([delta.double().sum() / n, dd.double().sum() / n])


def collapse_update_plain(derivs, Fmax, Rmax, ismooth: int, pack):
    """Plain version of the K3 kernel: updates Fmax and Rmax IN PLACE and
    returns [mean delta, mean delta^2]."""
    return _running_max(collapse_F(derivs, pack), derivs, Fmax, Rmax,
                        ismooth)


def collapse_update_table_plain(derivs, Fmax, Rmax, ismooth: int, tab,
                                tab2, dv, idx_map, ampl: float,
                                interp: str):
    """Plain version of the K7 kernel (collapse_update_table, JAX
    ops/collapse.py:254-271): F looked up in the radius's table in the
    variant ``interp``, -10 where the eigenvalues fail, then the running
    max and the statistics as in collapse_update_plain."""
    l1, l2, l3, fail = eigenvalues_descending(derivs)
    # a 0-dim tensor on the device: a true division on every backend
    amp = torch.tensor(float(ampl), dtype=torch.float32, device=derivs.device)
    F = tabulated.interp_F(interp, tab, tab2, dv, idx_map, amp, l1, l2, l3)
    F = torch.where(fail, -10.0, F)
    return _running_max(F, derivs, Fmax, Rmax, ismooth)


# the kernel's grid is the blocks that stay resident on the card (its
# occupancy query), at most MAX_BLOCKS_PER_SM on each SM; the kernel picks
# its loads from what it sees (csrc/collapse.cu: the classic update streams
# aligned planes of a large enough grid through a shared-memory ring)
MAX_BLOCKS_PER_SM = 32
_SCRATCH = {}


def _scratch(device, stream):
    """(partials, ticket, blocks) of the kernel's reduction on ``device``
    and its stream ``stream``, allocated once: float64 [2 * blocks] for at
    most blocks = MAX_BLOCKS_PER_SM * SMs blocks, and one zeroed uint32
    counter that the kernel's last block resets."""
    key = (device, stream)
    if key not in _SCRATCH:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = MAX_BLOCKS_PER_SM * sms
        _SCRATCH[key] = (torch.empty(2 * blocks, dtype=torch.float64,
                                     device=device),
                         torch.zeros(1, dtype=torch.int32, device=device),
                         blocks)
    return _SCRATCH[key]


def _launch(name, fn, device, *args):
    """Launch one collapse entry point of the kernel library: its
    arguments, then the reduction's scratch, a fresh means tensor and the
    stream; returns the means [mean delta, mean delta^2] float64."""
    stream = kernels.stream_ptr(device)
    partials, ticket, blocks = _scratch(device, stream)
    means = torch.empty(2, dtype=torch.float64, device=device)
    err = fn(*args, partials.data_ptr(), blocks, ticket.data_ptr(),
             means.data_ptr(), stream)
    kernels.check(name, err)
    kernels.LAUNCHES[name] += 1
    return means


def kernel_info(interp: str = None, ring: bool = True):
    """Registers, spill (local) bytes, shared bytes and resident 256-thread
    blocks per SM of the collapse kernel for the classic update (interp
    None; through the bulk-copy ring or with direct loads) or a table
    lookup, as the card's runtime reports them: (regs, local, shared,
    blocks)."""
    mode = 0 if interp is None else 1 + tabulated.INTERP.index(interp)
    out = (ctypes.c_int * 4)()
    kernels.check("collapse_kernel_info", kernels.lib().collapse_kernel_info(
        mode, int(ring), out))
    return tuple(out)


def cbrt_check(device):
    """The cube root's proof on the card: every positive finite float32,
    and 0 and +inf, through the kernel's cube_root and the float64 pow it
    stands for; returns (floats whose results differ, floats near a float32
    rounding midpoint, where cube_root takes the pow)."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    kernels.check("cbrt_check", kernels.lib().cbrt_check(
        counts.data_ptr(), kernels.stream_ptr(device)))
    bad, near = counts.tolist()
    return bad, near


def collapse_update(derivs, Fmax, Rmax, ismooth: int, pack):
    """One smoothing radius of compute_collapse_times: F from the Hessian
    stack derivs [6, N, N, N], running max into Fmax (float32) and Rmax
    (int32) IN PLACE, and the [mean delta, mean delta^2] float64 tensor.

    pack: the 23-float inverse-growth fit of this radius (numpy)."""
    if not kernels.plain_or_kernel("collapse_update", derivs):
        return collapse_update_plain(derivs, Fmax, Rmax, ismooth, pack)
    kernels.require_cuda("collapse_update", derivs, Fmax, Rmax)
    n = Fmax.numel()
    if (derivs.dtype != torch.float32 or Fmax.dtype != torch.float32
            or Rmax.dtype != torch.int32 or derivs.shape[0] != 6
            or derivs.numel() != 6 * n or Rmax.numel() != n):
        raise ValueError("collapse_update: derivs f32[6, *S], Fmax f32[*S], "
                         "Rmax i32[*S] expected")
    pk = np.ascontiguousarray(pack, np.float32)
    if pk.shape != (INVGROW_PACK,):
        raise ValueError(f"collapse_update: pack must be f32[{INVGROW_PACK}]")
    return _launch("collapse_update", kernels.lib().collapse_update,
                   derivs.device, derivs.data_ptr(), Fmax.data_ptr(),
                   Rmax.data_ptr(), ctypes.c_int64(n), int(ismooth),
                   pk.ctypes.data)


def collapse_update_slab_plain(derivs, Fmax, pack):
    """Plain version of the K11 kernel: see collapse_update_slab."""
    return collapse_update_plain(derivs, Fmax, None, 0, pack)


def collapse_update_slab(derivs, Fmax, pack):
    """One x-slab of one radius of the out-of-core cycle: F from the slab's
    Hessian components derivs [6, *S] (classic ellipsoid), running max into
    the slab's Fmax rows [*S] IN PLACE (no Rmax); returns the slab's
    [mean delta, mean delta^2] float64 tensor."""
    if not kernels.plain_or_kernel("collapse_update_slab", derivs):
        return collapse_update_slab_plain(derivs, Fmax, pack)
    kernels.require_cuda("collapse_update_slab", derivs, Fmax)
    n = Fmax.numel()
    if (derivs.dtype != torch.float32 or Fmax.dtype != torch.float32
            or derivs.shape[0] != 6 or derivs.numel() != 6 * n):
        raise ValueError("collapse_update_slab: derivs f32[6, *S] and Fmax "
                         "f32[*S] expected")
    pk = np.ascontiguousarray(pack, np.float32)
    if pk.shape != (INVGROW_PACK,):
        raise ValueError(f"collapse_update_slab: pack must be "
                         f"f32[{INVGROW_PACK}]")
    return _launch("collapse_update_slab", kernels.lib().collapse_update_slab,
                   derivs.device, derivs.data_ptr(), Fmax.data_ptr(),
                   ctypes.c_int64(n), pk.ctypes.data)


TABLE_SHAPE = (tabulated.CT_NBINS_XY, tabulated.CT_NBINS_XY,
               tabulated.CT_NBINS_D)


def _table_pair(interp: str, tab, tab2):
    """tab2 for a lookup in the variant ``interp``: the spline variants
    need it; the trilinear one reads none and may be given None."""
    if interp not in tabulated.INTERP:
        raise ValueError(f"unknown interpolation variant {interp!r}")
    if tab2 is None:
        if interp != "trilinear":
            raise ValueError(f"interp={interp!r} needs the spline "
                             "second-derivative table tab2")
        return tab                     # not read by the trilinear lookup
    return tab2


def _check_table(name, tab, tab2, dv, idx_map):
    if (tuple(tab.shape) != TABLE_SHAPE or tuple(tab2.shape) != TABLE_SHAPE
            or tab.dtype != torch.float32 or tab2.dtype != torch.float32
            or tuple(dv.shape) != (tabulated.CT_NBINS_D,)
            or dv.dtype != torch.float32
            or tuple(idx_map.shape) != (tabulated.AUX_N,)
            or idx_map.dtype != torch.int32):
        raise ValueError(f"{name}: tab/tab2 f32{list(TABLE_SHAPE)}, dv "
                         f"f32[{tabulated.CT_NBINS_D}], idx_map "
                         f"i32[{tabulated.AUX_N}] expected")


def collapse_update_table(derivs, Fmax, Rmax, ismooth: int, tab, tab2, dv,
                          idx_map, ampl: float, interp: str):
    """One smoothing radius of the TABULATED_CT / ELL_SNG collapse update:
    F from the radius's table tab [NXY, NXY, ND] float32 (tab2 its
    delta-spline second derivatives, needed by the spline variants; dv the
    float32 delta grid, idx_map the int32 aux map, ampl the radius's sqrt
    variance) in the variant ``interp``; running max into Fmax/Rmax IN
    PLACE; returns the [mean delta, mean delta^2] float64 tensor."""
    tab2 = _table_pair(interp, tab, tab2)
    name = f"collapse_update_table_{interp}"
    if not kernels.plain_or_kernel(name, derivs):
        return collapse_update_table_plain(derivs, Fmax, Rmax, ismooth, tab,
                                           tab2, dv, idx_map, ampl, interp)
    kernels.require_cuda(name, derivs, Fmax, Rmax, tab, tab2, dv, idx_map)
    n = Fmax.numel()
    if (derivs.dtype != torch.float32 or Fmax.dtype != torch.float32
            or Rmax.dtype != torch.int32 or derivs.shape[0] != 6
            or derivs.numel() != 6 * n or Rmax.numel() != n):
        raise ValueError(f"{name}: derivs f32[6, *S], Fmax f32[*S], "
                         "Rmax i32[*S] expected")
    _check_table(name, tab, tab2, dv, idx_map)
    return _launch(name, kernels.lib().collapse_update_table, derivs.device,
                   derivs.data_ptr(), Fmax.data_ptr(), Rmax.data_ptr(),
                   ctypes.c_int64(n), int(ismooth), tab.data_ptr(),
                   tab2.data_ptr(), dv.data_ptr(), idx_map.data_ptr(),
                   float(np.float32(ampl)), tabulated.INTERP.index(interp))


def collapse_update_slab_table_plain(derivs, Fmax, tab, tab2, dv, idx_map,
                                     ampl: float, interp: str):
    """Plain version of the K13 kernel: see collapse_update_slab_table."""
    return collapse_update_table_plain(derivs, Fmax, None, 0, tab, tab2, dv,
                                       idx_map, ampl, interp)


def collapse_update_slab_table(derivs, Fmax, tab, tab2, dv, idx_map,
                               ampl: float, interp: str):
    """One x-slab of one radius of the out-of-core cycle with the
    TABULATED_CT / ELL_SNG collapse tables: F from the slab's Hessian
    components derivs [6, *S] looked up in the radius's table (arguments as
    collapse_update_table), running max into the slab's Fmax rows [*S] IN
    PLACE (no Rmax); returns the slab's [mean delta, mean delta^2] float64
    tensor."""
    tab2 = _table_pair(interp, tab, tab2)
    name = f"collapse_update_slab_table_{interp}"
    if not kernels.plain_or_kernel(name, derivs):
        return collapse_update_slab_table_plain(derivs, Fmax, tab, tab2, dv,
                                                idx_map, ampl, interp)
    kernels.require_cuda(name, derivs, Fmax, tab, tab2, dv, idx_map)
    n = Fmax.numel()
    if (derivs.dtype != torch.float32 or Fmax.dtype != torch.float32
            or derivs.shape[0] != 6 or derivs.numel() != 6 * n):
        raise ValueError(f"{name}: derivs f32[6, *S] and Fmax f32[*S] "
                         "expected")
    _check_table(name, tab, tab2, dv, idx_map)
    return _launch(name, kernels.lib().collapse_update_slab_table,
                   derivs.device, derivs.data_ptr(), Fmax.data_ptr(),
                   ctypes.c_int64(n), tab.data_ptr(), tab2.data_ptr(),
                   dv.data_ptr(), idx_map.data_ptr(),
                   float(np.float32(ampl)), tabulated.INTERP.index(interp))
