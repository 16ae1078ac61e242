"""TABULATED_CT / ELL_SNG collapse tables (counterpart of
pinocchio_tpu/ops/tabulated.py).

Per smoothing radius, F(delta, x, y) is tabulated on a (ND x NXY x NXY) grid
of normalized eigenvalue combinations delta = (l1+l2+l3)/sigma,
x = (l1-l2)/sigma, y = (l2-l3)/sigma, with a non-uniform delta sampling
concentrated around CT_DELTA0 (collapse_times.c:780-1232).  The tables are
built on the host: the classic entries through the port's plain
``ell_classic`` on CPU float32 tensors, the SNG entries through the shared
numpy solver of ``ops/sng.py`` (the port's copy).

The lookups below are the plain PyTorch versions of the three variants
(trilinear, bilinear-spline, bicubic) that the K7 kernel computes
(``csrc/collapse.cu``, wrapper ``ops.collapse.collapse_update_table``).
Divisions by constants are multiplications by float32 reciprocals, which is
what XLA compiles the JAX package's divisions to; the aux-grid coordinate
folds its two constants into one, as XLA does.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

CT_NBINS_XY = 50
CT_NBINS_D = 100
CT_SQUEEZE = 1.2
CT_EXPO = 1.75
CT_RANGE_D = 7.0
CT_RANGE_X = 3.5
CT_DELTA0 = -1.0
BIN_X = CT_RANGE_X / CT_NBINS_XY
AUX_N = 8192                 # uniform aux grid for the delta bin lookup

_f32 = np.float32
INV_BIN_X = float(_f32(1.0 / BIN_X))
# (d + CT_RANGE_D) / (2 CT_RANGE_D) * (AUX_N - 1), folded into one factor
U_SCALE = float(_f32(_f32(1.0 / (2.0 * CT_RANGE_D)) * _f32(AUX_N - 1)))
SIXTH = float(_f32(1.0 / 6.0))
NAT4 = float(_f32(6.0 / 15.0))


def delta_sampling() -> np.ndarray:
    """Non-uniform delta grid (initialize_collapse_times,
    collapse_times.c:845-882)."""
    deltaf = (CT_SQUEEZE / CT_EXPO) ** (1.0 / (CT_EXPO - 1.0))
    ref = (((CT_RANGE_D - CT_DELTA0) ** (2.0 - CT_EXPO)
            + (CT_RANGE_D + CT_DELTA0) ** (2.0 - CT_EXPO)
            - 2.0 * deltaf ** (2.0 - CT_EXPO))
           / CT_EXPO / (2.0 - CT_EXPO)
           + 2.0 * deltaf / CT_SQUEEZE) / (CT_NBINS_D - 2.0)
    dv = np.empty(CT_NBINS_D)
    d = -CT_RANGE_D
    for i in range(CT_NBINS_D):
        dv[i] = d
        interval = CT_EXPO * ref * abs(d - CT_DELTA0) ** (CT_EXPO - 1.0)
        if interval / ref < CT_SQUEEZE:
            interval = ref * CT_SQUEEZE
        d += interval
    return dv


def node_eigenvalues(ampl: float):
    """(l1, l2, l3) float64 at every table node, flattened in the
    reference's index order i = id + ix*ND + iy*ND*NXY
    (collapse_times.c:975-985)."""
    dv = delta_sampling()
    idx = np.arange(CT_NBINS_D * CT_NBINS_XY * CT_NBINS_XY)
    id_ = idx % CT_NBINS_D
    ix = (idx // CT_NBINS_D) % CT_NBINS_XY
    iy = idx // (CT_NBINS_D * CT_NBINS_XY)
    x = ix * BIN_X
    y = iy * BIN_X
    d = dv[id_]
    l1 = (d + 2.0 * x + y) / 3.0 * ampl
    l2 = (d - x + y) / 3.0 * ampl
    l3 = (d - x - 2.0 * y) / 3.0 * ampl
    return l1, l2, l3


def ct_entries(cosmo, l1, l2, l3, model: str = "classic",
               sng_D_in: float = None) -> np.ndarray:
    """F = 1 + z_c (0 where the ellipsoid never collapses) for eigenvalue
    triples (float64 numpy): 'classic' through the closed-form ellipsoid in
    float32, 'sng' through the triaxial ODE."""
    if model == "sng":
        from .sng import ell_sng_F
        if sng_D_in is None:
            sng_D_in = float(cosmo.GrowingMode(1.0 / 1.e-5 - 1.0))
        return ell_sng_F(l1, l2, l3, sng_D_in, cosmo)
    from .collapse import ell_classic
    ls = [torch.from_numpy(np.asarray(v, np.float64).astype(np.float32))
          for v in (l1, l2, l3)]
    bc = ell_classic(*ls).numpy()
    return np.where(bc > 0.0,
                    1.0 + cosmo.InverseGrowingMode(np.maximum(bc, 1e-30)),
                    0.0)


def build_ct_table(cosmo, ampl: float, model: str = "classic") -> np.ndarray:
    """F(delta, x, y) table of one smoothing radius, flat in reference
    order."""
    l1, l2, l3 = node_eigenvalues(ampl)
    return ct_entries(cosmo, l1, l2, l3, model=model)


def aux_index_map(dv) -> np.ndarray:
    """Uniform aux grid over delta -> non-uniform delta bin (the
    arithmetic stand-in for the reference's bsearch)."""
    aux = np.linspace(-CT_RANGE_D, CT_RANGE_D, AUX_N)
    return np.clip(np.searchsorted(dv, aux, side="right") - 1, 0,
                   CT_NBINS_D - 2).astype(np.int32)


def build_ct_tables_all(cosmo, smoothing, model: str = "classic") -> dict:
    """One table per smoothing radius plus the lookup inputs, as numpy:
    tables [nsmooth, NXY, NXY, ND] float32 (indexed [iy, ix, id]), tables2
    (their delta-spline second derivatives), dv, idx_map and ampl (sqrt
    variance per radius)."""
    dv = delta_sampling()
    tables = np.stack([
        build_ct_table(cosmo, math.sqrt(smoothing.variance[ism]),
                       model=model)
        .reshape(CT_NBINS_XY, CT_NBINS_XY, CT_NBINS_D).astype(np.float32)
        for ism in range(smoothing.n)])
    return dict(tables=tables, tables2=spline_d2(tables, dv),
                dv=dv.astype(np.float32), idx_map=aux_index_map(dv),
                ampl=np.sqrt(smoothing.variance).astype(np.float32))


def spline_d2(tables, dv):
    """Natural-cubic-spline second derivatives along the delta axis of
    every control curve (the reference's CT_Spline set,
    collapse_times.c:1018-1042), tables [..., ND] -> same shape float32."""
    from scipy.interpolate import CubicSpline
    cs = CubicSpline(np.asarray(dv, np.float64),
                     np.asarray(tables, np.float64), axis=-1,
                     bc_type="natural")
    return cs(np.asarray(dv, np.float64), 2).astype(np.float32)


def write_ct_table_file(path, params, smoothing, tables):
    """Binary CT table cache (write_CTtable_header + per-radius records,
    collapse_times.c:995-1034): header, then per radius its index and the
    float64 table in [iy, ix, id] order."""
    with open(path, "wb") as fd:
        fd.write(struct.pack("<6i2d", CT_NBINS_D, CT_NBINS_XY,
                             smoothing.n, params.GridSize,
                             params.RandomSeed, 0, CT_EXPO, CT_SQUEEZE))
        for ism in range(smoothing.n):
            fd.write(struct.pack("<i", ism))
            np.asarray(tables[ism]).astype("<f8").ravel().tofile(fd)


def read_ct_table_file(path, params, smoothing) -> np.ndarray:
    """Tables [nsmooth, NXY, NXY, ND] float32 from a CT table file; a header
    that does not fit this run raises ValueError."""
    with open(path, "rb") as fd:
        hdr = struct.unpack("<6i2d", fd.read(6 * 4 + 2 * 8))
        if hdr[0] != CT_NBINS_D or hdr[1] != CT_NBINS_XY \
                or hdr[2] != smoothing.n or hdr[3] != params.GridSize:
            raise ValueError(f"CT table header mismatch: {hdr}")
        tabs = []
        for _ in range(smoothing.n):
            struct.unpack("<i", fd.read(4))
            flat = np.fromfile(fd, "<f8",
                               CT_NBINS_D * CT_NBINS_XY * CT_NBINS_XY)
            tabs.append(flat.reshape(CT_NBINS_XY, CT_NBINS_XY,
                                     CT_NBINS_D).astype(np.float32))
    return np.stack(tabs)


# ------------------------------------------------------------------
# plain PyTorch lookups (the K7 kernel computes the same, op for op)
# ------------------------------------------------------------------

def _index(f, hi: int):
    """int64 index of f clipped to [0, hi], truncating toward zero; NaN
    gives 0.  For every float this is the JAX package's clip of XLA's
    saturating float-to-int32 conversion."""
    return torch.nan_to_num(f, nan=0.0).clamp(0.0, float(hi)).long()


def _locate(dv, idx_map, ampl, l1, l2, l3):
    """Shared bin location: normalized (d, x, y), their cell indices and
    in-cell offsets (interpolate_collapse_time prologue,
    collapse_times.c:1139-1160).  ampl: a 0-dim tensor on the device of
    the eigenvalues (a true division, as for the JAX package's traced
    per-radius scalar)."""
    d = (l1 + l2 + l3) / ampl
    x = (l1 - l2) / ampl
    y = (l2 - l3) / ampl
    fx = x * INV_BIN_X
    fy = y * INV_BIN_X
    ix = _index(fx, CT_NBINS_XY - 2)
    iy = _index(fy, CT_NBINS_XY - 2)
    u = (d + CT_RANGE_D) * U_SCALE
    id_ = idx_map[_index(u, AUX_N - 1)].long()
    return d, fx, fy, ix, iy, id_


def interpolate_F(tab, dv, idx_map, ampl, l1, l2, l3):
    """Trilinear variant (collapse_times.c:1139-1221); tab [NXY, NXY, ND]
    of one radius, indexed [iy, ix, id]."""
    d, fx, fy, ix, iy, id_ = _locate(dv, idx_map, ampl, l1, l2, l3)
    d0 = dv[id_]
    d1 = dv[id_ + 1]
    r = (d - d0) / (d1 - d0)
    dd = torch.clamp(r, 0.0, 1.0)
    # out-of-range d keeps the edge bin with an extrapolated offset
    dd = torch.where(d <= dv[0], r, dd)
    dd = torch.where(d >= dv[-1], r, dd)
    dx = fx - ix.float()
    dy = fy - iy.float()

    def g(jy, jx, jd):
        return tab[iy + jy, ix + jx, id_ + jd]

    return ((1 - dd) * (1 - dx) * (1 - dy) * g(0, 0, 0)
            + dd * (1 - dx) * (1 - dy) * g(0, 0, 1)
            + (1 - dd) * dx * (1 - dy) * g(0, 1, 0)
            + dd * dx * (1 - dy) * g(0, 1, 1)
            + (1 - dd) * (1 - dx) * dy * g(1, 0, 0)
            + dd * (1 - dx) * dy * g(1, 0, 1)
            + (1 - dd) * dx * dy * g(1, 1, 0)
            + dd * dx * dy * g(1, 1, 1))


def _spline_seg(y0, y1, m0, m1, d, d0, d1):
    """One natural-cubic segment with values y and second derivatives m at
    its ends (d0, d1), evaluated at d (my_spline_eval, cosmo.c:2016-2027)."""
    h = d1 - d0
    A = (d1 - d) / h
    B = 1.0 - A
    return (A * y0 + B * y1
            + ((A * A * A - A) * m0 + (B * B * B - B) * m1) * (h * h)
            * SIXTH)


def _nat4(y0, y1, y2, y3, t):
    """Natural cubic spline through 4 points at 0, 1, 2, 3, evaluated at t:
    the closed-form interior second derivatives, then the segment of t."""
    c1 = y0 - 2.0 * y1 + y2
    c2 = y1 - 2.0 * y2 + y3
    m1 = NAT4 * (4.0 * c1 - c2)
    m2 = NAT4 * (4.0 * c2 - c1)
    zero = torch.zeros_like(m1)
    ms = (zero, m1, m2, zero)
    ys = (y0, y1, y2, y3)
    s = _index(t, 2)
    out = _spline_seg(ys[0], ys[1], ms[0], ms[1], t, 0.0, 1.0)
    for k in (1, 2):
        out = torch.where(s == k,
                          _spline_seg(ys[k], ys[k + 1], ms[k], ms[k + 1],
                                      t, float(k), float(k + 1)),
                          out)
    return out


def _d_spline_at(tab, tab2, dv, iy, ix, jy, jx, id_, d):
    """The delta spline of one (x, y) control point at d, clamped to the
    table's delta range."""
    d_cl = torch.clamp(d, dv[0], dv[-1])
    return _spline_seg(tab[iy + jy, ix + jx, id_],
                       tab[iy + jy, ix + jx, id_ + 1],
                       tab2[iy + jy, ix + jx, id_],
                       tab2[iy + jy, ix + jx, id_ + 1],
                       d_cl, dv[id_], dv[id_ + 1])


def interpolate_F_bilinear(tab, tab2, dv, idx_map, ampl, l1, l2, l3):
    """BILINEAR_SPLINE variant (collapse_times.c:1222-1231): a cubic spline
    along delta at the 4 surrounding (x, y) control points, bilinear across
    them; tab2 = spline_d2(tab, dv)."""
    d, fx, fy, ix, iy, id_ = _locate(dv, idx_map, ampl, l1, l2, l3)
    dx = fx - ix.float()
    dy = fy - iy.float()
    g = [[_d_spline_at(tab, tab2, dv, iy, ix, jy, jx, id_, d)
          for jx in (0, 1)] for jy in (0, 1)]
    return ((1 - dx) * (1 - dy) * g[0][0] + dx * (1 - dy) * g[0][1]
            + (1 - dx) * dy * g[1][0] + dx * dy * g[1][1])


def interpolate_F_bicubic(tab, tab2, dv, idx_map, ampl, l1, l2, l3):
    """ALL_SPLINE variant (collapse_times.c:1152-1186): a cubic spline along
    delta at the 16 control points of a 4x4 (x, y) patch, then a natural
    bicubic across the patch, whose start clamps at the table edges like
    the reference's ixstart/iystart."""
    d, fx, fy, ix, iy, id_ = _locate(dv, idx_map, ampl, l1, l2, l3)
    nxy = CT_NBINS_XY
    ixs = torch.where(ix == 0, 0, torch.where(ix >= nxy - 2, nxy - 4, ix - 1))
    iys = torch.where(iy == 0, 0, torch.where(iy >= nxy - 2, nxy - 4, iy - 1))
    tx = fx - ixs.float()
    ty = fy - iys.float()
    rows = []
    for jy in range(4):
        vals = [_d_spline_at(tab, tab2, dv, iys, ixs, jy, jx, id_, d)
                for jx in range(4)]
        rows.append(_nat4(*vals, tx))
    return _nat4(*rows, ty)


INTERP = ("trilinear", "bilinear", "bicubic")


def interp_F(interp: str, tab, tab2, dv, idx_map, ampl, l1, l2, l3):
    """Dispatch over the three variants (the TRILINEAR / BILINEAR_SPLINE /
    ALL_SPLINE compile switch, collapse_times.c:1139-1231)."""
    if interp == "bicubic":
        return interpolate_F_bicubic(tab, tab2, dv, idx_map, ampl,
                                     l1, l2, l3)
    if interp == "bilinear":
        return interpolate_F_bilinear(tab, tab2, dv, idx_map, ampl,
                                      l1, l2, l3)
    if interp == "trilinear":
        return interpolate_F(tab, dv, idx_map, ampl, l1, l2, l3)
    raise ValueError(f"unknown interpolation variant {interp!r}")
