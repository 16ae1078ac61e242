# The benchmark's frozen copy of pinocchio_tpu_torch/scaledep.py: the reference
# computes with it and never with the program's own module, so that a
# change to the program cannot move the yardstick it is held to.
"""Per-smoothing-radius effective scales for scale-dependent growth.

Re-implements set_scaledep_GM (initialization.c:1533-2030): for every
smoothing radius, find the wavenumber k at which the Fourier growing mode
D(a, k) best tracks the time evolution of (a) the rms of the smoothed
density (Gaussian window), (b) the rms displacement (top-hat window over a
linear radius ladder up to the largest halo), and (c) the rms velocity
(same, weighted by f).  Also tabulates, per radius, the effective growth
factor of the smoothed density D_R(a) that replaces the inverse growing
mode in the ELL_CLASSIC collapse conversion (SPLINE_INVGROW,
cosmo.c:1822-1832).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.integrate import quad

from .config import Params
from .cosmology import (DELTALOGK, GAUSSIAN, LOGKMIN, NBINS, NK_BINS,
                        TOP_HAT, Cosmology)

SMALLDIFF = 1.e-5
MAXITER = 20
TOL = 1.e-4


@dataclass
class ScaleDepGM:
    Rad_GM: np.ndarray          # linear radius ladder (Mpc)
    k_GM_dens: np.ndarray
    k_GM_displ: np.ndarray
    k_GM_vel: np.ndarray
    # per-radius effective growth D_R(a) on the standard a grid, normalized
    # to 1 today (feeds InverseGrowingMode per radius)
    invgrow_logD: np.ndarray    # [Nsmooth, NBINS] log10 D_R
    loga_grid: np.ndarray


def _sigma_of_a(cosmo: Cosmology, R: float, a_grid, wtype, nyquist,
                weight_fomega=False, nk: int = 384):
    """sqrt of the windowed variance integral at each a, vectorized:
    fixed log-k Simpson quadrature with D(a,k) (and optionally f(a,k))
    evaluated as [na, nk] arrays — the integrand is smooth so a few
    hundred nodes match the reference's adaptive QAGS to ~1e-5."""
    logk = np.linspace(-4.0, nyquist, nk)
    k = 10.0 ** logk
    w = np.asarray(cosmo.window(k * R, wtype), np.float64)
    pk = np.asarray(cosmo.PowerSpectrum(k), np.float64)
    # the reference integrates over ln k (IntegrandForSDDensVariance,
    # initialization.c:1439-1457)
    base = (pk * w * w * (k ** 3 if wtype == GAUSSIAN else k)
            / (2.0 * math.pi ** 2))
    z = 1.0 / np.asarray(a_grid) - 1.0
    # D(a,k) on the [na, nk] grid via the k-bin interpolation
    D = np.empty((len(z), nk))
    FO = np.ones((len(z), nk))
    for j in range(nk):
        D[:, j] = cosmo.GrowingMode(z, k[j])
        if weight_fomega:
            FO[:, j] = cosmo.fomega(z, k[j])
    integ = base[None, :] * D * D * (FO * FO if weight_fomega else 1.0)
    # Simpson over uniform ln k spacing
    from scipy.integrate import simpson
    lnk = logk * math.log(10.0)
    out = simpson(integ, x=lnk, axis=1)
    return np.sqrt(np.maximum(out, 0.0))


def _best_k(cosmo: Cosmology, target, a_grid, z20, today,
            weight_fomega=False):
    """Bisection in log k for the scale whose growth best matches the
    normalized target curve (initialization.c:1609-1690)."""
    zz = 1.0 / a_grid[z20:today + 1] - 1.0

    def model_diff(k):
        if weight_fomega:
            norm = float(cosmo.GrowingMode(0.0, k) * cosmo.fomega(0.0, k))
            vals = np.asarray(cosmo.GrowingMode(zz, k)
                              * cosmo.fomega(zz, k)) / norm
        else:
            norm = float(cosmo.GrowingMode(0.0, k))
            vals = np.asarray(cosmo.GrowingMode(zz, k)) / norm
        return float((target[z20:today + 1] - vals).sum()) / NBINS

    logk1 = LOGKMIN
    logk2 = LOGKMIN + (NK_BINS - 1) * DELTALOGK
    k1, k2 = 10.0 ** logk1, 10.0 ** logk2
    d1, d2 = model_diff(k1), model_diff(k2)
    if abs(d1) < SMALLDIFF:
        return k1
    if abs(d2) < SMALLDIFF:
        return k2
    if d1 * d2 > 0:
        return k1 if abs(d1) < abs(d2) else k2
    mindiff = min(abs(d1), abs(d2))
    kmid = k1
    for _ in range(MAXITER + 1):
        logkmid = 0.5 * (logk1 + logk2)
        kmid = 10.0 ** logkmid
        dm = model_diff(kmid)
        mindiff = min(mindiff, abs(dm))
        if d1 * dm > 0:
            logk1, d1 = logkmid, dm
        else:
            logk2, d2 = logkmid, dm
        if mindiff <= SMALLDIFF:
            break
    return kmid


def set_scaledep_gm(params: Params, cosmo: Cosmology, smoothing,
                    largest_mass: float, verbose=True) -> ScaleDepGM:
    nsmooth = smoothing.n
    a_grid = 10.0 ** cosmo._loga_grid
    today = int(np.flatnonzero(a_grid <= 1.0)[-1])
    z20 = int(np.flatnonzero(a_grid <= 1.0 / 21.0)[-1])
    nyquist_logk = math.log10(math.pi / params.InterPartDist)

    k_dens = np.zeros(nsmooth)
    k_displ = np.zeros(nsmooth)
    k_vel = np.zeros(nsmooth)
    invgrow = np.zeros((nsmooth, NBINS))

    # density: Gaussian window over the smoothing ladder radii
    for ism in range(nsmooth):
        sig = _sigma_of_a(cosmo, smoothing.radii[ism], a_grid, GAUSSIAN,
                          nyquist_logk)
        sig = sig / sig[today]
        k_dens[ism] = _best_k(cosmo, sig, a_grid, z20, today)
        invgrow[ism] = np.log10(sig)

    # displacements & velocities: top-hat window over a linear radius
    # ladder from the largest halo's Lagrangian size down to 0
    largest_r = float(cosmo.SizeForMass(largest_mass, TOP_HAT))
    rad_gm = largest_r * (nsmooth - 1 - np.arange(nsmooth)) / (nsmooth - 1)
    for ism in range(nsmooth):
        sig = _sigma_of_a(cosmo, rad_gm[ism], a_grid, TOP_HAT,
                          nyquist_logk)
        sig = sig / sig[today]
        k_displ[ism] = _best_k(cosmo, sig, a_grid, z20, today)
        sigv = _sigma_of_a(cosmo, rad_gm[ism], a_grid, TOP_HAT,
                           nyquist_logk, weight_fomega=True)
        sigv = sigv / sigv[today]
        k_vel[ism] = _best_k(cosmo, sigv, a_grid, z20, today,
                             weight_fomega=True)

    if verbose:
        print(f"  scale-dependent growth: k_dens="
              f"{np.array2string(k_dens, precision=3)}")
    return ScaleDepGM(Rad_GM=rad_gm, k_GM_dens=k_dens, k_GM_displ=k_displ,
                      k_GM_vel=k_vel, invgrow_logD=invgrow,
                      loga_grid=cosmo._loga_grid.copy())
