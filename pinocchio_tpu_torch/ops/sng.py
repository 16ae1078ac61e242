"""ELL_SNG: triaxial collapse of Nadkarni-Ghosh & Singhal (2016).

Re-implements ell_sng (collapse_times.c:239-400): the 9-eigenvalue ODE
system for (lambda_a, lambda_v, lambda_d) integrated from a=1e-5 until the
first axis collapses (lambda_a1 -> 1), returning the collapse scale factor.

The reference solves one particle at a time with GSL RKF45; here the whole
batch of (l1, l2, l3) triples is integrated together with a vectorized
classic RK4 on a log-spaced scale-factor grid — this backs the TABULATED_CT
table build, where ~250k nodes are solved at once on the host.
"""

from __future__ import annotations

import math

import numpy as np

AMIN = 1.e-5
AMAX = 5.0


def _force_modification_fr(cosmo, size, a, delta):
    """f(R) thickness-screening force boost (ForceModification,
    collapse_times.c:296-309); size = smoothing radius in Mpc."""
    p = cosmo.p
    ff = 4.0 * p.OmegaLambda / p.Omega0
    H_over_c = 100.0 / 299792.458
    with np.errstate(all="ignore"):
        thickness = (p.fr0 / p.Omega0 / (H_over_c * size) ** 2
                     * a ** 7 * np.maximum(1.0 + delta, 1e-10) ** (-1.0 / 3.0)
                     * (((1.0 + ff) / (1.0 + ff * a ** 3)) ** 2
                        - ((1.0 + ff) / (1.0 + delta + ff * a ** 3)) ** 2))
    F3 = thickness * (3.0 + thickness * (-3.0 + thickness))
    F3 = np.maximum(F3, 0.0)
    return np.where(F3 < 1.0, F3 / 3.0, 1.0 / 3.0)


def _rhs(a, y, cosmo, fr_size=None):
    """dy/da for the 9-eqn system (sng_system, collapse_times.c:239-289).
    y: [9, n]; fr_size enables the f(R) force modification."""
    z = 1.0 / a - 1.0
    omegam = float(cosmo.OmegaMatter(z))
    omegal = float(cosmo.OmegaLambdaZ(z))
    la = y[0:3]          # lambda_a
    lv = y[3:6]          # lambda_v
    ld = y[6:9]          # lambda_d
    delta = ld.sum(axis=0)

    f = np.empty_like(y)
    # sum_{j != i} term of the lambda_d equations
    one_m = 1.0 - la
    sq = one_m * one_m
    for i in range(3):
        s = np.zeros_like(delta)
        for j in range(3):
            if i == j:
                continue
            num = (ld[j] - ld[i]) * (sq[i] * (1.0 + lv[i])
                                     - sq[j] * (1.0 + lv[j]))
            den = sq[i] - sq[j]
            # the reference skips identical-eigenvalue pairs (y[i]==y[j])
            safe = np.abs(den) > 0
            s = s + np.where(safe, num / np.where(safe, den, 1.0), 0.0)
        f[i] = lv[i] * (la[i] - 1.0) / a
        grav = 3.0 * omegam * ld[i]
        if fr_size is not None:
            grav = grav * (1.0 + _force_modification_fr(cosmo, fr_size,
                                                        a, delta))
        f[3 + i] = 0.5 * (lv[i] * (omegam - 2.0 * omegal - 2.0)
                          - grav - 2.0 * lv[i] * lv[i]) / a
        f[6 + i] = ((5.0 / 6.0 + ld[i])
                    * ((3.0 + lv.sum(axis=0))
                       - (1.0 + delta) / (2.5 + delta) * lv.sum(axis=0))
                    - (2.5 + delta) * (1.0 + lv[i]) + s) / a
    return f


def ell_sng_batch(l1, l2, l3, D_in, cosmo, nstep: int = 3000,
                  fr_size=None):
    """Collapse scale factor a_c for each (l1,l2,l3); 0 = never collapses.

    D_in is the linear growing mode at a=AMIN used to scale the initial
    eigenvalues (collapse_times.c:346-359)."""
    l = np.stack([np.asarray(l1, float), np.asarray(l2, float),
                  np.asarray(l3, float)]) * D_in
    n = l.shape[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        lv0 = l / (l - 1.0)
    y = np.concatenate([l, lv0, l], axis=0)    # [9, n]

    a_grid = np.exp(np.linspace(math.log(AMIN), math.log(AMAX), nstep + 1))
    a_c = np.zeros(n)
    done = np.zeros(n, bool)
    with np.errstate(all="ignore"):
        for i in range(nstep):
            a0, a1 = a_grid[i], a_grid[i + 1]
            h = a1 - a0
            old_lam = y[0].copy()
            k1 = _rhs(a0, y, cosmo, fr_size)
            k2 = _rhs(a0 + h / 2, y + h / 2 * k1, cosmo, fr_size)
            k3 = _rhs(a0 + h / 2, y + h / 2 * k2, cosmo, fr_size)
            k4 = _rhs(a1, y + h * k3, cosmo, fr_size)
            y = y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            lam = y[0]
            # an axis can shoot through lambda=1 within one step, leaving
            # a non-finite state: both count as collapse this step
            blown = ~np.isfinite(lam)
            crossing = (~done) & ((lam >= 0.99999) | blown)
            if crossing.any():
                # linear interpolation of the crossing
                # (collapse_times.c:391-394); for blown columns use the
                # pre-step slope instead
                dlam = np.where(np.isfinite(lam), lam - old_lam, np.inf)
                frac = np.where(dlam > 0,
                                (1.0 - old_lam)
                                / np.where(dlam > 0, dlam, 1.0), 0.0)
                slope_frac = np.where(k1[0] * h > 0,
                                      (1.0 - old_lam)
                                      / np.maximum(k1[0] * h, 1e-30), 1.0)
                frac = np.where(blown, slope_frac, frac)
                a_c[crossing] = a0 + np.clip(frac[crossing], 0, 1) * h
                done[crossing] = True
                # freeze finished columns to avoid numerical blow-up
                y[:, crossing] = 0.0
            # keep non-finite non-crossed columns inert
            bad = ~np.isfinite(y).all(axis=0)
            if bad.any():
                y[:, bad & done] = 0.0
            if done.all():
                break
    return a_c


def ell_sng_F(l1, l2, l3, D_in, cosmo, nstep: int = 3000, fr_size=None):
    """F = 1 + z_c = 1/a_c (ell, collapse_times.c:417-426); fr_size (Mpc)
    turns on the f(R) force modification for MOD_GRAV_FR runs."""
    a_c = ell_sng_batch(l1, l2, l3, D_in, cosmo, nstep, fr_size)
    with np.errstate(divide="ignore"):
        return np.where(a_c > 0.0, 1.0 / np.where(a_c > 0, a_c, 1.0), 0.0)
