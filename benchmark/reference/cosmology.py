# The benchmark's frozen copy of pinocchio_tpu_torch/cosmology.py: the reference
# computes with it and never with the program's own module, so that a
# change to the program cannot move the yardstick it is held to.
"""Cosmology services for pinocchio-tpu.

Re-implements the math contract of the reference cosmology module
(the reference's src/cosmo.c): Friedmann background, growth factors D1, D2,
D31, D32 and their logarithmic derivatives f = dlnD/dlna from the LPT growth
ODE system (cosmo.c:659-755), power spectra (Eisenstein & Hu fit
cosmo.c:1447-1498, tabulated, Efstathiou, power law), mass / displacement
variances (cosmo.c:1559-1609), distances, and 11 analytic halo mass functions
(cosmo.c:1919-2003).

Everything here runs once at start-up on the host in float64 (numpy/scipy);
`GrowthTables` exports dense arrays consumed by the JAX/TPU compute path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.integrate import quad, solve_ivp
from scipy.interpolate import CubicSpline

from .config import Params

# constants (cosmo.c:36-44, pinocchio.h:55-65)
PI = math.pi
OMEGARAD_H2 = 4.2e-5
UNITLENGTH_CM = 3.085678e24
HUBBLETIME_GYR = 3.085678e24 / 1.e7 / 3.1558150e16
DELTA_C = 1.686
SHAPE_EFST = 0.21
SPEEDOFLIGHT = 299792.458
NBINS = 210          # time bins of all cosmological splines (pinocchio.h:65)
NBB = 10
LOG_AMIN = -4.0
DLOGA = -LOG_AMIN / (NBINS - NBB)   # = 0.02
TOLERANCE = 1.e-4

GAUSSIAN, SHARP_K, TOP_HAT = 0, 1, 2

# scale-dependent growth k grid (def_splines.h:40-43)
NK_BINS = 10
LOGKMIN = -3.0
DELTALOGK = 0.5


class _Spline:
    """Natural cubic spline with linear extrapolation beyond the x-range,
    mirroring my_spline_eval (cosmo.c:2016-2027) on a GSL cspline."""

    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self._cs = CubicSpline(self.x, self.y, bc_type="natural")

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        lo = self.x[0], self.y[0]
        lo_slope = (self.y[1] - self.y[0]) / (self.x[1] - self.x[0])
        hi = self.x[-1], self.y[-1]
        hi_slope = (self.y[-1] - self.y[-2]) / (self.x[-1] - self.x[-2])
        out = self._cs(np.clip(x, self.x[0], self.x[-1]))
        out = np.where(x < self.x[0], lo[1] + (x - lo[0]) * lo_slope, out)
        out = np.where(x > self.x[-1], hi[1] + (x - hi[0]) * hi_slope, out)
        return out if out.ndim else float(out)


@dataclass
class VarianceTables:
    """Mass/displacement variance splines for one window type
    (initialize_MassVariance, cosmo.c:1507-1557)."""
    window: int
    massvar: _Spline      # log10 R -> log10 sigma^2(R)
    radius: _Spline       # -log10 sigma^2 -> log10 R
    dvardr: _Spline       # log10 R -> dlog sigma^2 / dlog R
    dispvar: _Spline      # log10 R -> log10 sigma_displ^2(R)

    def MassVariance(self, R):
        return 10.0 ** self.massvar(np.log10(R))

    def dMassVariance_dr(self, R):
        return self.dvardr(np.log10(R))

    def DisplVariance(self, R):
        return 10.0 ** self.dispvar(np.log10(R))

    def Radius(self, var):
        return 10.0 ** self.radius(-np.log10(var))


class Cosmology:
    """Background + growth + P(k) + variances for a Params config."""

    def __init__(self, params: Params):
        self.p = params
        p = params
        self.OmegaRad = 0.0 if p.norad else OMEGARAD_H2 / p.Hubble100 ** 2
        self.OmegaK = 1.0 - p.Omega0 - p.OmegaLambda - self.OmegaRad
        self.MatterDensity = 2.775499745e11 * p.Hubble100 ** 2 * p.Omega0
        self.simpleLambda = (p.DEw0 == -1.0 and p.DEwa == 0.0
                             and p.TabulatedEoSfile == "no")
        self._eos_spline = None
        self._int_eos_spline = None
        if not self.simpleLambda:
            self._init_dark_energy()

        # optional tabulated H(z) (READ_HUBBLE_TABLE, cosmo.c:874-931)
        self._hubble_spline = None
        if getattr(p, "HubbleTableFile", "no") not in ("no", ""):
            self._init_hubble_table()

        self._init_power_spectrum()
        self._integrate_growth()
        self.scale_dep = False
        if p.scale_dependent and self.WhichSpectrum == 5:
            self._init_scaledep_from_camb()
        elif p.mod_grav_fr:
            self._init_scaledep_from_fr()
        elif p.scale_dependent:
            # SCALE_DEP_LCDM: k-independent growth replicated onto the
            # k grid — exercises the scale-dependent machinery with LCDM
            # physics (the reference's per-k ODEs coincide for LCDM)
            self._sd_spl_grow = {
                o: [spl] * NK_BINS for o, spl in
                ((1, self.sp_grow1), (2, self.sp_grow2),
                 (31, self.sp_grow31), (32, self.sp_grow32))}
            self._sd_spl_fom = {
                o: [spl] * NK_BINS for o, spl in
                ((1, self.sp_fom1), (2, self.sp_fom2),
                 (31, self.sp_fom31), (32, self.sp_fom32))}
            self.kmin = 10.0 ** LOGKMIN
            self.kmax = 10.0 ** (LOGKMIN + (NK_BINS - 1) * DELTALOGK)
            self.scale_dep = True
        self.PkNorm = 1.0
        self._normalize_power_spectrum()
        # Gaussian-window variance drives the smoothing ladder
        # (initialize_cosmology -> WindowFunctionType=0, cosmo.c:435-437);
        # top-hat is used for mass functions (initialization.c:96-98).
        self.var_gauss = self._init_mass_variance(GAUSSIAN)
        self.var_tophat = self._init_mass_variance(TOP_HAT)

    # ------------------------------------------------------------------
    # dark energy equation of state
    # ------------------------------------------------------------------
    def _init_dark_energy(self):
        p = self.p
        if p.TabulatedEoSfile != "no":
            data = np.loadtxt(p.TabulatedEoSfile)
            self._eos_spline = _Spline(np.log10(data[:, 0]), data[:, 1])
        # integral of w(a)/a from a to 1 on the standard grid (cosmo.c:143-156)
        la = LOG_AMIN + (np.arange(NBINS) + 1) * DLOGA
        vals = [quad(lambda a: self.DE_EquationOfState(a) / a, 10.0 ** x, 1.0,
                     epsabs=0.0, epsrel=TOLERANCE, limit=1000)[0] for x in la]
        self._int_eos_spline = _Spline(la, vals)

    def DE_EquationOfState(self, a):
        if self._eos_spline is not None:
            return self._eos_spline(np.log10(a))
        return self.p.DEw0 + (1.0 - a) * self.p.DEwa

    # ------------------------------------------------------------------
    # background
    # ------------------------------------------------------------------
    def Esq(self, z):
        """E^2(z) = (H/H0_100h)^2; Hubble() of cosmo.c:1691-1711."""
        p = self.p
        zp1 = np.asarray(1.0 + np.asarray(z), dtype=np.float64)
        if self._hubble_spline is not None:
            return 10.0 ** (2.0 * self._hubble_spline(-np.log10(zp1)))
        base = (self.OmegaRad * zp1 ** 4 + p.Omega0 * zp1 ** 3
                + self.OmegaK * zp1 ** 2)
        if self.simpleLambda:
            return base + p.OmegaLambda
        de_int = self._int_eos_spline(-np.log10(zp1))
        return base + p.OmegaLambda * zp1 ** 3 * np.exp(3.0 * de_int)

    def _init_hubble_table(self):
        """Tabulated H(z) in km/s/Mpc -> spline of log10 H over log10 a
        (read_TabulatedHubble, cosmo.c:874-931)."""
        import os
        path = self.p.HubbleTableFile
        if not os.path.isabs(path):
            path = os.path.join(self.p.work_dir, path)
        data = np.loadtxt(path)
        loga = np.log10(1.0 / (1.0 + data[:, 0]))
        logH = np.log10(data[:, 1])
        order = np.argsort(loga)
        self._hubble_spline = _Spline(loga[order], logH[order])

    def Hubble(self, z):
        """H(z) in km/s/Mpc; prefers the external table when provided
        (cosmo.c:1696-1699)."""
        if self._hubble_spline is not None:
            return (100.0 * self.p.Hubble100
                    * 10.0 ** self._hubble_spline(
                        -np.log10(1.0 + np.asarray(z))))
        return 100.0 * self.p.Hubble100 * np.sqrt(self.Esq(z))

    def Hubble_Gyr(self, z):
        return self.Hubble(z) / HUBBLETIME_GYR / 100.0

    def OmegaMatter(self, z):
        return self.p.Omega0 * (1.0 + np.asarray(z)) ** 3 / self.Esq(z)

    def OmegaLambdaZ(self, z):
        return self.p.OmegaLambda / self.Esq(z)

    def _E2_of_a(self, a):
        return self.Esq(1.0 / a - 1.0)

    def _dlnE2_da(self, a):
        """d ln E^2 / da, analytic (cosmo.c:632-657); spline derivative of
        the external H table when one is loaded (cosmo.c:619-630)."""
        p = self.p
        if self._hubble_spline is not None:
            sp = self._hubble_spline
            x = math.log10(a)
            x = min(max(x, sp.x[0]), sp.x[-1])
            return (2.0 / a) * float(sp._cs(x, 1))
        a2, a3, a4, a5 = a * a, a ** 3, a ** 4, a ** 5
        E2 = p.Omega0 / a3 + self.OmegaK / a2 + self.OmegaRad / a4
        dE2 = (-3.0 * p.Omega0 / a4 - 2.0 * self.OmegaK / a3
               - 4.0 * self.OmegaRad / a5)
        if self.simpleLambda:
            E2 += p.OmegaLambda
        else:
            de_int = self._int_eos_spline(np.log10(a))
            w = self.DE_EquationOfState(a)
            fac = p.OmegaLambda * math.exp(3.0 * de_int)
            E2 += fac / a3
            dE2 += -3.0 * (1.0 + w) * fac / a4
        return dE2 / E2

    # ------------------------------------------------------------------
    # f(R) modified gravity: scale-dependent growth from the modified ODE
    # (mu(a,k) cosmo.c:598-606; f(R) system cosmo.c:720-752,
    # Moretti et al. 2019)
    # ------------------------------------------------------------------
    def _mu_fr(self, a, k):
        p = self.p
        H_over_c = 100.0 / SPEEDOFLIGHT
        B1 = p.Omega0 / a ** 3 + 4.0 * p.OmegaLambda
        B2 = p.Omega0 + 4.0 * p.OmegaLambda
        emme = 0.5 * H_over_c ** 2 * B1 ** 3 / (B2 ** 2 * p.fr0)
        return 1.0 + k * k / 3.0 / (k * k + a * a * emme)

    def _growth_rhs_fr(self, a, y, k):
        """8-component growth system at one wavenumber with the f(R)
        force modification; 3rd order stays LCDM (cosmo.c:739-748)."""
        p = self.p
        E2 = self._E2_of_a(a)
        a1 = -(3.0 / a + 0.5 * self._dlnE2_da(a))
        b1 = 1.5 * p.Omega0 / (E2 * a ** 5)
        H_over_c = 100.0 / SPEEDOFLIGHT
        B1 = p.Omega0 + 4.0 * p.OmegaLambda
        B2 = p.Omega0 / a ** 3 + 4.0 * p.OmegaLambda
        mu = self._mu_fr(a, k)
        PI1 = k * k / a / a + 0.5 * H_over_c ** 2 * B2 ** 3             / (B1 ** 2 * p.fr0)
        # NB reproduced as in cosmo.c:736 (the '+' before pow is the
        # reference's expression)
        PI2 = k * k / a / a / 2.0 + 0.5 * H_over_c ** 2             + B2 ** 3 / (B1 ** 2 * p.fr0)
        M2 = (p.Omega0 * H_over_c ** 2 * k * k
              * (1.5 * H_over_c / p.fr0) ** 2 * B2 ** 5 / B1 ** 4
              / (9.0 * a ** 5))
        dD1, D1, dD2, D2, dD31, D31, dD32, D32 = y
        out = np.empty(8)
        out[0] = a1 * dD1 + mu * b1 * D1
        out[1] = dD1
        out[2] = (a1 * dD2 + mu * b1 * D2
                  - (mu - M2 / PI1 / PI2 / PI2) * b1 * D1 * D1)
        out[3] = dD2
        out[4] = a1 * dD31 + b1 * D31 - 2.0 * b1 * D1 ** 3
        out[5] = dD31
        out[6] = (a1 * dD32 + b1 * D32 - 2.0 * b1 * D1 * D2
                  + 2.0 * b1 * D1 ** 3)
        out[7] = dD32
        return out

    def _init_scaledep_from_fr(self):
        """Per-k-bin growth for f(R): k=0 for the first bin like the
        reference (cosmo.c:729-734), normalized by the k=0 D1 today."""
        agrid = 10.0 ** self._loga_grid
        x1 = 10.0 ** (LOG_AMIN - 2.0)
        today = int(np.argmax(agrid >= 1.0))
        g = {o: np.zeros((NK_BINS, NBINS)) for o in (1, 2, 31, 32)}
        f = {o: np.zeros((NK_BINS, NBINS)) for o in (1, 2, 31, 32)}
        norm = None
        for j in range(NK_BINS):
            k = 0.0 if j == 0 else 10.0 ** (LOGKMIN + j * DELTALOGK)
            y0 = np.array([1.0, x1, -6.0 / 7.0 * x1, -3.0 / 7.0 * x1 * x1,
                           -x1 * x1, -x1 ** 3 / 3.0,
                           10.0 / 7.0 * x1 * x1, 10.0 / 21.0 * x1 ** 3])
            sol = solve_ivp(lambda a, y: self._growth_rhs_fr(a, y, k),
                            (x1, agrid[-1]), y0, method="RK45",
                            t_eval=agrid, rtol=1e-8, atol=1e-8)
            Y = sol.y
            g[1][j] = Y[1]
            g[2][j] = -Y[3]
            g[31][j] = -Y[5] / 3.0
            g[32][j] = Y[7] / 4.0
            f[1][j] = agrid * Y[0] / Y[1]
            f[2][j] = agrid * Y[2] / Y[3]
            f[31][j] = agrid * Y[4] / Y[5]
            f[32][j] = agrid * Y[6] / Y[7]
            if j == 0:
                norm = g[1][0][today]
        for j in range(NK_BINS):
            g[1][j] /= norm
            g[2][j] /= norm ** 2
            g[31][j] /= norm ** 3
            g[32][j] /= norm ** 3
        self.sd_grow = g
        self.sd_fomega = f
        self._sd_spl_grow = {
            o: [_Spline(self._loga_grid, np.log10(g[o][j]))
                for j in range(NK_BINS)] for o in (1, 2, 31, 32)}
        self._sd_spl_fom = {
            o: [_Spline(self._loga_grid, f[o][j])
                for j in range(NK_BINS)] for o in (1, 2, 31, 32)}
        self.kmin = 10.0 ** LOGKMIN
        self.kmax = 10.0 ** (LOGKMIN + (NK_BINS - 1) * DELTALOGK)
        self.scale_dep = True

    # ------------------------------------------------------------------
    # growth factors: LPT growth ODE system (cosmo.c:659-702)
    # ------------------------------------------------------------------
    def _growth_rhs(self, a, y):
        E2 = self._E2_of_a(a)
        a1 = -(3.0 / a + 0.5 * self._dlnE2_da(a))
        b1 = 1.5 * self.p.Omega0 / (E2 * a ** 5)
        dD1, D1, dD2, D2, dD31, D31, dD32, D32 = y[1:9]
        dydx = np.empty_like(y)
        dydx[0] = 1.0 / (a * math.sqrt(E2))
        dydx[1] = a1 * dD1 + b1 * D1
        dydx[2] = dD1
        dydx[3] = a1 * dD2 + b1 * D2 - b1 * D1 * D1
        dydx[4] = dD2
        dydx[5] = a1 * dD31 + b1 * D31 - 2.0 * b1 * D1 ** 3
        dydx[6] = dD31
        dydx[7] = a1 * dD32 + b1 * D32 - 2.0 * b1 * D1 * D2 + 2.0 * b1 * D1 ** 3
        dydx[8] = dD32
        return dydx

    def _integrate_growth(self):
        # scale-factor grid of all time splines (cosmo.c:101, 227-231)
        ia = np.arange(NBINS)
        loga = LOG_AMIN + ia * DLOGA
        loga[np.abs(loga) < DLOGA / 10.0] = 0.0
        agrid = 10.0 ** loga
        self._loga_grid = np.log10(agrid)

        x1 = 10.0 ** (LOG_AMIN - 2.0)
        # matter-dominated ICs (cosmo.c:202-217)
        y0 = np.array([2.0 / 3.0 * x1 ** 1.5,
                       1.0, x1,
                       -6.0 / 7.0 * x1, -3.0 / 7.0 * x1 * x1,
                       -x1 * x1, -x1 ** 3 / 3.0,
                       10.0 / 7.0 * x1 * x1, 10.0 / 21.0 * x1 ** 3])
        sol = solve_ivp(self._growth_rhs, (x1, agrid[-1]), y0, method="RK45",
                        t_eval=agrid, rtol=1.e-8, atol=1.e-8, max_step=np.inf)
        if not sol.success:
            raise RuntimeError("growth ODE integration failed: " + sol.message)
        Y = sol.y
        cosmtime = np.log10(Y[0] * HUBBLETIME_GYR / self.p.Hubble100)
        grow1 = Y[2].copy()
        grow2 = -Y[4]
        grow31 = -Y[6] / 3.0
        grow32 = Y[8] / 4.0
        fom1 = agrid * Y[1] / Y[2]
        fom2 = agrid * Y[3] / Y[4]
        fom31 = agrid * Y[5] / Y[6]
        fom32 = agrid * Y[7] / Y[8]

        today = int(np.argmax(agrid >= 1.0))
        norm = grow1[today]
        grow1 /= norm
        grow2 /= norm ** 2
        grow31 /= norm ** 3
        grow32 /= norm ** 3

        # comoving / diameter distance (cosmo.c:268-286)
        comv = np.zeros(NBINS - NBB)
        diam = np.zeros(NBINS - NBB)
        sqrtOK = math.sqrt(abs(self.OmegaK))
        for i in range(NBINS - NBB):
            z = 1.0 / agrid[i] - 1.0
            val = quad(lambda zz: 1.0 / self.Hubble(zz), 0.0, z,
                       epsabs=0.0, epsrel=TOLERANCE, limit=1000)[0]
            comv[i] = SPEEDOFLIGHT * val
            if abs(self.OmegaK) < 1.e-4:
                diam[i] = agrid[i] * comv[i]
            else:
                R0 = SPEEDOFLIGHT / self.p.Hubble100 / 100.0 / sqrtOK
                f = math.sin if self.OmegaK < 0 else math.sinh
                diam[i] = agrid[i] * R0 * f(comv[i] / R0)

        la = self._loga_grid
        self.sp_time = _Spline(la, cosmtime)
        self.sp_invtime = _Spline(cosmtime, la)
        self.sp_comvdist = _Spline(la[:NBINS - NBB], comv)
        self.sp_diamdist = _Spline(la[:NBINS - NBB], diam)
        self.sp_grow1 = _Spline(la, np.log10(grow1))
        self.sp_grow2 = _Spline(la, np.log10(grow2))
        self.sp_grow31 = _Spline(la, np.log10(grow31))
        self.sp_grow32 = _Spline(la, np.log10(grow32))
        self.sp_invgrow = _Spline(np.log10(grow1), la)
        self.sp_fom1 = _Spline(la, fom1)
        self.sp_fom2 = _Spline(la, fom2)
        self.sp_fom31 = _Spline(la, fom31)
        self.sp_fom32 = _Spline(la, fom32)

    # ------------------------------------------------------------------
    # scale-dependent growth from CAMB P(k,z) tables
    # (read_Pk_table_from_CAMB, cosmo.c:1192-1429)
    # ------------------------------------------------------------------
    def _init_scaledep_from_camb(self):
        import glob
        import os
        p = self.p
        base = p.CAMBMatterFile
        rfile = p.CAMBRedshiftsFile
        if not os.path.isabs(base):
            base = os.path.join(p.work_dir, base)
        if not os.path.isabs(rfile):
            rfile = os.path.join(p.work_dir, rfile)
        files = sorted(glob.glob(base + "_*.dat"))
        ncamb = len(files)
        reds = np.loadtxt(rfile)[:, 1]
        if reds[-1] != 0.0:
            raise ValueError("last CAMB redshift must be 0")
        camb_a = 1.0 / (1.0 + reds)

        # lingrow(a, logk) = 0.5 (log10 k^3 P(k,z) - log10 k^3 P(k,0))
        data0 = np.loadtxt(files[-1])
        logk_table = np.log10(data0[:, 0] * p.Hubble100)
        logk3p0 = np.log10(data0[:, 0] ** 3 * data0[:, 1])
        lingrow = np.zeros((ncamb, len(logk_table)))
        for i in range(ncamb - 1):
            d = np.loadtxt(files[i])
            lingrow[i] = 0.5 * (np.log10(d[:, 0] ** 3 * d[:, 1]) - logk3p0)

        from scipy.interpolate import RectBivariateSpline
        spl2d = RectBivariateSpline(camb_a, logk_table, lingrow,
                                    kx=3, ky=3)

        agrid = 10.0 ** self._loga_grid
        nb = NBINS
        g1 = np.zeros((NK_BINS, nb))
        g2 = np.zeros((NK_BINS, nb))
        g31 = np.zeros((NK_BINS, nb))
        g32 = np.zeros((NK_BINS, nb))
        first = int(np.argmax(agrid >= camb_a[0]))
        inside = (agrid >= camb_a[0]) & (agrid <= 1.0)
        today = int(np.max(np.flatnonzero(inside)))
        for j in range(NK_BINS):
            logk_req = LOGKMIN + j * DELTALOGK
            sel = inside
            Om = self.OmegaMatter(1.0 / agrid[sel] - 1.0)
            g1[j, sel] = 10.0 ** spl2d(agrid[sel], logk_req, grid=False)
            g2[j, sel] = 3.0 / 7.0 * g1[j, sel] ** 2 * Om ** (-1.0 / 143.0)
            # NB: the reference evaluates the 3rd-order factors on the
            # FIRST k bin's D1 for every j (cosmo.c:1351-1352, grow1[i]
            # instead of grow1[i + j*NBINS]); behavior reproduced for
            # output parity
            g31[j, sel] = g1[0, sel] ** 3 * Om ** (-4.0 / 275.0) / 9.0
            g32[j, sel] = (g1[0, sel] ** 3 * Om ** (-268.0 / 17875.0)
                           * 5.0 / 42.0)

        # a > 1: power-law extrapolation (cosmo.c:1357-1369)
        for j in range(NK_BINS):
            slope = (math.log10(g1[j, today] / g1[j, today - 1])
                     / math.log10(agrid[today] / agrid[today - 1]))
            rat = agrid[today + 1:] / agrid[today]
            g1[j, today + 1:] = g1[j, today] * rat ** slope
            g2[j, today + 1:] = g2[j, today] * rat ** (2 * slope)
            g31[j, today + 1:] = g31[j, today] * rat ** (3 * slope)
            g32[j, today + 1:] = g32[j, today] * rat ** (3 * slope)
            # a < first CAMB a: scale with a (cosmo.c:1371-1379)
            rat = agrid[:first] / agrid[first]
            g1[j, :first] = g1[j, first] * rat
            g2[j, :first] = g2[j, first] * rat ** 2
            g31[j, :first] = g31[j, first] * rat ** 3
            g32[j, :first] = g32[j, first] * rat ** 3

        # f = dlnD/dlna by centered differences on the a grid
        # (cosmo.c:1381-1417)
        def fomega_of(g):
            f = np.zeros_like(g)
            for i in range(today):
                i1, i2 = (0, 2) if i == 0 else (i - 1, i + 1)
                f[:, i] = ((g[:, i2] - g[:, i1])
                           / (agrid[i2] - agrid[i1]) * agrid[i] / g[:, i])
            slope = ((f[:, today - 1] - f[:, today - 2])
                     / (agrid[today - 1] - agrid[today - 2]))
            for i in range(today, nb):
                f[:, i] = (f[:, today - 1]
                           + slope * (agrid[i] - agrid[today - 1]))
            return f

        self.sd_grow = {1: g1, 2: g2, 31: g31, 32: g32}
        self.sd_fomega = {1: fomega_of(g1), 2: fomega_of(g2),
                          31: fomega_of(g31), 32: fomega_of(g32)}
        # per-bin splines of log10 D over log10 a, like SP_GROW1+j
        self._sd_spl_grow = {
            o: [_Spline(self._loga_grid, np.log10(self.sd_grow[o][j]))
                for j in range(NK_BINS)] for o in (1, 2, 31, 32)}
        self._sd_spl_fom = {
            o: [_Spline(self._loga_grid, self.sd_fomega[o][j])
                for j in range(NK_BINS)] for o in (1, 2, 31, 32)}
        self.kmin = 10.0 ** LOGKMIN
        self.kmax = 10.0 ** (LOGKMIN + (NK_BINS - 1) * DELTALOGK)
        self.scale_dep = True

    def _interp_growth(self, z, k, order, kind):
        """InterpolateGrowth (cosmo.c:1728-1755): linear interpolation in
        log10 k between the per-bin time splines."""
        spls = (self._sd_spl_grow if kind == "g" else self._sd_spl_fom)[order]
        x = -np.log10(1.0 + np.asarray(z, dtype=np.float64))
        k = np.asarray(k, dtype=np.float64)
        kc = np.clip(k, self.kmin, self.kmax)
        dk = (np.log10(kc) - LOGKMIN) / DELTALOGK
        kk = np.minimum(dk.astype(int), NK_BINS - 2)
        w = dk - kk
        if np.ndim(kk) == 0:
            lo = spls[int(kk)](x)
            hi = spls[int(kk) + 1](x)
        else:
            lo = np.empty(np.broadcast(x, kk).shape)
            hi = np.empty_like(lo)
            for j in np.unique(kk):
                m = kk == j
                lo[m] = spls[int(j)](np.broadcast_to(x, m.shape)[m])
                hi[m] = spls[int(j) + 1](np.broadcast_to(x, m.shape)[m])
        return (1.0 - w) * lo + w * hi

    # public growth API (cosmo.c:1789-1819); the k argument participates
    # only for scale-dependent growth
    def GrowingMode(self, z, k=0.0):
        if self.scale_dep:
            return 10.0 ** self._interp_growth(z, k, 1, "g")
        return 10.0 ** self.sp_grow1(-np.log10(1.0 + np.asarray(z)))

    def GrowingMode_2LPT(self, z, k=0.0):
        if self.scale_dep:
            return 10.0 ** self._interp_growth(z, k, 2, "g")
        return 10.0 ** self.sp_grow2(-np.log10(1.0 + np.asarray(z)))

    def GrowingMode_3LPT_1(self, z, k=0.0):
        if self.scale_dep:
            return -(10.0 ** self._interp_growth(z, k, 31, "g"))
        return -(10.0 ** self.sp_grow31(-np.log10(1.0 + np.asarray(z))))

    def GrowingMode_3LPT_2(self, z, k=0.0):
        if self.scale_dep:
            return 10.0 ** self._interp_growth(z, k, 32, "g")
        return 10.0 ** self.sp_grow32(-np.log10(1.0 + np.asarray(z)))

    def fomega(self, z, k=0.0):
        if self.scale_dep:
            return self._interp_growth(z, k, 1, "f")
        return self.sp_fom1(-np.log10(1.0 + np.asarray(z)))

    def fomega_2LPT(self, z, k=0.0):
        if self.scale_dep:
            return self._interp_growth(z, k, 2, "f")
        return self.sp_fom2(-np.log10(1.0 + np.asarray(z)))

    def fomega_3LPT_1(self, z, k=0.0):
        if self.scale_dep:
            return self._interp_growth(z, k, 31, "f")
        return self.sp_fom31(-np.log10(1.0 + np.asarray(z)))

    def fomega_3LPT_2(self, z, k=0.0):
        if self.scale_dep:
            return self._interp_growth(z, k, 32, "f")
        return self.sp_fom32(-np.log10(1.0 + np.asarray(z)))

    def InverseGrowingMode(self, D):
        """z at which the linear growing mode equals D (cosmo.c:1822-1832)."""
        return 1.0 / 10.0 ** self.sp_invgrow(np.log10(D)) - 1.0

    def CosmicTime(self, z):
        return 10.0 ** self.sp_time(-np.log10(1.0 + np.asarray(z)))

    def InverseCosmicTime(self, t):
        return 10.0 ** self.sp_invtime(np.log10(t))

    def ComovingDistance(self, z):
        return self.sp_comvdist(-np.log10(1.0 + np.asarray(z)))

    def DiameterDistance(self, z):
        return self.sp_diamdist(-np.log10(1.0 + np.asarray(z)))

    # ------------------------------------------------------------------
    # power spectrum (cosmo.c:953-1498)
    # ------------------------------------------------------------------
    def _init_power_spectrum(self):
        p = self.p
        fws = p.FileWithInputSpectrum
        self._pk_spline = None
        if fws in ("no", "EH"):
            self.WhichSpectrum = 1
        elif fws == "Efstathiou":
            self.WhichSpectrum = 3
        elif fws == "PowerLaw":
            self.WhichSpectrum = 4
        elif fws == "CAMBTable":
            self.WhichSpectrum = 5
            self._read_pk_table_from_camb()
        else:
            self.WhichSpectrum = 2
            self._read_pk_from_file()

    def _read_pk_from_file(self):
        """Tabulated k - P(k) file (read_Pk_from_file, cosmo.c:1085-1190)."""
        import os
        p = self.p
        path = p.FileWithInputSpectrum
        if not os.path.isabs(path):
            path = os.path.join(p.work_dir, path)
        data = np.loadtxt(path)
        k, pk = data[:, 0], data[:, 1]
        if k[0] < 0.0:   # old format: log k, log k^3 P(k)
            logk, logk3p = k, pk
        else:
            logk = np.log10(k)
            logk3p = np.log10(pk * k ** 3)
        logk = logk + math.log10(p.Hubble100)
        if p.InputSpectrum_UnitLength_in_cm != 0.0:
            logk = logk + math.log10(p.InputSpectrum_UnitLength_in_cm
                                     / UNITLENGTH_CM)
        self._pk_spline = _Spline(logk, logk3p)

    def _read_pk_table_from_camb(self):
        """z=0 CDM+baryon P(k) from CAMB table set (cosmo.c:1192-1336).
        The z=0 spectrum read here is exact; scale-dependent growth from
        the table ratios is built by `_init_scaledep_from_camb` (selected
        in __init__ when the CAMBTable spectrum is active)."""
        import glob
        import os
        p = self.p
        base = p.CAMBMatterFile
        if not os.path.isabs(base):
            base = os.path.join(p.work_dir, base)
        files = sorted(glob.glob(base + "_*.dat"))
        if not files:
            raise FileNotFoundError(f"no CAMB files matching {base}_*.dat")
        data = np.loadtxt(files[-1])   # last index = z=0
        kappa, pk = data[:, 0], data[:, 1]   # k in h/Mpc, P in (Mpc/h)^3
        logk = np.log10(kappa * p.Hubble100)
        logk3p = np.log10(kappa ** 3 * pk)
        self._pk_spline = _Spline(logk, logk3p)

    def PowerSpectrum(self, k):
        """P(k); k in true 1/Mpc, output Mpc^3 (cosmo.c:953-1007)."""
        p = self.p
        k = np.asarray(k, dtype=np.float64)
        if self.WhichSpectrum == 1:
            power = k ** p.PrimordialIndex * self.transf_EH(k) ** 2
        elif self.WhichSpectrum in (2, 5):
            power = 10.0 ** self._pk_spline(np.log10(k)) / k ** 3
        elif self.WhichSpectrum == 3:
            g = SHAPE_EFST
            power = (k ** p.PrimordialIndex /
                     (1 + (6.4 / g * k + (3.0 / g * k) ** 1.5
                           + (1.7 / g) ** 2 * k * k) ** 1.13) ** (2 / 1.13))
        elif self.WhichSpectrum == 4:
            power = k ** p.PrimordialIndex
        else:
            power = np.zeros_like(k)

        if p.WDM_PartMass_in_kev > 0.0:
            # Bode, Ostriker & Turok (2001), just after (A7) (cosmo.c:995-1003)
            alpha = (0.05 * ((p.Omega0 - p.OmegaBaryon) / 0.4) ** 0.15
                     * (p.Hubble100 / 0.65) ** 1.3
                     * (1.0 / p.WDM_PartMass_in_kev) ** 1.15)
            Tf = (1 + (alpha * k / p.Hubble100) ** 2) ** (-5.0)
            power = power * Tf * Tf
        return self.PkNorm * power

    def transf_EH(self, fk):
        """Eisenstein & Hu transfer function fit (cosmo.c:1452-1488)."""
        p = self.p
        fk = np.asarray(fk, dtype=np.float64)
        Teta_27 = 1.0104
        OB = max(p.OmegaBaryon, 1.e-6)
        Omegac = p.Omega0 - OB
        Oh2 = p.Omega0 * p.Hubble100 ** 2
        Ob2 = OB * p.Hubble100 ** 2
        b1 = 0.313 * Oh2 ** -0.419 * (1 + 0.607 * Oh2 ** 0.674)
        b2 = 0.238 * Oh2 ** 0.223
        zd = (1291.0 * Oh2 ** 0.251 * (1.0 + b1 * Ob2 ** b2)
              / (1.0 + 0.659 * Oh2 ** 0.828))
        Rd = 31.5 * Ob2 / (Teta_27 ** 4 * 0.001 * zd)
        zeq = 2.5e4 * Oh2 / Teta_27 ** 4
        Req = 31.5 * Ob2 / (Teta_27 ** 4 * 0.001 * zeq)
        keq = 7.46e-2 * Oh2 / Teta_27 ** 2
        s = (1.633 * math.log((math.sqrt(1.0 + Rd) + math.sqrt(Rd + Req))
                              / (1 + math.sqrt(Req))) / (keq * math.sqrt(Req)))
        ks = fk * s
        q = fk * Teta_27 ** 2 / Oh2
        alc = ((((46.9 * Oh2) ** 0.670 * (1.0 + (32.1 * Oh2) ** -0.532))
                ** (-OB / p.Omega0))
               * (((12.0 * Oh2) ** 0.424 * (1.0 + (45.0 * Oh2) ** -0.582))
                  ** (-(OB / p.Omega0) ** 3)))
        bec = 1.0 / (1.0 + (0.944 / (1.0 + (458.0 * Oh2) ** -0.708))
                     * ((Omegac / p.Omega0) ** ((0.395 * Oh2) ** -0.0266) - 1.0))
        f = 1.0 / (1 + (ks / 5.4) ** 4)

        def T0(q, a, b):
            ll = np.log(math.e + 1.8 * b * q)
            C = 14.2 / a + 386.0 / (1.0 + 69.9 * q ** 1.08)
            return ll / (ll + C * q * q)

        Tc = f * T0(q, 1.0, bec) + (1.0 - f) * T0(q, alc, bec)
        beb = (0.5 + OB / p.Omega0
               + (3.0 - 2.0 * OB / p.Omega0)
               * math.sqrt((17.2 * Oh2) ** 2 + 1.0))
        bno = 8.41 * Oh2 ** 0.435
        kst = ks / (1.0 + (bno / ks) ** 3) ** 0.3333
        ksi = 1.6 * Ob2 ** 0.52 * Oh2 ** 0.73 * (1.0 + (10.4 * Oh2) ** -0.95)
        y = (1.0 + zeq) / (1 + zd)
        alb = (2.07 * keq * s * (1.0 + Rd) ** -0.75
               * (y * (-6.0 * math.sqrt(1.0 + y)
                       + (2.0 + 3.0 * y)
                       * math.log((math.sqrt(1.0 + y) + 1.0)
                                  / (math.sqrt(1.0 + y) - 1.0)))))
        Tb = ((T0(q, 1.0, 1.0) / (1.0 + (ks / 5.2) ** 2)
               + alb / (1.0 + (beb / ks) ** 3) * np.exp(-(fk / ksi) ** 1.4))
              * np.sin(kst) / kst)
        return (OB * Tb + Omegac * Tc) / p.Omega0

    # ------------------------------------------------------------------
    # variances (cosmo.c:1507-1668)
    # ------------------------------------------------------------------
    @staticmethod
    def window(kr, wtype):
        kr = np.asarray(kr, dtype=np.float64)
        if wtype == GAUSSIAN:
            return np.exp(-0.5 * kr * kr)
        if wtype == SHARP_K:
            return np.where(kr < 1.0, 1.0, 0.0)
        kr2 = kr * kr
        with np.errstate(invalid="ignore", divide="ignore"):
            w = 3.0 * (np.sin(kr) / (kr2 * kr) - np.cos(kr) / kr2)
        return np.where(kr < 1.e-5, 1.0, w)

    def ComputeMassVariance(self, R, wtype):
        def integrand(logk):
            k = math.exp(logk)
            w = float(self.window(k * R, wtype))
            return self.PowerSpectrum(k) * w * w * k ** 3 / (2.0 * PI * PI)
        return quad(integrand, -10.0, math.log(500.0 / R),
                    epsabs=0.0, epsrel=TOLERANCE, limit=1000)[0]

    def ComputeDisplVariance(self, R, wtype):
        def integrand(logk):
            k = math.exp(logk)
            w = float(self.window(k * R, wtype))
            return self.PowerSpectrum(k) * w * w * k / (2.0 * PI * PI)
        return quad(integrand, -10.0, math.log(500.0 / R),
                    epsabs=0.0, epsrel=TOLERANCE, limit=1000)[0]

    def _normalize_power_spectrum(self):
        p = self.p
        if p.Sigma8 != 0.0 and self.WhichSpectrum != 5:
            self.PkNorm = (p.Sigma8 ** 2
                           / self.ComputeMassVariance(8.0 / p.Hubble100,
                                                      TOP_HAT))
        else:
            self.PkNorm = 1.0
            p.Sigma8 = math.sqrt(
                self.ComputeMassVariance(8.0 / p.Hubble100, TOP_HAT))

    def _batch_variances(self, radii, wtype):
        """sigma^2(R) and displacement variance for MANY radii at once:
        one vectorized trapezoid over a shared fine log-k grid replaces
        one adaptive scipy.quad per (radius, moment) — same integrand
        (cosmo.c:1555-1576), same per-radius upper limit kR <= 500
        (applied as a mask), ~1e-6 relative agreement with quad at ~40x
        the speed for the 420-bin spline tables."""
        radii = np.asarray(radii, dtype=np.float64)
        lkmin = -10.0
        lkmax = math.log(500.0 / radii.min())
        n = int((lkmax - lkmin) / 1.0e-3) + 2
        lk = np.linspace(lkmin, lkmax, n)
        k = np.exp(lk)
        pk = self.PowerSpectrum(k) / (2.0 * PI * PI)
        m3 = pk * k ** 3
        m1 = pk * k
        h = lk[1] - lk[0]
        mv = np.empty(len(radii))
        dv = np.empty(len(radii))
        step = max(1, 64_000_000 // (8 * n))       # ~64 MB work blocks
        for i0 in range(0, len(radii), step):
            R = radii[i0:i0 + step, None]
            kr = k[None, :] * R
            w2 = self.window(kr, wtype) ** 2
            w2[kr > 500.0] = 0.0
            mv[i0:i0 + step] = w2 @ m3 * h
            dv[i0:i0 + step] = w2 @ m1 * h
        return mv, dv

    def _init_mass_variance(self, wtype) -> VarianceTables:
        rmin, dr = -6.0, 0.04
        rv = rmin + np.arange(NBINS) * dr
        mv, dvv = self._batch_variances(10.0 ** rv, wtype)
        massvar = np.log10(mv)
        displv = np.log10(dvv)
        # enforce monotonicity exactly like the scalar loop
        # (cosmo.c:1528-1532 guards against flat sigma^2 bins)
        for i in range(NBINS - 2, -1, -1):
            if massvar[i] - massvar[i + 1] < 1.e-6:
                massvar[i] = massvar[i + 1] + 1.e-6
        dmvdr = np.gradient(massvar, rv)
        # match the reference's one-sided ends (cosmo.c:1534-1542)
        dmvdr[0] = (massvar[1] - massvar[0]) / dr
        dmvdr[-1] = (massvar[-1] - massvar[-2]) / dr
        return VarianceTables(
            window=wtype,
            massvar=_Spline(rv, massvar),
            radius=_Spline(-massvar, rv),
            dvardr=_Spline(rv, dmvdr),
            dispvar=_Spline(rv, displv))

    def SizeForMass(self, m, wtype=TOP_HAT):
        """Radius (Mpc) for mass (Msun), per window (cosmo.c:1867-1890)."""
        if wtype == GAUSSIAN:
            return (np.asarray(m) / (2.0 * PI) ** 1.5
                    / self.MatterDensity) ** (1.0 / 3.0)
        if wtype == SHARP_K:
            return (np.asarray(m) / (6.0 * PI * PI
                                     * self.MatterDensity)) ** (1.0 / 3.0)
        return (np.asarray(m) / (4.0 * PI * self.MatterDensity
                                 / 3.0)) ** (1.0 / 3.0)

    def MassForSize(self, size, wtype=TOP_HAT):
        if wtype == GAUSSIAN:
            return self.MatterDensity * (2.0 * PI) ** 1.5 * size ** 3
        if wtype == SHARP_K:
            return self.MatterDensity * 6.0 * PI * PI * size ** 3
        return self.MatterDensity * 4.0 * PI / 3.0 * size ** 3

    # ------------------------------------------------------------------
    # analytic mass functions (cosmo.c:1919-2013)
    # ------------------------------------------------------------------
    def dOmega_dVariance(self, v, z):
        amf = self.p.AnalyticMassFunction
        v = np.asarray(v, dtype=np.float64)
        sv = np.sqrt(v)
        ni = DELTA_C / sv
        SQRT2PI = 0.39894228
        if amf == 0:    # Press & Schechter
            return 2.0 * np.exp(-0.5 * ni * ni) * ni * SQRT2PI
        if amf == 1:    # Sheth & Tormen
            ni2 = math.sqrt(0.707) * ni
            return (2.0 * 0.3222 * SQRT2PI * ni2 * np.exp(-0.5 * ni2 * ni2)
                    * (1.0 + ni2 ** -0.6))
        if amf == 2:    # Jenkins et al.
            return 0.315 * np.exp(-np.abs(-np.log(sv) + 0.61) ** 3.8)
        if amf == 3:    # Warren et al. 2006
            return 0.7234 * (sv ** -1.625 + 0.2538) * np.exp(-1.1982 / v)
        if amf == 4:    # Reed et al. 2007
            ni2 = math.sqrt(0.707) * ni
            return (2.0 * 0.3222 * SQRT2PI * ni2 * np.exp(-0.54 * ni2 * ni2)
                    * (1.0 + ni2 ** -0.6
                       + 0.2 * np.exp(-((-np.log(sv) - 0.4) ** 2) / 0.72)))
        if amf == 5:    # Crocce et al. 2010
            onepz = min(1.0 + z, 2.0)
            return (0.58 * onepz ** -0.13
                    * (sv ** (-1.37 * onepz ** -0.15)
                       + 0.3 * onepz ** -0.084)
                    * np.exp(-1.036 * onepz ** -0.024 / v))
        if amf == 6:    # Tinker et al. 2010
            onepz = min(1.0 + z, 3.5)
            return (0.186 * onepz ** -0.14
                    * ((2.57 * onepz ** -0.569558118758974 / sv)
                       ** (1.47 * onepz ** -0.06) + 1.0)
                    * np.exp(-1.19 / v))
        if amf == 7:    # Courtin et al. 2010
            ni2 = math.sqrt(0.695) * 1.673 / sv
            return (0.348 * 2.0 * SQRT2PI * ni2
                    * (1.0 + (1.0 / ni2 / ni2) ** 0.1)
                    * np.exp(-ni2 * ni2 / 2.0))
        if amf == 8:    # Angulo et al. 2012
            return (0.201 * ((ni * 2.08 / DELTA_C) ** 1.7 + 1.0)
                    * np.exp(-1.172 * ni * ni / DELTA_C ** 2))
        if amf == 9:    # Watson et al. 2013
            return (0.282 * ((ni * 1.406 / DELTA_C) ** 2.163 + 1.0)
                    * np.exp(-1.210 * ni * ni / DELTA_C ** 2))
        if amf == 10:   # Crocce et al. 2010, forced universality
            return 0.58 * (sv ** -1.37 + 0.3) * np.exp(-1.036 / v)
        return np.zeros_like(v)

    def AnalyticMassFunction(self, mass, z):
        """n(m) per (Msun Mpc^3) (cosmo.c:2005-2013); top-hat window."""
        r = self.SizeForMass(mass, TOP_HAT)
        D = self.GrowingMode(z, self.p.k_for_GM)
        return (self.MatterDensity
                * self.dOmega_dVariance(self.var_tophat.MassVariance(r)
                                        * D * D, z)
                * np.abs(self.var_tophat.dMassVariance_dr(r) / 6.0)
                / mass / mass)

    # ------------------------------------------------------------------
    # cosmology.out writer (cosmo.c:440-499)
    # ------------------------------------------------------------------
    def write_cosmology_file(self, directory="."):
        import os
        p = self.p
        path = os.path.join(directory, f"pinocchio.{p.RunFlag}.cosmology.out")
        la = self._loga_grid
        with open(path, "w") as fd:
            fd.write(f"# Cosmological quantities used in PINOCCHIO "
                     f"(h={p.Hubble100:f})\n")
            for line in ("# TIME-DEPENDENT QUANTITIES", "# 1: scale factor",
                         "# 2: cosmic time (Gyr)",
                         "# 3: comoving distance (Mpc)",
                         "# 4: diameter distance (Mpc)", "# 5: Omega matter",
                         "# 6: dark energy EOS", "# 7: linear growth rate",
                         "# 8: 2nd-order growth rate",
                         "# 9: first 3rd-order growth rate",
                         "#10: second 3rd-order growth rate",
                         "#11: linear d ln D/d ln a",
                         "#12: 2nd-order d ln D/d ln a",
                         "#13: first 3rd-order d ln D/d ln a",
                         "#14: second 3rd-order d ln D/d ln a",
                         "# SCALE-DEPENDENT QUANTITIES",
                         "#15: smoothing scale (Mpc)", "#16: mass variance",
                         "#17: variance of displacements",
                         "#18: d Log sigma^2 / d Log R", "# POWER SPECTRUM",
                         "#19: k (true Mpc^-1)", "#20: P(k)", "#"):
                fd.write(line + "\n")
            rv = -6.0 + np.arange(NBINS) * 0.04
            for i in range(NBINS):
                a = 10.0 ** la[i]
                z = 1.0 / a - 1.0
                k = 10.0 ** (-4.0 + i / NBINS * 6.0)
                eos = (-1 if self.simpleLambda
                       else self.DE_EquationOfState(a))
                row = (a, self.CosmicTime(z),
                       float(self.sp_comvdist.y[i]) if i < NBINS - NBB else 0.0,
                       float(self.sp_diamdist.y[i]) if i < NBINS - NBB else 0.0,
                       self.OmegaMatter(z), eos,
                       self.GrowingMode(z), self.GrowingMode_2LPT(z),
                       -self.GrowingMode_3LPT_1(z), self.GrowingMode_3LPT_2(z),
                       self.fomega(z), self.fomega_2LPT(z),
                       self.fomega_3LPT_1(z), self.fomega_3LPT_2(z),
                       10.0 ** rv[i],
                       10.0 ** float(self.var_gauss.massvar.y[i]),
                       10.0 ** float(self.var_gauss.dispvar.y[i]),
                       float(self.var_gauss.dvardr.y[i]),
                       k, float(self.PowerSpectrum(k)))
                fd.write(" " + " ".join(f"{x:12g}" for x in row) + "\n")
        return path


@dataclass
class GrowthTables:
    """Dense float tables of growth quantities for the JAX compute path."""
    log10_D: np.ndarray         # log10 D1 on the a-grid
    log10_a: np.ndarray         # log10 a grid (monotonic)

    @classmethod
    def from_cosmology(cls, cosmo: Cosmology):
        return cls(log10_D=np.asarray(cosmo.sp_grow1.y, dtype=np.float64),
                   log10_a=np.asarray(cosmo._loga_grid, dtype=np.float64))
