"""Past-light-cone geometry and output (the port's copy of
pinocchio_tpu/plc.py, host numpy and scipy).

Re-implements the reference's PLC setup (set_plc, initialization.c:543-776):
cone vertex/axis/frame, the list of box replications whose cube intersects
the cone shell between the starting and final redshifts
(cone_and_cube_intersect, initialization.c:805-918), the F1/F2 redshift
bounds per replication, the geometry file, n(z) binning, and the analytic
halo-count prediction (compute_Nhalos_in_PLC, fragment.c:922-950).

The on-the-fly crossing detection itself runs inside the native group sweep
(native/groupsweep.c); this module prepares its inputs and writes
pinocchio.<run>.plc.out / .nz.out / .geometry.out.
"""

from __future__ import annotations

import ctypes
import math
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .config import Params
from .cosmology import Cosmology
from .io.catalogs import _fastio, _ptr, _write_record

NSAFE = 2.0


def max_cos_on_edge(P, V, U, D, L):
    """Largest cosine between the cone axis D and the line joining vertex V
    to a point of the segment P + t*U, t in [0, L] (maxF,
    initialization.c:778-803)."""
    P = np.asarray(P, float)
    dP = np.linalg.norm(P - V)
    if dP == 0.0:
        return 1.0
    cosDU = float(np.dot(D, U))
    cosDP = float(np.dot(D, P - V)) / dP
    cosUP = float(np.dot(U, P - V)) / dP
    if cosDP - cosDU * cosUP == 0.0:
        return 0.0
    tmax = (cosDU - cosDP * cosUP) / (cosDP - cosDU * cosUP)
    tmax = min(max(tmax, 0.0), L / dP)
    return (cosDP + tmax * cosDU) / math.sqrt(
        1.0 + tmax * tmax + 2.0 * tmax * cosUP)


def cone_and_cube_intersect(Oc, L, V, D, theta):
    """Does the cone (vertex V, axis D, semi-aperture theta deg) intersect
    the axis-aligned cube at Oc with edges L?  Returns
    (code, rmin, rmax, axis_bits); code 0 = no intersection.
    Port of initialization.c:805-918."""
    Oc = np.asarray(Oc, float)
    L = np.asarray(L, float)
    V = np.asarray(V, float)
    D = np.asarray(D, float)

    corners = Oc + L * np.array(np.meshgrid([0, 1], [0, 1], [0, 1],
                                            indexing="ij")
                                ).reshape(3, -1).T
    rmax = float(np.max(np.linalg.norm(corners - V, axis=1)))

    rmin = 1.e32
    axis = 0
    for dim in range(3):
        d1, d2 = (dim + 1) % 3, (dim + 2) % 3
        for i in range(2):
            proj = Oc[dim] - V[dim] + i * L[dim]
            r = proj * proj
            if V[d1] < Oc[d1]:
                r += (V[d1] - Oc[d1]) ** 2
            elif V[d1] >= Oc[d1] + L[d1]:
                r += (V[d1] - Oc[d1] - L[d1]) ** 2
            if V[d2] < Oc[d2]:
                r += (V[d2] - Oc[d2]) ** 2
            elif V[d2] >= Oc[d2] + L[d2]:
                r += (V[d2] - Oc[d2] - L[d2]) ** 2
            rmin = min(rmin, math.sqrt(r))

            if D[dim] != 0.0:
                x = proj / D[dim]
                if (x > 0.0
                        and Oc[d1] <= V[d1] + x * D[d1] < Oc[d1] + L[d1]
                        and Oc[d2] <= V[d2] + x * D[d2] < Oc[d2] + L[d2]):
                    axis += 1 << (dim + i * 3)

    if np.all((V >= Oc) & (V < Oc + L)):
        return 1, 0.0, rmax, axis
    if theta >= 180.0:
        return 2, rmin, rmax, axis
    if axis:
        return 3, rmin, rmax, axis

    costh = math.cos(theta / 180.0 * math.pi)
    Fmax = -10.0
    for ijk in np.ndindex(2, 2, 2):
        for dim in range(3):
            if ijk[dim]:
                continue
            U = np.zeros(3)
            U[dim] = 1.0
            P = Oc + np.array(ijk) * L
            F = max_cos_on_edge(P, V, U, D, L[dim]) - costh
            Fmax = max(Fmax, F)
    if Fmax > 0:
        return 4, rmin, rmax, axis
    return 0, rmin, rmax, axis


@dataclass
class PlcGeometry:
    enabled: bool
    Fstart: float = -1.0
    Fstop: float = -1.0
    center: np.ndarray = None            # grid units
    zvers: np.ndarray = None
    xvers: np.ndarray = None
    yvers: np.ndarray = None
    repls_ijk: np.ndarray = None         # [n,3] int
    repls_F1: np.ndarray = None          # [n]
    repls_F2: np.ndarray = None
    nzbins: int = 0
    delta_z: float = 0.05
    Nmax: int = 0
    geometry_rows: List = field(default_factory=list)


def build_plc_geometry(params: Params, cosmo: Cosmology,
                       verbose: bool = True) -> PlcGeometry:
    if not params.plc_enabled or params.StartingzForPLC < 0.0:
        return PlcGeometry(enabled=False)

    z_start = max(params.StartingzForPLC, params.LastzForPLC)
    z_last = min(params.StartingzForPLC, params.LastzForPLC)
    N = params.GridSize

    if params.PLCProvideConeData:
        center = np.array(params.PLCCenter, float) / params.BoxSize * N
        zvers = np.array(params.PLCAxis, float)
    else:
        # reference draws these from the GSL chain (initialization.c:591-599)
        rng = np.random.default_rng(params.RandomSeed)
        center = rng.uniform(0, N, 3)
        mytheta = math.acos(2 * rng.uniform() - 1)
        myphi = rng.uniform() * 2 * math.pi
        zvers = np.array([math.sin(mytheta) * math.cos(myphi),
                          math.sin(mytheta) * math.sin(myphi),
                          math.cos(mytheta)])
    zvers = zvers / np.linalg.norm(zvers)

    if zvers[2] == 1.0:
        xvers = np.array([1.0, 0.0, 0.0])
        yvers = np.array([0.0, 1.0, 0.0])
    else:
        mod = math.hypot(zvers[0], zvers[1])
        xvers = np.array([zvers[1] / mod, -zvers[0] / mod, 0.0])
        yvers = np.cross(zvers, xvers)

    NAll = int(cosmo.ComovingDistance(z_start)
               / params.BoxSize_htrue) + 2
    Fstart = 1.0 + z_start
    Fstop = 1.0 + z_last
    ipd = params.InterPartDist

    largest_r = float(cosmo.ComovingDistance(z_start)) / ipd
    smallest_r = float(cosmo.ComovingDistance(z_last)) / ipd
    displ_var = math.sqrt(float(cosmo.var_gauss.DisplVariance(ipd))) / ipd
    smallest_r -= NSAFE * float(cosmo.GrowingMode(z_last)) * displ_var
    smallest_r = max(smallest_r, 0.0)
    largest_r += NSAFE * float(cosmo.GrowingMode(z_start)) * displ_var

    L = np.array([N, N, N], float)
    rows = []
    ijk, D1, D2 = [], [], []
    for ir in range(-NAll, NAll + 1):
        for jr in range(-NAll, NAll + 1):
            for kr in range(-NAll, NAll + 1):
                Oc = np.array([ir, jr, kr]) * L
                code, rmin, rmax, axis = cone_and_cube_intersect(
                    Oc, L, center, zvers, params.PLCAperture)
                if code and not (rmin > largest_r or rmax < smallest_r):
                    rows.append((len(rows), ir, jr, kr, rmin, rmax,
                                 code, axis))
                    ijk.append((ir, jr, kr))
                    D1.append(rmax)       # distance bounds, converted below
                    D2.append(rmin)

    n = len(ijk)
    F1 = np.full(n, -1.0)
    F2 = np.full(n, -1.0)
    D1 = np.asarray(D1, float)
    D2 = np.asarray(D2, float)
    # distance -> F conversion by scanning z downwards
    # (initialization.c:708-730); each replication takes the first z at
    # which its bound is crossed
    for z in np.arange(100.0, -0.005, -0.01):
        tdis = NSAFE * float(cosmo.GrowingMode(z)) * displ_var
        d = float(cosmo.ComovingDistance(z)) / ipd
        F1[(F1 <= 0.0) & (d < D1 + tdis)] = z + 0.01 + 1.0
        F2[(F2 <= 0.0) & (d < D2 - tdis)] = z + 1.0
    F1[F1 <= 0.0] = 1.0
    F2[F2 <= 0.0] = 1.0

    delta_z = 0.05
    nzbins = int((z_start - z_last) / delta_z + 0.1)
    Nmax = int(N ** 3 / 6 * params.PredPeakFactor)

    if verbose:
        print(f"  PLC: z in [{z_last}, {z_start}], {n} replications, "
              f"{nzbins} n(z) bins")

    return PlcGeometry(enabled=True, Fstart=Fstart, Fstop=Fstop,
                       center=center, zvers=zvers, xvers=xvers, yvers=yvers,
                       repls_ijk=np.array(ijk, np.int32).reshape(n, 3),
                       repls_F1=F1, repls_F2=F2, nzbins=nzbins,
                       delta_z=delta_z, Nmax=Nmax, geometry_rows=rows)


def write_geometry(params: Params, geom: PlcGeometry, smallest_r, largest_r,
                   directory="."):
    path = os.path.join(directory,
                        f"pinocchio.{params.RunFlag}.geometry.out")
    N = params.GridSize
    with open(path, "w") as fd:
        nch = len(geom.geometry_rows)
        fd.write(f"# N. replications: {len(geom.repls_ijk)}\n")
        fd.write(f"# distance range: {smallest_r:10.6f} {largest_r:10.6f}\n")
        c = geom.center
        fd.write(f"# V   = {c[0]:10.6f} {c[1]:10.6f} {c[2]:10.6f}\n")
        d = geom.zvers
        fd.write(f"# D   = {d[0]:10.6f} {d[1]:10.6f} {d[2]:10.6f}\n")
        fd.write(f"# L   = {float(N):10.6f} {float(N):10.6f} "
                 f"{float(N):10.6f}\n")
        fd.write(f"# A   = {params.PLCAperture:10.6f}\n")
        fd.write(f"# IPD = {params.InterPartDist:10.6f}\n#\n")
        for row in geom.geometry_rows:
            fd.write(" %3d  %3d %3d %3d   %10.6f %10.6f   %d  %d\n" % row)
    return path


def compute_nhalos_prediction(params: Params, cosmo: Cosmology,
                              z1: float, z2: float) -> float:
    """Analytic halo count in the cone between z1 and z2
    (compute_Nhalos_in_PLC, fragment.c:922-950).

    Same 0.01-z sub-stepping as the reference, but the inner mass integral
    runs as one vectorized Simpson rule over a fixed log-m grid per
    sub-step (the integrand is a smooth spline product, so ~500 nodes
    match the reference's adaptive QAGS to ~1e-4) instead of thousands of
    scalar spline calls — the n(z) file cost drops from seconds to ms."""
    from scipy.integrate import simpson
    min_logm = math.log(params.ParticleMass * params.MinHaloMass)
    aperture = min(params.PLCAperture, 90.0)
    solidangle = (1 - math.cos(aperture / 180.0 * math.pi)) * 2.0 * math.pi
    lowers = np.arange(z1, z2, 0.01)
    if len(lowers) == 0:
        return 0.0
    uppers = np.minimum(lowers + 0.01, z2)
    lm = np.linspace(min_logm, 37.0, 513)
    m = np.exp(lm)
    number = 0.0
    dlo = np.asarray(cosmo.ComovingDistance(lowers), np.float64)
    dhi = np.asarray(cosmo.ComovingDistance(uppers), np.float64)
    for i in range(len(lowers)):
        myz = 0.5 * (uppers[i] + lowers[i])
        res = simpson(m * np.asarray(
            cosmo.AnalyticMassFunction(m, myz), np.float64), x=lm)
        number += res * solidangle * (dhi[i] ** 3 - dlo[i] ** 3) / 3.0
    return number


def write_plc_catalog(params: Params, geom: PlcGeometry, plc_data: dict,
                      directory=".") -> str:
    """pinocchio.<run>.plc.out (write_PLC, write_halos.c:481-663)."""
    hfac = params.Hubble100 if params.OutputInH100 else 1.0
    path = os.path.join(directory, f"pinocchio.{params.RunFlag}.plc.out")
    n = len(plc_data["z"])
    x = plc_data["x"]                    # [n,3] true Mpc
    v = plc_data["v"]
    rho = np.linalg.norm(x, axis=1)
    safe_rho = np.where(rho > 0, rho, 1.0)
    ct = x @ geom.zvers / safe_rho
    theta = np.where(rho > 0,
                     -np.degrees(np.arccos(np.clip(ct, -1, 1))) + 90.0,
                     90.0)
    phi = np.where(rho > 0,
                   np.degrees(np.arctan2(x @ geom.yvers, x @ geom.xvers)),
                   0.0)
    phi = np.where(phi < 0, phi + 360.0, phi)
    v_los = np.einsum("ij,ij->i", x, v) / safe_rho
    obsz = plc_data["z"] + v_los / 299792.458 * (1.0 + plc_data["z"])
    M = plc_data["mass"] * params.ParticleMass * hfac

    if params.CatalogInAscii:
        with open(path, "w") as fd:
            mh = params.MinHaloMass
            fd.write(f"# Group catalog on the Past Light Cone for a minimal "
                     f"mass of {mh} particle{'' if mh == 1 else 's'}\n")
            labh = "/h" if params.OutputInH100 else ""
            for line in ("#    1) group ID", "#    2) true redshift",
                         f"#  3-5) comoving position (Mpc{labh})",
                         "#  6-8) velocity (km/s)",
                         f"#    9) group mass (Msun{labh})",
                         "#   10) theta (degree)", "#   11) phi (degree)",
                         "#   12) peculiar velocity along the line-of-sight "
                         "(km/s)", "#   13) observed redshift", "#"):
                fd.write(line + "\n")
        cols = np.column_stack([
            plc_data["z"], x * hfac, v, M, theta, phi, v_los, obsz
        ]).astype(np.float64)
        name = np.ascontiguousarray(plc_data["name"], np.uint64)
        rc = _fastio().plc_rows(path.encode(), n,
                                _ptr(name, ctypes.c_uint64),
                                _ptr(np.ascontiguousarray(cols),
                                     ctypes.c_double))
        if rc != 0:
            raise OSError(f"plc_rows failed for {path}")
    else:
        dtype = np.dtype([("name", "<u8"), ("red", "<f4"), ("x", "<f4"),
                          ("y", "<f4"), ("z", "<f4"), ("vx", "<f4"),
                          ("vy", "<f4"), ("vz", "<f4"), ("Mass", "<f4"),
                          ("theta", "<f4"), ("phi", "<f4"),
                          ("v_los", "<f4"), ("obsz", "<f4")])
        rec = np.zeros(n, dtype)
        rec["name"] = plc_data["name"]
        rec["red"] = plc_data["z"]
        rec["x"], rec["y"], rec["z"] = (x * hfac).T
        rec["vx"], rec["vy"], rec["vz"] = v.T
        rec["Mass"] = M
        rec["theta"] = theta
        rec["phi"] = phi
        rec["v_los"] = v_los
        rec["obsz"] = obsz
        with open(path, "wb") as fd:
            _write_record(fd, np.array([dtype.itemsize], "<i4"))
            _write_record(fd, np.array([n], "<i4"))
            _write_record(fd, rec)
    return path


def write_nz(params: Params, cosmo: Cosmology, geom: PlcGeometry,
             nz: np.ndarray, directory=".") -> str:
    """pinocchio.<run>.nz.out (write_halos.c:824-855)."""
    z_start = max(params.StartingzForPLC, params.LastzForPLC)
    z_last = min(params.StartingzForPLC, params.LastzForPLC)
    path = os.path.join(directory, f"pinocchio.{params.RunFlag}.nz.out")
    aperture = min(params.PLCAperture, 90.0)
    skyarea = ((1 - math.cos(aperture / 180.0 * math.pi)) * 2.0 * math.pi
               * (180.0 / math.pi) ** 2)
    with open(path, "w") as fd:
        for line in ("# 1) lower z for bin", "# 2) upper z for bin",
                     "# 3) number of objects in bin",
                     "# 4) number per square degree",
                     "# 5) prediction for number of objects in bin", "#"):
            fd.write(line + "\n")
        for ibin in range(geom.nzbins):
            zlow = z_last + ibin * geom.delta_z
            zhigh = z_last + (ibin + 1) * geom.delta_z
            if ibin == geom.nzbins - 1:
                zhigh = z_start
            pred = compute_nhalos_prediction(params, cosmo, zlow, zhigh)
            fd.write("%8.3f %8.3f %12g %8.3f %12g\n"
                     % (zlow, zhigh, nz[ibin], nz[ibin] / skyarea, pred))
    return path
