"""Catalog, mass-function and merger-history writers (counterpart of
pinocchio_tpu/io/catalogs.py).

File formats are byte/column compatible with the reference
(write_halos.c): ascii layouts match the fprintf formats; binary files use
the fortran-unformatted record scheme with int32 record markers that
scripts/ReadPinocchio5.py parses.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .. import native
from ..config import Params
from ..cosmology import Cosmology

from ..fragment.driver import CatalogSnapshot, GroupState

DELTAM = 0.05

# catalog_data layout (pinocchio.h:515-524): u64 name; f32 M, x[3], v[3],
# q[3]; i32 n, pad
CATALOG_DTYPE = np.dtype([("name", "<u8"), ("M", "<f4"),
                          ("x", "<f4", 3), ("v", "<f4", 3), ("q", "<f4", 3),
                          ("n", "<i4"), ("pad", "<i4")])
# -DLIGHT_OUTPUT record (write_halos.c:292-299; ReadPinocchio5.py's
# record_length==48 branch): no particle count, no padding
CATALOG_LIGHT_DTYPE = np.dtype([("name", "<u8"), ("M", "<f4"),
                                ("x", "<f4", 3), ("v", "<f4", 3),
                                ("q", "<f4", 3)])

# histories_data layout (pinocchio.h:454-459)
HISTORIES_DTYPE = np.dtype([("name", "<u8"), ("nick", "<i4"), ("ll", "<i4"),
                            ("mw", "<i4"), ("mass", "<i4"), ("mam", "<i4"),
                            ("zme", "<f4"), ("zpe", "<f4"), ("zap", "<f4")])


def _fastio():
    """Native row formatters and the merger-tree walk (native/fastio.c),
    built with cc at first use like the group sweep."""
    import ctypes
    lib = native.load("fastio")
    if not getattr(lib, "_sigs_set", False):
        i64, i32, u64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64
        p = ctypes.POINTER
        lib.catalog_rows.restype = ctypes.c_int
        lib.catalog_rows.argtypes = [
            ctypes.c_char_p, i64, p(u64), p(ctypes.c_float),
            p(ctypes.c_float), p(ctypes.c_float), p(ctypes.c_float), p(i32)]
        lib.plc_rows.restype = ctypes.c_int
        lib.plc_rows.argtypes = [ctypes.c_char_p, i64, p(u64),
                                 p(ctypes.c_double)]
        lib.histories_build.restype = i64
        lib.histories_build.argtypes = [
            i64, i32, p(i32), p(u64), p(i32), p(i32), p(i32), p(i32),
            p(ctypes.c_float), p(ctypes.c_float), p(ctypes.c_float),
            p(ctypes.c_uint8),
            p(u64), p(i32), p(i32), p(i32), p(i32), p(i32),
            p(ctypes.c_float), p(ctypes.c_float), p(ctypes.c_float),
            p(i32), p(i32), p(i64)]
        lib.histories_rows.restype = ctypes.c_int
        lib.histories_rows.argtypes = [
            ctypes.c_char_p, i64, p(i32), p(u64), p(i32), p(i32), p(i32),
            p(i32), p(i32), p(ctypes.c_float), p(ctypes.c_float),
            p(ctypes.c_float)]
        lib._sigs_set = True
    return lib


def _ptr(arr, ctype):
    import ctypes
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def largest_halo_mass(params: Params, cosmo: Cosmology) -> float:
    """Largest halo expected in the box (set_subboxes,
    initialization.c:940-948)."""
    m = 1.e18
    cc = 1.0 / params.BoxSize_htrue ** 3
    while cosmo.AnalyticMassFunction(m, params.zlast) * m < cc:
        m *= 0.99
        if m < 1e6:
            break
    return m


def _catalog_filename(params: Params, z: float, kind: str = "catalog"):
    return f"pinocchio.{z:6.4f}.{params.RunFlag}.{kind}.out"


def convert_catalog_units(params: Params, snap: CatalogSnapshot):
    """Grid-unit capture -> physical output units (write_catalog,
    write_halos.c:283-318)."""
    hfac = params.Hubble100 if params.OutputInH100 else 1.0
    G = float(params.GridSize)
    q = np.mod(snap.q, G) * params.InterPartDist * hfac
    x = np.mod(snap.x, G) * params.InterPartDist * hfac
    M = snap.mass * params.ParticleMass * hfac
    return M.astype(np.float32), q.astype(np.float32), \
        x.astype(np.float32), snap.v


def write_catalog(params: Params, snap: CatalogSnapshot,
                  directory: str = ".") -> str:
    """NumFiles > 1 splits the catalog into .out.<i> chunks like the
    reference's collector scheme (write_halos.c:194-225)."""
    if params.NumFiles > 1:
        import dataclasses
        nf = params.NumFiles
        edges = np.linspace(0, len(snap.mass), nf + 1).astype(int)
        paths = []
        base = _catalog_filename(params, snap.z)
        for i in range(nf):
            sl = slice(edges[i], edges[i + 1])
            sub = CatalogSnapshot(z=snap.z, name=snap.name[sl],
                                  mass=snap.mass[sl], q=snap.q[sl],
                                  x=snap.x[sl], v=snap.v[sl])
            p1 = dataclasses.replace(params, NumFiles=1)
            pth = write_catalog(p1, sub, directory)
            os.replace(pth, os.path.join(directory, f"{base}.{i}"))
            paths.append(f"{base}.{i}")
        return os.path.join(directory, paths[0])
    M, q, x, v = convert_catalog_units(params, snap)
    path = os.path.join(directory, _catalog_filename(params, snap.z))
    n = len(M)
    if params.CatalogInAscii:
        with open(path, "w") as fd:
            mh = params.MinHaloMass
            fd.write(f"# Group catalog for redshift {snap.z:f} and minimal "
                     f"mass of {mh} particle{'' if mh == 1 else 's'}\n")
            labh = "/h" if params.OutputInH100 else ""
            fd.write(f"#    1) group ID\n")
            fd.write(f"#    2) group mass (Msun{labh})\n")
            fd.write(f"# 3- 5) initial position (Mpc{labh})\n")
            fd.write(f"# 6- 8) final position (Mpc{labh})\n")
            fd.write(f"# 9-11) velocity (km/s)\n")
            fd.write(f"#   12) number of particles\n")
            fd.write("#\n")
        import ctypes
        lib = _fastio()
        name = np.ascontiguousarray(snap.name, np.uint64)
        npart = np.ascontiguousarray(snap.mass, np.int32)
        qc = np.ascontiguousarray(q, np.float32)
        xc = np.ascontiguousarray(x, np.float32)
        vc = np.ascontiguousarray(v, np.float32)
        rc = lib.catalog_rows(
            path.encode(), n, _ptr(name, ctypes.c_uint64),
            _ptr(np.ascontiguousarray(M, np.float32), ctypes.c_float),
            _ptr(qc, ctypes.c_float), _ptr(xc, ctypes.c_float),
            _ptr(vc, ctypes.c_float), _ptr(npart, ctypes.c_int32))
        if rc != 0:
            raise OSError(f"catalog_rows failed for {path}")
    else:
        dt = CATALOG_LIGHT_DTYPE if params.light_output else CATALOG_DTYPE
        rec = np.zeros(n, dt)
        rec["name"] = snap.name
        rec["M"] = M
        rec["x"] = x
        rec["v"] = v
        rec["q"] = q
        if not params.light_output:
            rec["n"] = snap.mass
        with open(path, "wb") as fd:
            _write_record(fd, np.array([1, dt.itemsize], "<i4"))
            _write_record(fd, np.array([n], "<i4"))
            if n:
                _write_record(fd, rec)
    return path


def _write_record(fd, arr: np.ndarray):
    marker = np.array([arr.nbytes], "<i4")
    marker.tofile(fd)
    arr.tofile(fd)
    marker.tofile(fd)


def mf_histogram(params: Params, snap: CatalogSnapshot,
                 largest: float) -> tuple:
    """The mass-function bin histograms (counts, summed mass) and the
    binning (compute_mf, write_halos.c:35-100)."""
    mmin = math.log10(params.MinHaloMass * params.ParticleMass) \
        - 0.001 * DELTAM
    mmax = math.log10(largest) + 3.0 * DELTAM
    nbin = int((mmax - mmin) / DELTAM) + 1
    amass = snap.mass.astype(np.float64) * params.ParticleMass
    ibin = ((np.log10(amass) - mmin) / DELTAM).astype(int)
    okbin = (ibin >= 0) & (ibin < nbin)
    ninbin = np.bincount(ibin[okbin], minlength=nbin)
    massinbin = np.bincount(ibin[okbin], weights=amass[okbin],
                            minlength=nbin)
    return ninbin, massinbin, mmin, nbin


def reduce_parts(final_path: str, host_id: int, nhosts: int,
                 arrays: dict):
    """The cross-host sum of small arrays through part files (the collector
    reduce of write_halos.c:35-225 over a shared filesystem): writes this
    host's arrays as <final_path>.part<h>.npz; when all nhosts parts are
    there, loads and sums them, removes the parts and returns the sums,
    which the caller writes as the final file.  Returns None while other
    hosts' parts are pending (the last host to land merges; two that
    finish together would write identical files)."""
    part = f"{final_path}.part{host_id}.npz"
    tmp = part + ".tmp"
    with open(tmp, "wb") as fd:
        np.savez(fd, **arrays)
    os.replace(tmp, part)
    paths = [f"{final_path}.part{h}.npz" for h in range(nhosts)]
    if not all(os.path.exists(p) for p in paths):
        return None
    merged = None
    try:
        for p in paths:
            with np.load(p) as d:
                if merged is None:
                    merged = {k: d[k].copy() for k in d.files}
                else:
                    for k in merged:
                        merged[k] = merged[k] + d[k]
    except FileNotFoundError:
        # another host that finished at the same moment merged first
        return None
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass
    return merged


def clear_stale_parts(directory: str, host_id: int) -> None:
    """Remove this host's part files left by an earlier run that failed,
    which would otherwise be summed into this run's reductions; called at
    the start of a run, before any output."""
    import glob
    for p in glob.glob(os.path.join(directory, f"*.part{host_id}.npz")):
        try:
            os.unlink(p)
        except OSError:
            pass


def compute_mf(params: Params, cosmo: Cosmology, snap: CatalogSnapshot,
               directory: str = ".", largest: float = None,
               hosts: tuple = None) -> str:
    """Halo mass function with Poisson errors + analytic fit
    (compute_mf, write_halos.c:35-192).  hosts=(h, H), H > 1: snap holds
    this host's halos; the bin histograms reduce across hosts through part
    files (reduce_parts) and the last host to land writes the file; the
    others return None."""
    hfac = params.Hubble100 if params.OutputInH100 else 1.0
    hfac4 = hfac ** 4
    vol = params.GridSize ** 3 * params.InterPartDist ** 3
    if largest is None:
        largest = largest_halo_mass(params, cosmo)
    ninbin, massinbin, mmin, nbin = mf_histogram(params, snap, largest)
    if hosts is not None and hosts[1] > 1:
        merged = reduce_parts(
            os.path.join(directory, _catalog_filename(params, snap.z, "mf")),
            hosts[0], hosts[1], dict(ninbin=ninbin, massinbin=massinbin))
        if merged is None:
            return None
        ninbin, massinbin = merged["ninbin"], merged["massinbin"]

    D = float(cosmo.GrowingMode(snap.z, params.k_for_GM))
    path = os.path.join(directory, _catalog_filename(params, snap.z, "mf"))
    names = {0: "Press & Schechter 1974", 1: "Sheth & Tormen 2001",
             2: "Jenkins et al. 2001", 3: "Warren et al. 2006",
             4: "Reed et al. 2007", 5: "Crocce et al. 2010",
             6: "Tinker et al. 2010", 7: "Courtin et al. 2010",
             8: "Angulo et al. 2012", 9: "Watson et al. 2013",
             10: "Crocce et al. 2010, universal"}
    with open(path, "w") as fd:
        lab1 = "/h" if params.OutputInH100 else ""
        lab2 = "h^4" if params.OutputInH100 else ""
        fd.write(f"# Mass function for redshift {snap.z:f}\n")
        fd.write(f"# 1) mass (Msun{lab1})\n")
        fd.write(f"# 2) n(m) (Mpc^-3 Msun^-1 {lab2})\n")
        fd.write(f"# 3) upper +1-sigma limit for n(m) (Mpc^-3 Msun^-1 "
                 f"{lab2})\n")
        fd.write(f"# 4) lower -1-sigma limit for n(m) (Mpc^-3 Msun^-1 "
                 f"{lab2})\n")
        fd.write("# 5) number of halos in the bin\n")
        fd.write(f"# 6) analytical n(m) from "
                 f"{names[params.AnalyticMassFunction]}\n")
        fd.write("#\n")
        pm = params.ParticleMass
        for i in range(nbin):
            x = mmin + (i + 0.5) * DELTAM
            m = 10.0 ** x
            dm = pm * (int(10.0 ** (mmin + (i + 1) * DELTAM) / pm)
                       - int(10.0 ** (mmin + i * DELTAM) / pm))
            if dm > 0.0:
                a = ninbin[i] / vol / dm
                a1 = (ninbin[i] + math.sqrt(ninbin[i])) / vol / dm
                a2 = (ninbin[i] - math.sqrt(ninbin[i])) / vol / dm
            else:
                a = a1 = a2 = 0.0
            mx = massinbin[i] / ninbin[i] if ninbin[i] > 1 else m
            a3 = float(cosmo.AnalyticMassFunction(mx, snap.z))
            r = float(cosmo.SizeForMass(mx))
            sigma = math.sqrt(float(cosmo.var_tophat.MassVariance(r))
                              * D * D)
            ni = 1.686 / sigma
            fd.write(" %15.8g %15.8g %15.8g %15.8g   %10d  %15.8g    "
                     "%15.8g\n" % (mx * hfac, a / hfac4, a1 / hfac4,
                                   a2 / hfac4, ninbin[i], a3 / hfac4, ni))
    return path


def build_histories_flat(groups: GroupState, min_halo_mass: int):
    """Native merger-tree walk: returns (treelen[i32], rec[HISTORIES_DTYPE])
    with branches laid out consecutively per tree."""
    import ctypes
    ng = groups.ngroups
    if ng == 0:
        return np.zeros(0, np.int32), np.zeros(0, HISTORIES_DTYPE)
    lib = _fastio()
    cap = ng + 1
    f4, i4, u8 = np.float32, np.int32, np.uint64
    o = dict(name=np.zeros(cap, u8), nick=np.zeros(cap, i4),
             ll=np.zeros(cap, i4), mw=np.zeros(cap, i4),
             mass=np.zeros(cap, i4), mam=np.zeros(cap, i4),
             zme=np.zeros(cap, f4), zpe=np.zeros(cap, f4),
             zap=np.zeros(cap, f4))
    treelen = np.zeros(cap, i4)
    trackC = np.zeros(cap, i4)
    nb_out = np.zeros(1, np.int64)

    def c(a, t):
        return _ptr(np.ascontiguousarray(a), t)

    cf, ci, cu = ctypes.c_float, ctypes.c_int32, ctypes.c_uint64
    g = groups
    ins = [c(np.asarray(g.mass, i4), ci), c(np.asarray(g.name, u8), cu),
           c(np.asarray(g.halo_app, i4), ci), c(np.asarray(g.ll, i4), ci),
           c(np.asarray(g.merged_with, i4), ci),
           c(np.asarray(g.mass_at_merger, i4), ci),
           c(np.asarray(g.t_appear, f4), cf),
           c(np.asarray(g.t_peak, f4), cf),
           c(np.asarray(g.t_merge, f4), cf),
           c(np.asarray(g.good, np.uint8), ctypes.c_uint8)]
    ntrees = lib.histories_build(
        ng, int(min_halo_mass), *ins,
        c(o["name"], cu), c(o["nick"], ci), c(o["ll"], ci), c(o["mw"], ci),
        c(o["mass"], ci), c(o["mam"], ci), c(o["zme"], cf),
        c(o["zpe"], cf), c(o["zap"], cf), c(treelen, ci), c(trackC, ci),
        _ptr(nb_out, ctypes.c_int64))
    nb = int(nb_out[0])
    rec = np.zeros(nb, HISTORIES_DTYPE)
    for k in o:
        rec[k] = o[k][:nb]
    return treelen[:ntrees], rec


def write_histories(params: Params, groups, directory: str = ".") -> str:
    """Merger histories of the main halos (write_histories,
    write_halos.c:897-1103), ascii or binary.  groups: a GroupState, or a
    list of them (one per sub-box), whose trees are written in order."""
    group_list = groups if isinstance(groups, list) else [groups]
    parts = [build_histories_flat(g, params.MinHaloMass) for g in group_list]
    treelen = np.concatenate([t for t, _ in parts])
    rec = np.concatenate([r for _, r in parts])
    ntrees = len(treelen)
    nbranch = len(rec)
    path = os.path.join(directory,
                        f"pinocchio.{params.RunFlag}.histories.out")
    if params.CatalogInAscii:
        with open(path, "w") as fd:
            mh = params.MinHaloMass
            fd.write(f"# Merger histories for halos with minimal mass of "
                     f"{mh} particle{'' if mh == 1 else 's'}\n")
            for line in ("#  1) group ID", "#  2) index within the tree",
                         "#  3) linking list", "#  4) merged with",
                         "#  5) mass of halo at merger (particles)",
                         "#  6) mass of main halo it merges with, at merger "
                         "(particles)",
                         "#  7) merger redshift",
                         "#  8) redshift of peak collapse",
                         "#  9) redshift at which the halo overtakes the "
                         "minimal mass", "#", "# Ntrees & Nbranches: "):
                fd.write(line + "\n")
            fd.write(f" {ntrees}  {nbranch}\n")
        import ctypes
        lib = _fastio()
        cols = {k: np.ascontiguousarray(rec[k]) for k in
                ("name", "nick", "ll", "mw", "mass", "mam",
                 "zme", "zpe", "zap")}
        cf, ci = ctypes.c_float, ctypes.c_int32
        rc = lib.histories_rows(
            path.encode(), ntrees,
            _ptr(np.ascontiguousarray(treelen), ci),
            _ptr(cols["name"], ctypes.c_uint64),
            _ptr(cols["nick"], ci), _ptr(cols["ll"], ci),
            _ptr(cols["mw"], ci), _ptr(cols["mass"], ci),
            _ptr(cols["mam"], ci), _ptr(cols["zme"], cf),
            _ptr(cols["zpe"], cf), _ptr(cols["zap"], cf))
        if rc != 0:
            raise OSError(f"histories_rows failed for {path}")
    else:
        with open(path, "wb") as fd:
            # exact fwrite sequence of write_histories
            # (write_halos.c:1035-1103): record-length record, global
            # (Ntrees, Nbranches) record, then one collector block =
            # [tree count][branches per tree][branch data]
            _write_record(fd, np.array([HISTORIES_DTYPE.itemsize], "<i4"))
            _write_record(fd, np.array([ntrees, nbranch], "<i4"))
            _write_record(fd, np.array([ntrees], "<i4"))
            _write_record(fd, np.asarray(treelen, "<i4"))
            _write_record(fd, rec)
    return path
