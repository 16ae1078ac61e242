"""Readers for pinocchio output files (counterpart of
pinocchio_tpu/io/readers.py).

The Python side of scripts/ReadPinocchio5.py: parses the fortran-unformatted
binary catalogs, PLC and histories written by either package and by the
reference (the record layouts are identical by construction), their ascii
variants, the NumFiles > 1 chunks <path>.0, <path>.1, ... and the timeless
snapshot.
"""

from __future__ import annotations

import numpy as np

from .catalogs import CATALOG_DTYPE, CATALOG_LIGHT_DTYPE, HISTORIES_DTYPE

PLC_DTYPE = np.dtype([("name", "<u8"), ("red", "<f4"), ("x", "<f4"),
                      ("y", "<f4"), ("z", "<f4"), ("vx", "<f4"),
                      ("vy", "<f4"), ("vz", "<f4"), ("Mass", "<f4"),
                      ("theta", "<f4"), ("phi", "<f4"), ("v_los", "<f4"),
                      ("obsz", "<f4")])


def _multifile_paths(path: str):
    """NumFiles>1 outputs are chunked as <path>.0, <path>.1, ...
    (collector scheme, write_halos.c:194-225; same discovery rule as
    ReadPinocchio5.py): return the ordered chunk list, or [path]."""
    import os
    if os.path.exists(path):
        return [path]
    if not os.path.exists(path + ".0"):
        raise FileNotFoundError(f"{path} (or {path}.0) not found")
    out = []
    i = 0
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    return out


def _read_record(fd, dtype=np.uint8):
    m = np.fromfile(fd, "<i4", 1)
    if len(m) == 0:
        return None
    n = int(m[0])
    data = np.fromfile(fd, dtype, n // np.dtype(dtype).itemsize)
    np.fromfile(fd, "<i4", 1)
    return data


def read_catalog(path: str) -> np.ndarray:
    """Halo catalog -> structured array (catalog or ascii layout);
    multi-file (NumFiles>1) aware."""
    files = _multifile_paths(path)
    if len(files) > 1:
        return np.concatenate([read_catalog(f) for f in files])
    path = files[0]
    if _is_ascii(path):
        raw = np.loadtxt(path)
        rec = np.zeros(len(raw), CATALOG_DTYPE)
        rec["name"] = raw[:, 0].astype(np.uint64)
        rec["M"] = raw[:, 1]
        rec["q"] = raw[:, 2:5]
        rec["x"] = raw[:, 5:8]
        rec["v"] = raw[:, 8:11]
        if raw.shape[1] > 11:
            rec["n"] = raw[:, 11].astype(np.int32)
        return rec
    out = []
    with open(path, "rb") as fd:
        hdr = _read_record(fd, "<i4")           # [NTasksPerFile, itemsize]
        assert hdr is not None, f"empty catalog {path}"
        if hdr[1] == CATALOG_DTYPE.itemsize:
            dt = CATALOG_DTYPE
        elif hdr[1] == CATALOG_LIGHT_DTYPE.itemsize:   # -DLIGHT_OUTPUT
            dt = CATALOG_LIGHT_DTYPE
        else:
            raise ValueError(f"unexpected catalog record size {hdr}")
        while True:
            ngood = _read_record(fd, "<i4")
            if ngood is None:
                break
            if ngood[0]:
                out.append(_read_record(fd, dt))
    if not out:
        return np.zeros(0, CATALOG_DTYPE)
    rec = np.concatenate(out)
    if dt is CATALOG_LIGHT_DTYPE:
        full = np.zeros(len(rec), CATALOG_DTYPE)
        for f in rec.dtype.names:
            full[f] = rec[f]
        return full
    return rec


def read_histories(path: str):
    """Merger histories -> (ntrees, list of per-tree structured arrays);
    multi-file aware."""
    files = _multifile_paths(path)
    if len(files) > 1:
        total, trees = 0, []
        for f in files:
            n, t = read_histories(f)
            total += n
            trees.extend(t)
        return total, trees
    path = files[0]
    if _is_ascii(path):
        trees = []
        with open(path) as fd:
            lines = [ln for ln in fd]
        i = 0
        while i < len(lines) and not lines[i].startswith("#Tree"):
            i += 1
        cur = []
        for ln in lines[i:]:
            if ln.startswith("#Tree"):
                if cur:
                    trees.append(np.array(cur, HISTORIES_DTYPE))
                cur = []
            else:
                t = ln.split()
                if len(t) == 9:
                    cur.append((int(t[0]), int(t[1]), int(t[2]), int(t[3]),
                                int(t[4]), int(t[5]), float(t[6]),
                                float(t[7]), float(t[8])))
        if cur:
            trees.append(np.array(cur, HISTORIES_DTYPE))
        return len(trees), trees
    with open(path, "rb") as fd:
        _read_record(fd, "<i4")                 # itemsize
        hdr = _read_record(fd, "<i4")           # global [ntrees, nbranch]
        ntrees = int(hdr[0])
        trees = []
        # collector blocks: [tree count][branches per tree][branch data]
        # repeated per writing task (write_halos.c:1035-1103)
        while True:
            cnt = _read_record(fd, "<i4")
            if cnt is None:
                break
            per_tree = (_read_record(fd, "<i4") if cnt[0]
                        else np.zeros(0, "<i4"))
            branches = (_read_record(fd, HISTORIES_DTYPE)
                        if per_tree.sum() else
                        np.zeros(0, HISTORIES_DTYPE))
            off = 0
            for nb in per_tree:
                trees.append(branches[off:off + nb])
                off += nb
    return ntrees, trees


def read_plc(path: str) -> np.ndarray:
    """PLC catalog -> structured array; multi-file aware."""
    files = _multifile_paths(path)
    if len(files) > 1:
        return np.concatenate([read_plc(f) for f in files])
    path = files[0]
    if _is_ascii(path):
        raw = np.loadtxt(path)
        rec = np.zeros(len(raw), PLC_DTYPE)
        cols = ["name", "red", "x", "y", "z", "vx", "vy", "vz", "Mass",
                "theta", "phi", "v_los", "obsz"]
        for i, c in enumerate(cols):
            rec[c] = raw[:, i]
        return rec
    with open(path, "rb") as fd:
        _read_record(fd, "<i4")
        out = []
        while True:
            n = _read_record(fd, "<i4")
            if n is None:
                break
            out.append(_read_record(fd, PLC_DTYPE))
    return np.concatenate(out) if out else np.zeros(0, PLC_DTYPE)


def read_mf(path: str) -> np.ndarray:
    return np.loadtxt(path)


def read_timeless_snapshot(path: str):
    """Timeless snapshot -> dict of typed per-particle fields
    (write_timeless_snapshot layout, write_snapshot.c:207-342): ID, RMAX,
    FMAX, the LPT displacement stacks, ZACC, group membership; plus the
    parsed Gadget header.  Field dtypes come from the INFO block, so both
    64-bit (LLONG, this engine) and 32-bit (LONG, the reference without
    LONGIDS) ID/GRUP layouts parse."""
    from .snapshot import INFO_ENTRY, read_snapshot
    header, blocks = read_snapshot(path)
    info = np.frombuffer(blocks["INFO"], INFO_ENTRY)
    typemap = {"LLONG": "<u8", "LONG": "<u4", "FLOAT": "<f4",
               "FLOATN": "<f4", "DOUBLE": "<f8"}
    signed = {"GRUP": {"LONG": "<i4"}, "RMAX": {"LONG": "<i4"}}
    typed = {}
    for e in info:
        label = e["name"].decode("ascii")
        typ = e["type"].decode("ascii").strip()
        if label == "HEAD" or label not in blocks:
            continue
        dt = signed.get(label.strip(), {}).get(typ) or typemap.get(typ)
        if dt is None:
            continue
        a = np.frombuffer(blocks[label], dt)
        ncomp = int(e["ndim"])
        typed[label.strip()] = a.reshape(-1, ncomp) if ncomp > 1 else a
    return header, typed


def _is_ascii(path: str) -> bool:
    with open(path, "rb") as fd:
        head = fd.read(64)
    try:
        head.decode("ascii")
        return head.lstrip().startswith(b"#")
    except UnicodeDecodeError:
        return False
