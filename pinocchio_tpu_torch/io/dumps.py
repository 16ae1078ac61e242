"""Checkpoint and restart of the fmax products (counterpart of
pinocchio_tpu/io/dumps.py, one host, sparse format).

DumpProducts / ReadProductsFromDumps (fmax.c:372-506, pinocchio.c:220-236):
after the collapse and displacement phase the needed particles' products
are written to disk, so that a later run can go straight to fragmentation.
The files are the JAX package's: ``DumpProducts/summary.json`` (the run's
GridSize, RandomSeed, BoxSize and lpt_order, checked on restart, the
smoothing radii and variances, the format, the number of displacement sets
and the row order) and ``DumpProducts/products.<host>.npz`` with the cell
indices ``ci``, ``F``, the rows ``vel_<field>`` and, under
RECOMPUTE_DISPLACEMENTS, ``seg<s>_<field>`` of the sets s >= 1.  Rows are
float32.  Either package reads the other's dumps.

The dense format (a full-grid dump, written by the JAX package for the
timeless snapshot) is not read: the snapshot is not ported (ROADMAP.md,
queue 1 item 8).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..config import Params
from ..fmax import FmaxResult, Products, Smoothing, SparseProducts
from ..grids import Grid

DUMP_DIR = "DumpProducts"


def dump_products(params: Params, fmax_result: FmaxResult,
                  directory: str = ".") -> str:
    """Write the sparse products of ``fmax_result`` (the needed particles in
    the sweep's order) into ``directory``/DumpProducts; returns the path of
    the chunk."""
    sp = fmax_result.host_products
    sm = fmax_result.smoothing
    ddir = os.path.join(directory, DUMP_DIR)
    os.makedirs(ddir, exist_ok=True)
    arrays = dict(ci=np.asarray(sp.ci, np.int64),
                  F=np.asarray(sp.F, np.float32))
    for k, v in sp.vel.items():
        arrays[f"vel_{k}"] = np.asarray(v, np.float32)
    segs = sp.segments or []
    for s, seg in enumerate(segs[1:], start=1):
        for k, v in seg.items():
            arrays[f"seg{s}_{k}"] = np.asarray(v, np.float32)
    meta = dict(GridSize=params.GridSize, RandomSeed=params.RandomSeed,
                BoxSize=params.BoxSize, lpt_order=params.lpt_order,
                nsmooth=int(sm.n), nhosts=1,
                radii=[float(x) for x in sm.radii],
                variance=[float(x) for x in sm.variance],
                true_variance=[float(x) for x in sm.true_variance],
                format="sparse", nseg=len(segs), sorted_by=sp.sorted_by)
    path = os.path.join(ddir, "products.0.npz")
    np.savez(path, **arrays)
    tmp = os.path.join(ddir, ".summary.json.tmp")
    with open(tmp, "w") as fd:
        json.dump(meta, fd)
    os.replace(tmp, os.path.join(ddir, "summary.json"))
    return path


def read_dumps(params: Params, directory: str = ".") -> FmaxResult:
    """The products of a dump in ``directory``/DumpProducts, written by the
    port or by the JAX package, as an FmaxResult with no Fmax: the needed
    particles in the sweep's (-F, cell) order with their rows and, under
    RECOMPUTE_DISPLACEMENTS, one row set per output redshift.  A dump of
    another run (GridSize, RandomSeed, BoxSize or lpt_order) raises
    ValueError."""
    ddir = os.path.join(directory, DUMP_DIR)
    with open(os.path.join(ddir, "summary.json")) as fd:
        meta = json.load(fd)
    for key, want in (("GridSize", params.GridSize),
                      ("RandomSeed", params.RandomSeed),
                      ("BoxSize", params.BoxSize),
                      ("lpt_order", params.lpt_order)):
        if meta[key] != want:
            raise ValueError(f"dump mismatch for {key}: dump has "
                             f"{meta[key]}, run wants {want}")
    if meta.get("format", "dense") == "dense":
        raise NotImplementedError(
            "a dense-format dump (written for the timeless snapshot) is not "
            "read by pinocchio_tpu_torch yet (ROADMAP.md, queue 1 item 8)")
    files = sorted(glob.glob(os.path.join(ddir, "products.*.npz")),
                   key=lambda p: int(p.rsplit(".", 2)[1]))
    if not files:
        raise FileNotFoundError(f"no dump chunks in {ddir}")
    chunks = [np.load(f) for f in files]
    keys = sorted({k[4:] for c in chunks for k in c.files
                   if k.startswith("vel_")})
    nseg = int(meta.get("nseg", 0))

    def cat(name):
        # float16 rows of an accelerator's dump are widened here
        return np.concatenate([c[name] for c in chunks])

    ci = cat("ci").astype(np.int64)
    F = cat("F").astype(np.float32)
    sets = [{k: cat(f"vel_{k}").astype(np.float32) for k in keys}]
    sets += [{k: cat(f"seg{s}_{k}").astype(np.float32) for k in keys
              if f"seg{s}_{k}" in chunks[0].files} for s in range(1, nseg)]
    if len(chunks) > 1 or meta.get("sorted_by", "ci") != "F":
        # the sweep's order: descending F, ties by ascending cell; chunks
        # of several hosts may share cells, kept once
        first = np.unique(ci, return_index=True)[1]
        order = first[np.lexsort((ci[first], -F[first]))]
        ci, F = ci[order], F[order]
        sets = [{k: v[order] for k, v in rows.items()} for rows in sets]
    sp = SparseProducts(N=params.GridSize, ci=ci, F=F, vel=sets[0],
                        sorted_by="F", segments=sets if nseg else None)
    sm = Smoothing(radii=np.asarray(meta["radii"]),
                   variance=np.asarray(meta["variance"]),
                   true_variance=np.asarray(meta["true_variance"]))
    return FmaxResult(products=Products(Fmax=None, Rmax=None), smoothing=sm,
                      grid=Grid(N=params.GridSize,
                                BoxSize=params.BoxSize_htrue),
                      host_products=sp, pdf_hist=None)
