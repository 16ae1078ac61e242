"""Checkpoint and restart of the fmax products (counterpart of
pinocchio_tpu/io/dumps.py, one host).

DumpProducts / ReadProductsFromDumps (fmax.c:372-506, pinocchio.c:220-236):
after the collapse and displacement phase the products are written to
disk, so that a later run can go straight to fragmentation.  The files are
the JAX package's, and either package reads the other's dumps.
``DumpProducts/summary.json`` holds the run's GridSize, RandomSeed, BoxSize
and lpt_order (checked on restart), the smoothing radii and variances and
the format (a legacy dense dump keeps the radii and variances in its
``products.npz`` instead, and both packages read them from there):

  sparse  (the default) ``products.<host>.npz``: the needed particles' cell
          indices ``ci``, ``F``, the rows ``vel_<field>`` and, under
          RECOMPUTE_DISPLACEMENTS, ``seg<s>_<field>`` of the sets s >= 1;
          float32 rows, with the number of sets and the row order in the
          summary;
  dense   (with WriteTimelessSnapshot, whose writer reads every particle)
          ``products.npz``: the whole grid's ``Fmax``, ``Rmax`` and the
          first displacement set's ``vel_<field>`` stacks [3, N, N, N].  It
          keeps no further RECOMPUTE set, as the JAX package's does not.

A sparse dump read by a run that wants the timeless snapshot raises
ValueError, as in the JAX package.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

import torch

from ..config import Params
from ..fmax import (DenseProducts, FmaxResult, Products, Smoothing,
                    SparseProducts)
from ..grids import Grid
from ..ops import compact

DUMP_DIR = "DumpProducts"


def _write_summary(ddir: str, meta: dict) -> None:
    tmp = os.path.join(ddir, ".summary.json.tmp")
    with open(tmp, "w") as fd:
        json.dump(meta, fd)
    os.replace(tmp, os.path.join(ddir, "summary.json"))


def dump_products(params: Params, fmax_result: FmaxResult,
                  directory: str = ".") -> str:
    """Write the products of ``fmax_result`` into ``directory``/DumpProducts:
    the whole grid's (fmax_result.dense) with WriteTimelessSnapshot, else
    the needed particles' in the sweep's order; returns the path of the
    npz file."""
    sp = fmax_result.host_products
    sm = fmax_result.smoothing
    ddir = os.path.join(directory, DUMP_DIR)
    os.makedirs(ddir, exist_ok=True)
    meta = dict(GridSize=params.GridSize, RandomSeed=params.RandomSeed,
                BoxSize=params.BoxSize, lpt_order=params.lpt_order,
                nsmooth=int(sm.n), nhosts=1,
                radii=[float(x) for x in sm.radii],
                variance=[float(x) for x in sm.variance],
                true_variance=[float(x) for x in sm.true_variance])
    if params.WriteTimelessSnapshot:
        d = fmax_result.dense
        if d is None:
            raise ValueError("a dense dump needs the whole grid's products "
                             "(run fmax with WriteTimelessSnapshot)")
        _write_summary(ddir, dict(meta, format="dense"))
        arrays = dict(Fmax=d.Fmax, Rmax=d.Rmax)
        for k, v in d.vel.items():
            arrays[f"vel_{k}"] = v
        path = os.path.join(ddir, "products.npz")
        np.savez(path, **arrays)
        return path
    arrays = dict(ci=np.asarray(sp.ci, np.int64),
                  F=np.asarray(sp.F, np.float32))
    for k, v in sp.vel.items():
        arrays[f"vel_{k}"] = np.asarray(v, np.float32)
    segs = sp.segments or []
    for s, seg in enumerate(segs[1:], start=1):
        for k, v in seg.items():
            arrays[f"seg{s}_{k}"] = np.asarray(v, np.float32)
    path = os.path.join(ddir, "products.0.npz")
    np.savez(path, **arrays)
    _write_summary(ddir, dict(meta, format="sparse", nseg=len(segs),
                              sorted_by=sp.sorted_by))
    return path


SMOOTHING_KEYS = ("radii", "variance", "true_variance")


def _smoothing(src) -> Smoothing:
    return Smoothing(**{k: np.asarray(src[k]) for k in SMOOTHING_KEYS})


def _read_dense(params: Params, ddir: str, sm: Smoothing) -> FmaxResult:
    """A dense dump: the whole grid's products on the host, the needed
    particles compacted from them in the sweep's order (descending F, ties
    by ascending cell: a stable sort of the cell-ordered candidates) and
    the FmaxPDF histogram of the grid.  sm None (a legacy dump): the
    smoothing radii and variances from the npz."""
    with np.load(os.path.join(ddir, "products.npz")) as data:
        if sm is None:
            sm = _smoothing(data)
        dense = DenseProducts(
            Fmax=np.asarray(data["Fmax"], np.float32),
            Rmax=np.asarray(data["Rmax"], np.int32),
            vel={k[4:]: np.asarray(data[k], np.float32)
                 for k in sorted(data.files) if k.startswith("vel_")})
    F = dense.Fmax.ravel()
    ci = np.flatnonzero(F >= params.Flast)
    ci = ci[np.argsort(-F[ci], kind="stable")]
    sp = SparseProducts(
        N=params.GridSize, ci=ci.astype(np.int64), F=F[ci],
        vel={k: np.ascontiguousarray(v.reshape(3, -1)[:, ci].T)
             for k, v in dense.vel.items()}, sorted_by="F")
    hist = compact.pdf_hist(torch.from_numpy(F)).numpy()
    return FmaxResult(products=Products(Fmax=None, Rmax=None), smoothing=sm,
                      grid=Grid(N=params.GridSize,
                                BoxSize=params.BoxSize_htrue),
                      host_products=sp, pdf_hist=hist, dense=dense)


def read_dumps(params: Params, directory: str = ".") -> FmaxResult:
    """The products of a dump in ``directory``/DumpProducts, written by the
    port or by the JAX package, as an FmaxResult with no device Fmax: the
    needed particles in the sweep's (-F, cell) order with their rows and,
    under RECOMPUTE_DISPLACEMENTS, one row set per output redshift; from a
    dense dump also the whole grid's products (FmaxResult.dense) and the
    FmaxPDF histogram.  A dump of another run (GridSize, RandomSeed,
    BoxSize or lpt_order) raises ValueError, and so do a sparse dump for a
    run with WriteTimelessSnapshot and a sparse dump whose summary lacks
    the smoothing radii and variances."""
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
    # a legacy dense dump keeps the radii and variances in its npz
    sm = _smoothing(meta) if "radii" in meta else None
    if meta.get("format", "dense") == "dense":
        return _read_dense(params, ddir, sm)
    if sm is None:
        raise ValueError(
            f"the sparse dump in {ddir} has no smoothing radii and "
            f"variances in its summary.json ({', '.join(SMOOTHING_KEYS)})")
    if params.WriteTimelessSnapshot:
        raise ValueError(
            "this dump is sparse (needed particles only) but the run "
            "wants a timeless snapshot, which needs the dense products; "
            "re-dump with WriteTimelessSnapshot=True")
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
    return FmaxResult(products=Products(Fmax=None, Rmax=None), smoothing=sm,
                      grid=Grid(N=params.GridSize,
                                BoxSize=params.BoxSize_htrue),
                      host_products=sp, pdf_hist=None)
