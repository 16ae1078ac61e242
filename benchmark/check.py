"""The comparison that decides ``correct``: one realization's host products,
as the program landed them, against the plain reference of the same seed
(reference/realization.py) at the same size, on the card, after the window.

Numbers compared, each against a limit of ``cells/<cell>.json``:

  order_bad   rows out of the sweep's order (F descending, ties by
              ascending cell index), repeated cells and cells outside the
              grid, from the program's own products (exact: limit 0)
  cells_off   cells in the program's needed set and not in the
              reference's (F >= Flast) or the other way round, as a share
              of the reference's needed cells
  F_off       the share of the needed rows whose F differs from the
              reference's Fmax of that cell by more than 1e-4 of
              max(1, |F|): float32 does not resolve F in every cell (the
              inverse growth's polynomial cancels), so a sound program
              that rounds otherwise moves a few
  hist_off    FmaxPDF counts that no Fmax within F_off's tolerance of the
              reference's (1e-4 of max(1, |F|), cell by cell) allows, as a
              share of the cells: for each bin, how far the program's
              count lies outside the least and the most cells the
              reference's Fmax can put there.  Rounding at a bin's edge
              reads 0; what is left of a sound change of rounding is the
              few cells whose F float32 does not resolve (as F_off)
  hist_total  how far the counts' total lies from the cells (exact:
              limit 0)
  rows_gap    the widest gap of a displacement row from the reference's
              row of that cell, over every set and field, in units of the
              reference field's rms over the needed cells
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import realization as R

F_TOL = 1e-4
BLOCK = 1 << 24     # cells per block of the histogram's envelope


def reference_inputs(params: dict):
    """(Params, Cosmology, Ladder) of the reference, from its own copies."""
    from benchmark.reference.config import Params
    from benchmark.reference.cosmology import Cosmology
    p = Params(**params)
    cosmo = Cosmology(p)
    gm = None
    if getattr(cosmo, "scale_dep", False):
        from benchmark.reference.scaledep import set_scaledep_gm
        gm = set_scaledep_gm(p, cosmo,
                             R.Ladder(R.smoothing_radii(p, cosmo), None),
                             R.largest_halo_mass(p, cosmo), verbose=False)
    return p, cosmo, R.ladder(p, cosmo, gm)


def products_of(real, Flast: float) -> dict:
    """The products the reference itself would hand off (the control's):
    the cells with F >= Flast by descending F, ties by cell, their F and
    rows, the FmaxPDF counts."""
    F = real.Fmax
    key = torch.where(F >= Flast, -F, float("inf"))
    order = torch.sort(key, stable=True).indices
    ci = order[:int((F >= Flast).sum())]
    sets = [{k: v.cpu().numpy() for k, v in s.items()}
            for s in real.rows(ci)]
    return dict(ci=ci.cpu().numpy(), F=F[ci].cpu().numpy(),
                hist=R.pdf_hist(F).cpu().numpy(), sets=sets)


def _bins(x):
    """The FmaxPDF bin of each value (the reference's pdf_hist binning)."""
    return torch.clamp(torch.floor(x * 10.0), 0.0, R.PDF_BINS - 1.0).to(
        torch.int64)


def hist_envelope(Fref, tol: float = F_TOL):
    """(lo, hi) [PDF_BINS]: the least and the most cells that any Fmax
    within tol * max(1, |F|) of ``Fref``, cell by cell, puts in each bin.
    A cell near a bin's edge may fall on either side; the tolerance is far
    under a bin's width, so no cell spans more than two bins."""
    lo = torch.zeros(R.PDF_BINS, dtype=torch.int64, device=Fref.device)
    hi = torch.zeros_like(lo)
    flat = Fref.reshape(-1)
    for i in range(0, flat.numel(), BLOCK):
        F = torch.nan_to_num(flat[i:i + BLOCK].double(), nan=0.0)
        t = tol * torch.clamp(F.abs(), min=1.0)
        b0, b1 = _bins(F - t), _bins(F + t)
        same = b0 == b1
        lo += torch.bincount(b0[same], minlength=R.PDF_BINS)
        hi += torch.bincount(b0, minlength=R.PDF_BINS)
        hi += torch.bincount(b1[~same], minlength=R.PDF_BINS)
    return lo.cpu(), hi.cpu()


def hist_outside(hist, Fref, tol: float = F_TOL) -> float:
    """The counts of ``hist`` outside ``Fref``'s envelope, bin by bin, as a
    share of the cells."""
    lo, hi = hist_envelope(Fref, tol)
    h = torch.from_numpy(np.asarray(hist, np.int64))
    if h.shape != lo.shape:
        return 1.0
    out = torch.clamp(lo - h, min=0) + torch.clamp(h - hi, min=0)
    return int(out.sum()) / Fref.numel()


def compare(products: dict, real, Flast: float) -> dict:
    """The numbers of the module docstring for ``products`` (host arrays
    ci, F, sets, hist) against the reference realization ``real`` (its
    cycle run: real.Fmax set)."""
    dev = real.Fmax.device
    Fref = real.Fmax
    ncell = Fref.numel()
    ci = torch.from_numpy(np.asarray(products["ci"], np.int64)).to(dev)
    F = torch.from_numpy(np.asarray(products["F"], np.float32)).to(dev)
    count = ci.numel()
    inside = (ci >= 0) & (ci < ncell)
    bad = int((~inside).sum())
    if count > 1:
        later = (F[1:] < F[:-1]) | ((F[1:] == F[:-1]) & (ci[1:] > ci[:-1]))
        bad += int((~later).sum())
    bad += count - int(torch.unique(ci[inside]).numel()) - int(
        (~inside).sum())
    cis = ci[inside]
    mark = torch.zeros(ncell, dtype=torch.int8, device=dev)
    mark[cis] = 1
    mark += (Fref >= Flast).to(torch.int8) * 2
    need_ref = int((mark >= 2).sum())
    cells_off = int(((mark == 1) | (mark == 2)).sum()) / max(need_ref, 1)
    del mark
    Fr = Fref[cis]
    F_off = int(((F[inside] - Fr).abs()
                 > F_TOL * torch.clamp(Fr.abs(), min=1.0)).sum()) / max(
                     int(cis.numel()), 1)
    hist_off = hist_outside(products["hist"], Fref)
    hist_total = abs(int(np.asarray(products["hist"], np.int64).sum())
                     - ncell)
    gap = 0.0
    want = real.rows(cis)
    if len(want) != len(products["sets"]):
        gap = float("inf")
    for got_set, ref_set in zip(products["sets"], want):
        if set(got_set) != set(ref_set):
            gap = float("inf")
            continue
        for k, ref in ref_set.items():
            got = torch.from_numpy(np.ascontiguousarray(
                got_set[k], np.float32)).to(dev)[inside]
            rms = torch.sqrt((ref.double() ** 2).mean()).item()
            g = (got - ref).abs().max().item() / max(rms, 1e-30)
            gap = max(gap, g if np.isfinite(g) else float("inf"))
            del got
    return dict(order_bad=bad, cells_off=cells_off, F_off=F_off,
                hist_off=hist_off, hist_total=hist_total, rows_gap=gap)


def check(params: dict, engine: str, seed: int, products: dict,
          device) -> dict:
    """The compared numbers of ``products`` (the program's realization of
    ``seed``) against the reference computed on ``device``."""
    p, cosmo, lad = reference_inputs(params)
    real = R.Realization(p, cosmo, lad, seed, device, engine)
    real.cycle()
    return compare(products, real, p.Flast)
