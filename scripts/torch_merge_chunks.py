#!/usr/bin/env python
"""Merge the per-host output chunks of a pinocchio_tpu_torch run over
several hosts into the single-file layout.

A run over H hosts (run_pipeline(hosts=(h, H)) for h = 0..H-1, one outdir)
writes pinocchio.<z>.<run>.catalog.out.<h>, pinocchio.<run>.histories.out.<h>
and pinocchio.<run>.plc.out.<h> chunks (the collector-scheme layout of
write_halos.c:194-225, one chunk per host), the timeless snapshot as
pinocchio.<run>.t_snapshot.out.<h>.npz, and the mass functions and n(z)
whole (their bins reduce through part files in the run).  This tool:

  * concatenates each output's chunks into the canonical file (binary
    chunks become one multi-record file that ReadPinocchio5.py parses,
    ascii chunks lose their repeated headers);
  * assembles the timeless snapshot, byte for byte the one-process file;
  * writes a mass function or n(z) that the run did not (a host that
    failed before the reduction), from the merged catalog or PLC.

Usage: python scripts/torch_merge_chunks.py <parameter_file> [--dir D]
           [--keep] [--norad]
"""

import argparse
import glob
import os
import re
import struct
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def merge_file(path: str, chunks: list, keep: bool) -> str:
    """Concatenate chunks into ``path`` with each output's binary framing,
    so that the result is one collector-scheme file (write_halos.c:194-225,
    1035-1103):

      catalog    [NTasksPerFile, itemsize] (16 B), then per-task blocks
      plc        [itemsize] (12 B), then per-task blocks
      histories  [itemsize] (12 B), the global [Ntrees, Nbranches] (16 B),
                 then collector blocks; the global counts are summed

    Ascii chunks lose their repeated comment headers."""
    with open(chunks[0], "rb") as fd:
        ascii_mode = fd.read(1) == b"#"
    name = os.path.basename(path)
    histories = ".histories." in name
    skip = 12 if ".plc." in name else 16
    if histories:
        skip = 28                      # the itemsize and global records
        ntrees = nbranch = 0
        for chunk in chunks:
            with open(chunk, "rb") as fd:
                hdr = fd.read(28)
            t, b = struct.unpack("<ii", hdr[16:24])
            ntrees += t
            nbranch += b
    with open(path, "wb") as out:
        for i, chunk in enumerate(chunks):
            with open(chunk, "rb") as fd:
                data = fd.read()
            if ascii_mode:
                if i > 0:
                    data = re.sub(rb"^(#[^\n]*\n)+", b"", data)
            elif histories:
                if i == 0:
                    out.write(data[:12])
                    out.write(struct.pack("<iiii", 8, ntrees, nbranch, 8))
                data = data[skip:]
            elif i > 0:
                data = data[skip:]     # the repeated header record
            out.write(data)
    if not keep:
        for chunk in chunks:
            os.remove(chunk)
    return path


def merge(params, directory: str = ".", keep: bool = False) -> list:
    """Merge the chunks of the run ``params`` (the port's Params) in
    ``directory``; returns the paths written."""
    import numpy as np

    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment.driver import CatalogSnapshot
    from pinocchio_tpu_torch.io import readers
    from pinocchio_tpu_torch.io.catalogs import compute_mf, largest_halo_mass
    from pinocchio_tpu_torch.io.snapshot import merge_timeless_chunks

    merged = []
    pat = re.compile(r"\.out\.(\d+)$")
    bases = {}
    for f in sorted(glob.glob(os.path.join(
            directory, f"pinocchio.*{params.RunFlag}*.out.*"))):
        m = pat.search(f)
        if m:
            bases.setdefault(f[:m.start() + 4], []).append(f)
    for base, chunks in sorted(bases.items()):
        merged.append(merge_file(base, sorted(
            chunks, key=lambda s: int(s.rsplit(".", 1)[1])), keep))
        print(f"merged {len(chunks)} chunks -> {base}")

    snap = merge_timeless_chunks(params, directory, keep=keep)
    if snap:
        merged.append(snap)
        print(f"merged the timeless snapshot -> {snap}")

    cosmo = None
    for z in params.output_z:
        cat = os.path.join(directory,
                           f"pinocchio.{z:6.4f}.{params.RunFlag}.catalog.out")
        mf = os.path.join(directory,
                          f"pinocchio.{z:6.4f}.{params.RunFlag}.mf.out")
        if not os.path.exists(cat) or os.path.exists(mf):
            continue
        cosmo = cosmo or Cosmology(params)
        rec = readers.read_catalog(cat)
        merged.append(compute_mf(
            params, cosmo, CatalogSnapshot(
                z=z, name=rec["name"], mass=rec["n"].astype(np.int32),
                q=rec["q"], x=rec["x"], v=rec["v"]),
            directory, largest=largest_halo_mass(params, cosmo)))
        print(f"wrote {merged[-1]} from the merged catalog ({len(rec)} "
              "halos)")

    plc = os.path.join(directory, f"pinocchio.{params.RunFlag}.plc.out")
    nz = os.path.join(directory, f"pinocchio.{params.RunFlag}.nz.out")
    if os.path.exists(plc) and not os.path.exists(nz):
        from pinocchio_tpu_torch.plc import build_plc_geometry, write_nz
        cosmo = cosmo or Cosmology(params)
        geom = build_plc_geometry(params, cosmo, verbose=False)
        if geom.enabled:
            rec = readers.read_plc(plc)
            z_last = min(params.StartingzForPLC, params.LastzForPLC)
            counts = np.histogram(
                rec["red"], bins=geom.nzbins,
                range=(z_last, z_last + geom.nzbins * geom.delta_z))[0]
            merged.append(write_nz(params, cosmo, geom, counts, directory))
            print(f"wrote {nz} from the merged PLC ({len(rec)} rows)")
    if not merged:
        print("nothing to merge (no .out.<host> chunks found)")
    return merged


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("paramfile")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--keep", action="store_true",
                    help="keep the per-host chunks")
    ap.add_argument("--norad", action="store_true",
                    help="no radiation in the background, as the run")
    args = ap.parse_args(argv)
    from pinocchio_tpu_torch.config import read_parameter_file
    overrides = {"norad": True} if args.norad else {}
    return merge(read_parameter_file(args.paramfile, **overrides), args.dir,
                 args.keep)


if __name__ == "__main__":
    main()
