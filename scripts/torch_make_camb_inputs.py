#!/usr/bin/env python
"""Generate a CAMB-format input file set for READ_PK_TABLE runs of the
PyTorch port: scripts/make_camb_inputs.py over pinocchio_tpu_torch, which
imports neither jax nor the JAX package.  Its files are byte for byte those
of the JAX script.

Analog of the reference's scripts/PkCamb.py (DOCUMENTATION:814-837), which
runs the external `camb` package to produce the CDM+baryon power spectra
that massive-neutrino runs read.  `camb` is not available here, so this
writes the same file set from the internal cosmology instead — P_cb(k, z)
= P(k, 0) * (D(z)/D(0))^2 with scale-INdependent LCDM growth.  That is
exactly the reference's SCALE_DEP_LCDM consistency scenario
(tests/pk_and_HMF_tests/SCALE_DEP_LCDM): feeding these files through the
READ_PK_TABLE + scale-dependent machinery must reproduce the plain LCDM
run, which makes this the standard self-test for the table pathway.

All the work is host numpy: no device is touched.

Output (matching example/CAMBFiles/):
    <base>_000.dat ... <base>_NNN.dat   k [h/Mpc]   P_cb [(Mpc/h)^3]
    redshifts.dat                       index  z   (last must be z=0)
    hubble.dat                          z  E(z)=H/H0  (for READ_HUBBLE_TABLE,
                                        the HubbleTableFile key)

Usage:
    python scripts/torch_make_camb_inputs.py parameter_file \
        --outdir CAMBFiles [--nz 100] [--zmax 99] [--base pk_cb] [--norad]
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pinocchio_tpu_torch.config import read_parameter_file   # noqa: E402
from pinocchio_tpu_torch.cosmology import Cosmology          # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("parameter_file")
    ap.add_argument("--outdir", default="CAMBFiles")
    ap.add_argument("--base", default="pk_cb")
    ap.add_argument("--nz", type=int, default=100,
                    help="number of redshift outputs (last is z=0)")
    ap.add_argument("--zmax", type=float, default=99.0)
    ap.add_argument("--norad", action="store_true")
    args = ap.parse_args(argv)

    params = read_parameter_file(args.parameter_file)
    params.norad = args.norad
    # plain LCDM growth for the table build, whatever the file requests
    params.scale_dependent = False
    params.read_pk_table = False
    cosmo = Cosmology(params)
    h = params.Hubble100

    os.makedirs(args.outdir, exist_ok=True)

    # CAMB-like log-k grid in h/Mpc (example/CAMBFiles spacing)
    kappa = np.logspace(math.log10(5.0e-4), math.log10(60.0), 640)
    k_true = kappa * h
    pk0_true = np.asarray(cosmo.PowerSpectrum(k_true), np.float64)
    pk0_file = pk0_true * h ** 3                      # (Mpc/h)^3

    # the reference's PkCamb.py spaces outputs uniformly in 1/(1+z)
    a = np.linspace(1.0 / (1.0 + args.zmax), 1.0, args.nz)
    zs = 1.0 / a - 1.0
    zs[-1] = 0.0

    D0 = float(cosmo.GrowingMode(0.0))
    with open(os.path.join(args.outdir, "redshifts.dat"), "w") as fd:
        for i, z in enumerate(zs):
            fd.write(f"{i:03d} {z:.8e}\n")
            D = float(cosmo.GrowingMode(z)) / D0
            np.savetxt(os.path.join(args.outdir,
                                    f"{args.base}_{i:03d}.dat"),
                       np.column_stack([kappa, pk0_file * D * D]),
                       fmt="%.8e")

    # E(z) = H/H0 table down from z ~ 1e5 (READ_HUBBLE_TABLE input): the
    # second column is what Cosmology.Hubble multiplies by 100 h
    ztab = np.concatenate([np.logspace(5, -3, 300), [0.0]])
    etab = np.sqrt(np.asarray(cosmo.Esq(ztab), np.float64))
    np.savetxt(os.path.join(args.outdir, "hubble.dat"),
               np.column_stack([ztab, etab]), fmt="%.18e")

    # the same lines as the JAX script, which names only the two CAMB keys
    # (hubble.dat goes under HubbleTableFile)
    print(f"wrote {args.nz} spectra + redshifts.dat + hubble.dat "
          f"to {args.outdir}/")
    print("parameter_file keys to use them:")
    print(f"  CAMBMatterFile     {args.outdir}/{args.base}")
    print(f"  CAMBRedshiftsFile  {args.outdir}/redshifts.dat")
    return 0


if __name__ == "__main__":
    sys.exit(main())
