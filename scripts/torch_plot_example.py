#!/usr/bin/env python
"""Visual checks of a run of the PyTorch port (scripts/plot_example.py over
pinocchio_tpu_torch, which imports neither jax nor the JAX package; the
reference's PlotExample.py analog): halo mass function vs the analytic
fit, a large-scale-structure slice, and the PLC cone.

It reads the run's files (through pinocchio_tpu_torch.io.readers) and
touches no device.  Writes mf.png and lss.png, and plc.png when the run
wrote a PLC catalog, into the run's directory.

Usage: python scripts/torch_plot_example.py <parameter_file> [--outdir DIR]
           [--z Z]
"""

import argparse
import os
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt    # noqa: E402
import numpy as np                 # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pinocchio_tpu_torch.config import read_parameter_file      # noqa: E402
from pinocchio_tpu_torch.io.readers import (read_catalog, read_mf,  # noqa
                                            read_plc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("parameter_file")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--z", default=None, help="redshift label (default: last)")
    args = ap.parse_args(argv)
    p = read_parameter_file(args.parameter_file)
    z = float(args.z) if args.z else p.output_z[-1]
    run = p.RunFlag
    d = args.outdir

    # mass function vs analytic fit
    mf = read_mf(os.path.join(d, f"pinocchio.{z:6.4f}.{run}.mf.out"))
    sel = mf[:, 4] > 0
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.loglog(mf[sel, 0], mf[sel, 1], "o", ms=3, label="pinocchio-tpu")
    ax.loglog(mf[:, 0], mf[:, 5], "-", label="analytic fit")
    ax.set_xlabel("M [Msun]")
    ax.set_ylabel("n(M) [Mpc^-3 Msun^-1]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(d, "mf.png"), dpi=130)
    plt.close(fig)

    # LSS slice from the catalog
    cat = read_catalog(os.path.join(d, f"pinocchio.{z:6.4f}.{run}"
                                    ".catalog.out"))
    box = p.BoxSize_h100 if p.OutputInH100 else p.BoxSize_htrue
    sel = cat["x"][:, 2] < box / 10.0
    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    ax.scatter(cat["x"][sel, 0], cat["x"][sel, 1],
               s=np.clip(cat["M"][sel] / cat["M"][sel].min(), 1, 60) ** 0.5,
               lw=0, alpha=0.6)
    ax.set_xlabel("x [Mpc]")
    ax.set_ylabel("y [Mpc]")
    ax.set_title(f"halos in a {box / 10:.0f} Mpc slice, z={z}")
    fig.tight_layout()
    fig.savefig(os.path.join(d, "lss.png"), dpi=130)
    plt.close(fig)

    # PLC cone, if present
    plc_path = os.path.join(d, f"pinocchio.{run}.plc.out")
    if os.path.exists(plc_path):
        plc = read_plc(plc_path)
        fig, ax = plt.subplots(figsize=(6.5, 4.5))
        r = np.sqrt(plc["x"] ** 2 + plc["y"] ** 2 + plc["z"] ** 2)
        ax.scatter(r * np.cos(np.radians(plc["phi"])),
                   r * np.sin(np.radians(plc["phi"])), s=1, lw=0,
                   alpha=0.4)
        ax.set_xlabel("[Mpc]")
        ax.set_ylabel("[Mpc]")
        ax.set_title("past light cone")
        fig.tight_layout()
        fig.savefig(os.path.join(d, "plc.png"), dpi=130)
        plt.close(fig)
    print("wrote mf.png, lss.png" +
          (", plc.png" if os.path.exists(plc_path) else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
