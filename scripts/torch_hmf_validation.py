#!/usr/bin/env python
"""HMF validation harness of the PyTorch port (scripts/hmf_validation.py
over pinocchio_tpu_torch, which imports neither jax nor the JAX package):
run the HMF_Validation configuration end to end, compare each output's halo
mass function to its analytic fit (Watson et al. 2013 by default) and,
where the reference's mass functions are at hand, the halo counts to
theirs; log the average residual and save a comparison figure.

The reference records 'HMF Average Residual' = mean |n/n_fit - 1| over
populated bins (HMF_Validation/VALIDATION_log.txt:27-29, value 2.06e-01);
the residual here is hmf_validation.py's: over the bins with at least one
halo.

The configuration is the reference's HMF_Validation/parameter_file when
given (--paramfile, or <--reference>/parameter_file), read with no
radiation and no past light cone; otherwise its switches are built in code
at --grid N (BoxSize N Mpc, outputs z = 2, 1, 0.5, 0, seed 486604, 3LPT,
classic ellipsoid).  File names follow the run's RunFlag.  Without the
reference's mass functions (--reference DIR) the counts are not compared
and no figure is drawn ("plotting skipped").

The run takes --device (default cuda; cpu only when asked); with no card
and no --device cpu it raises.  validate_run(outdir, params, reference)
validates the files of a finished run without running anything.

Usage: python scripts/torch_hmf_validation.py [--outdir DIR]
           [--device cuda|cpu] [--grid N] [--paramfile F] [--reference DIR]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIGURE = "HMF_Validation_with_Watson_fit.png"


def hmf_residual(mf):
    """mean |n/n_fit - 1| over the bins of a mass function (the rows of
    mf.out) that hold at least one halo."""
    sel = mf[:, 4] > 0
    return float(np.abs(mf[sel, 1] / mf[sel, 5] - 1.0).mean())


def validation_params(grid=256, paramfile=None):
    """The HMF_Validation configuration: the parameter file when given
    (no radiation, no past light cone), else its switches in code at
    GridSize ``grid``."""
    if paramfile is not None:
        from pinocchio_tpu_torch.config import read_parameter_file
        return read_parameter_file(paramfile, norad=True, plc_enabled=False)
    from pinocchio_tpu_torch.config import Params
    return Params(GridSize=grid, BoxSize=float(grid),
                  output_z=[2.0, 1.0, 0.5, 0.0], norad=True,
                  plc_enabled=False)


def _mf_name(params, z):
    return f"pinocchio.{z:6.4f}.{params.RunFlag}.mf.out"


def validate_run(outdir, params, reference=None):
    """Validate the mass functions of a finished run in ``outdir``: one
    line per output (the residual against the fit; with the reference's
    file of that output in ``reference``, the halo count against its),
    printed and written to VALIDATION_log.txt, then the figure of the last
    output beside the reference's, where that file exists.  Returns
    [(z, residual, relative count difference or None)]."""
    rows, log_lines = [], []
    for z in params.output_z:
        mine = np.loadtxt(os.path.join(outdir, _mf_name(params, z)))
        resid = hmf_residual(mine)
        line = f"z={z:6.4f}: HMF Average Residual vs Watson fit: {resid:.5g}"
        tot = None
        ref_path = (os.path.join(reference, _mf_name(params, z))
                    if reference else None)
        if ref_path and os.path.exists(ref_path):
            ref = np.loadtxt(ref_path)
            n = min(len(mine), len(ref))
            tot = float(mine[:n, 4].sum() / max(ref[:n, 4].sum(), 1) - 1)
            line += f"; halo count vs reference: {tot:+.2%}"
        rows.append((z, resid, tot))
        log_lines.append(line)
        print(line)

    with open(os.path.join(outdir, "VALIDATION_log.txt"), "w") as fd:
        fd.write("\n".join(log_lines) + "\n")

    z = params.output_z[-1]
    ref_path = (os.path.join(reference, _mf_name(params, z))
                if reference else None)
    if not (ref_path and os.path.exists(ref_path)):
        print("plotting skipped: no reference mass function for "
              f"z={z:6.4f} (--reference)")
        return rows
    # comparison figure
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        mine = np.loadtxt(os.path.join(outdir, _mf_name(params, z)))
        ref = np.loadtxt(ref_path)
        fig, (ax, axr) = plt.subplots(
            2, 1, figsize=(6, 6), sharex=True,
            gridspec_kw=dict(height_ratios=[3, 1]))
        s = mine[:, 4] > 0
        ax.loglog(mine[s, 0], mine[s, 1], "o", ms=3, label="pinocchio-tpu")
        s = ref[:, 4] > 0
        ax.loglog(ref[s, 0], ref[s, 1], "s", ms=3, mfc="none",
                  label="reference")
        ax.loglog(mine[:, 0], mine[:, 5], "-", lw=1, label="Watson 2013")
        ax.legend()
        ax.set_ylabel("n(M)")
        s = mine[:, 4] > 0
        axr.semilogx(mine[s, 0], mine[s, 1] / mine[s, 5] - 1, "o", ms=3)
        axr.axhline(0, color="k", lw=0.5)
        axr.set_ylim(-0.5, 0.5)
        axr.set_xlabel("M [Msun/h]")
        axr.set_ylabel("n/fit - 1")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, FIGURE), dpi=130)
        plt.close(fig)
    except Exception as e:        # plotting must never fail the harness
        print("plotting skipped:", e)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="HMF_Validation_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--grid", type=int, default=256,
                    help="GridSize of the in-code configuration")
    ap.add_argument("--paramfile", default=None,
                    help="the reference's HMF_Validation/parameter_file")
    ap.add_argument("--reference", default=None,
                    help="the reference's HMF_Validation directory (its "
                    "parameter_file and mass functions)")
    args = ap.parse_args(argv)

    from pinocchio_tpu_torch.run import resolve_device, run_pipeline
    device = resolve_device(args.device)
    paramfile = args.paramfile
    if paramfile is None and args.reference is not None:
        candidate = os.path.join(args.reference, "parameter_file")
        paramfile = candidate if os.path.exists(candidate) else None
    params = validation_params(args.grid, paramfile)

    os.makedirs(args.outdir, exist_ok=True)
    run_pipeline(params, outdir=args.outdir, device=device)
    validate_run(args.outdir, params, args.reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
