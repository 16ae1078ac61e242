"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size (the benchmark's runs do not run this):

  program   the program's realization of each seed against the float32
            reference of that seed: the lower readings (sound runs)
  control   the nearest precision below the configuration's, in the
            program's place, against the same reference: the upper
            readings.  On the out-of-core engine the program's own 16-bit
            ledger (ooc_dtype bfloat16); elsewhere the reference with each
            stored field rounded to bfloat16 (reference/realization.py)
  float64   the program against a reference computed in float64 after the
            draws: how far float32 itself lies from the mathematics, the
            scale of what a sound program that rounds otherwise reads

The float64 and control readings also give ``hist_off_quarter``: hist_off
at a quarter of F_off's tolerance.  Where it reads as hist_off does, what
hist_off counts are cells whose F moved far, not rounding at a bin's edge.

  python3 benchmark/calibrate.py --workload <cell> --seed <n> \
      [--seeds 12] [--controls 3] [--float64 3] [--out <file.jsonl>] \
      [--device cuda:0] [--grid N]

One JSON line per reading, then a summary line: each number's largest
program reading, smallest control reading and largest float64 reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, harness  # noqa: E402
from benchmark.reference import realization as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--float64", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--grid", type=int, default=None,
                    help="GridSize and BoxSize in place of the cell's (the "
                    "tests' small size)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    cell = harness.Cell(harness.load_spec(), args.workload)
    if args.grid:
        cell.config["params"].update(GridSize=args.grid,
                                     BoxSize=float(args.grid))
    system = harness.System(cell, args.device)
    control = None
    if system.engine == "ooc":
        control = harness.System(cell, args.device)
        control.params.ooc_dtype = "bfloat16"
    p, cosmo, lad = check.reference_inputs(cell.params_dict())
    seeds = np.random.SeedSequence(args.seed).generate_state(args.seeds)
    out = open(args.out, "a") if args.out else None
    rows = []

    def emit(kind, seed, nums, t):
        line = dict(cell=cell.name, kind=kind, seed=int(seed), seconds=t,
                    **nums)
        rows.append(line)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    def free():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    for i, s in enumerate(int(x) & 0x7FFFFFFF for x in seeds):
        t0 = time.perf_counter()
        _, prog = system.realize(s, keep=True)
        free()
        ref = R.Realization(p, cosmo, lad, s, args.device, system.engine)
        ref.cycle()
        emit("program", s, check.compare(prog, ref, p.Flast),
             time.perf_counter() - t0)
        if i < args.controls:
            t0 = time.perf_counter()
            if control is not None:
                _, ctrl = control.realize(s, keep=True)
                free()
            else:
                low = R.Realization(p, cosmo, lad, s, args.device,
                                    system.engine, store="bfloat16")
                low.cycle()
                ctrl = check.products_of(low, p.Flast)
                del low
                free()
            emit("control", s, dict(check.compare(ctrl, ref, p.Flast),
                                    hist_off_quarter=check.hist_outside(
                                        ctrl["hist"], ref.Fmax,
                                        check.F_TOL / 4)),
                 time.perf_counter() - t0)
            del ctrl
        del ref
        free()
        if i < args.float64:
            t0 = time.perf_counter()
            r64 = R.Realization(p, cosmo, lad, s, args.device, system.engine,
                                store="float64")
            r64.cycle()
            emit("float64", s, dict(check.compare(prog, r64, p.Flast),
                                    hist_off_quarter=check.hist_outside(
                                        prog["hist"], r64.Fmax,
                                        check.F_TOL / 4)),
                 time.perf_counter() - t0)
            del r64
        del prog
        free()

    keys = ("order_bad", "cells_off", "F_off", "hist_off",
            "hist_off_quarter", "hist_total", "rows_gap")
    summary = dict(cell=cell.name, kind="summary")
    for k in keys:
        for kind, fn in (("program", max), ("control", min),
                         ("float64", max)):
            vals = [r[k] for r in rows if r["kind"] == kind and k in r]
            if vals:
                summary[f"{kind}_{k}"] = fn(vals)
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
