#!/usr/bin/env python3
"""Where the time of the sub-box sweeps goes, on the host of one GPU.

The classic path's fmax phase runs at N^3 on the card (the HMF_Validation
switches, N Mpc/h box, as chip_smoke.py builds them); its products are
then swept on the host

  one       as one periodic box (the port's default, subbox_tasks 1);
  alone     over the sub-boxes of --boxes tasks (choose_nbox), one after
            another on this thread: each sub-box's selection ("sort") and
            sweep seconds with the whole host to itself;
  pool      over the same sub-boxes on the thread pool, as
            run_fragmentation_multibox runs them;

single-turn, then two-turn (alone and pool).  Prints each box's seconds,
the sums and the walls, the stored/total overhead, the card's name and
power limit, then one JSON line.  Needs a CUDA device.

    python3 scripts/torch_subbox_sweeps.py [--n 256] [--boxes CORES]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--boxes", type=int,
                    default=len(os.sched_getaffinity(0)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_subbox_sweeps.py: no CUDA device available",
              file=sys.stderr)
        return 1
    from pinocchio_tpu_torch import native
    from pinocchio_tpu_torch.config import Params
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fmax import run_fmax
    from pinocchio_tpu_torch.fragment import subbox
    from pinocchio_tpu_torch.fragment.driver import run_fragmentation
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    N = args.n
    p = Params(GridSize=N, BoxSize=float(N), output_z=[2.0, 1.0, 0.5, 0.0],
               norad=True, plc_enabled=False)
    cosmo = Cosmology(p)
    res = run_fmax(p, cosmo, torch.device("cuda", 0))
    torch.cuda.synchronize()
    largest = largest_halo_mass(p, cosmo)
    nbox = subbox.choose_nbox(p, cosmo, largest, args.boxes)
    geoms = subbox.subbox_geometries(p, cosmo, largest, nbox)
    print(f"{N}^3, {len(res.host_products.ci)} needed particles, "
          f"{args.boxes} tasks: nbox {nbox}, box 0 {geoms[0]}", flush=True)
    out = dict(card=card, N=N, cores=len(os.sched_getaffinity(0)),
               nbox=list(nbox))

    native.load("groupsweep")          # built with cc before any timing
    t0 = time.perf_counter()
    one = run_fragmentation(p, cosmo, res, verbose=False)
    out["one"] = dict(wall=time.perf_counter() - t0, **one.timings)
    print(f"one box: {out['one']['wall']:.3f} s wall, sort "
          f"{one.timings['sort']:.3f} s, sweep {one.timings['sweep']:.3f} s, "
          f"{one.nstored} stored", flush=True)
    del one

    for two_turn in (False, True):
        name = "two-turn" if two_turn else "single-turn"
        per_box = []
        t0 = time.perf_counter()
        for g in geoms:
            t1 = time.perf_counter()
            if two_turn:
                r = subbox.run_fragmentation_two_turn(p, cosmo, res, g)
            else:
                r = run_fragmentation(p, cosmo, res, geom=g, verbose=False)
            per_box.append(dict(wall=time.perf_counter() - t1,
                                nstored=r.nstored, **r.timings))
            del r
        alone = time.perf_counter() - t0
        for i, b in enumerate(per_box):
            print(f"  {name} box {i} alone: {b['wall']:.3f} s (sort "
                  f"{b['sort']:.3f}, sweep {b['sweep']:.3f}, quick "
                  f"{b.get('quick', 0.0):.3f}), {b['nstored']} stored",
                  flush=True)
        t0 = time.perf_counter()
        merged = subbox.run_fragmentation_multibox(
            p, cosmo, res, nbox, largest_mass=largest, two_turn=two_turn,
            verbose=False)
        pool = time.perf_counter() - t0
        t = merged.timings
        sums = {k: sum(b.get(k, 0.0) for b in per_box)
                for k in ("sort", "sweep", "quick")}
        print(f"{name}: one after another {alone:.3f} s (sort "
              f"{sums['sort']:.3f}, sweep {sums['sweep']:.3f}, quick "
              f"{sums['quick']:.3f} summed); on the pool {pool:.3f} s wall "
              f"(sort {t['sort']:.3f}, sweep {t['sweep']:.3f}, quick "
              f"{t['quick']:.3f} summed, slowest box {t['total']:.3f}); "
              f"stored/total overhead {t['overhead']:.4f}", flush=True)
        out[name] = dict(alone_wall=alone, alone=per_box, pool_wall=pool,
                         pool=t)
        del merged
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
