"""One process of tests/test_torch_ooc_procs.py's process groups.

    python tests/torch_ooc_procs_worker.py <port> <rank> <world> <dir> <mode>

joins a gloo group of ``world`` processes at localhost:<port> and runs the
out-of-core fmax engine over a mesh of SHARDS[mode] CPU shards split over
the group (each process holding shards / world of them), with inputs from
fixed seeds:

  cases   every case of CASES, its products read through the views
          before the join and read after a join, with the landing chunks
          cut to LAND_ROWS rows so that the hand-off lands in several
          chunks; writes each case's products (case_products)
  busy    the classic case over 3 shards, whose kz windows and x-blocks
          are uneven (6/6/5 kz planes, 2/1/1 x-slabs of 8), the row
          streams slowed, while this thread issues collectives of
          the default group until the last row landed; writes the
          products and how many of those collectives ran while the rows
          streamed

Writes <dir>/result.<rank>.npz and prints NOJAX when neither jax nor any
module of the JAX package was imported.
"""

import functools
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

N = 32
LAND_ROWS = 5000
SHARDS = {"cases": 4, "busy": 3}
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)
CASES = {"classic": {}, "bicubic": dict(ell_model="tabulated",
                                        ct_interp="bicubic"),
         "fr_recompute": FR, "bf16": dict(ooc_dtype="bfloat16")}


@functools.lru_cache(maxsize=None)
def case_inputs(name: str):
    """(Params, cosmology, scaledep_gm) of a case at N^3 with the
    out-of-core engine (made once per process)."""
    from pinocchio_tpu_torch.config import Params
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fmax import Smoothing
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.scaledep import set_scaledep_gm
    p = Params(GridSize=N, BoxSize=float(N), output_z=[2.0, 1.0, 0.5, 0.0],
               norad=True, plc_enabled=False, ooc="on", **CASES[name])
    cosmo = Cosmology(p)
    gm = None
    if cosmo.scale_dep:
        gm = set_scaledep_gm(p, cosmo, Smoothing.build(p, cosmo),
                             largest_halo_mass(p, cosmo), verbose=False)
    return p, cosmo, gm


def run_case(name: str, shards: int, procs=None, prefix: str = None,
             streamed: bool = False):
    """run_fmax_ooc of case ``name`` over ``shards`` CPU shards (split over
    the group when procs): its products (case_products under ``prefix``,
    default the name), read after its row streams are joined, or with
    streamed read through the views before the join."""
    from pinocchio_tpu_torch.fmax_ooc import run_fmax_ooc
    from pinocchio_tpu_torch.parallel import pfft
    p, cosmo, gm = case_inputs(name)
    local = shards if procs is None else shards // procs[1]
    mesh = pfft.mesh_for(shards, "slab", devices=["cpu"] * local,
                         procs=procs)
    res = run_fmax_ooc(p, cosmo, "cpu", scaledep_gm=gm, mesh=mesh)
    if not streamed:
        res.pending_fetch.join()
    out = case_products(res, prefix or name)
    res.pending_fetch.join()
    return out


def case_products(res, prefix: str) -> dict:
    """Fmax (the whole grid: a collective over a group), the variances,
    the FmaxPDF counts, the needed (ci, F) and every row set."""
    sp = res.host_products
    out = {f"{prefix}/Fmax": res.products.gather()[0],
           f"{prefix}/true_variance": res.smoothing.true_variance,
           f"{prefix}/pdf_hist": res.pdf_hist,
           f"{prefix}/ci": sp.ci, f"{prefix}/F": sp.F}
    sets = sp.segments if sp.segments is not None else [sp.vel]
    for s, rows in enumerate(sets):
        for k, v in rows.items():
            out[f"{prefix}/set{s}/{k}"] = np.asarray(v)
    return out


def busy(procs) -> dict:
    """The classic case over SHARDS["busy"] shards, each slab
    step of the row streams slowed by 20 ms, while this thread sums arrays
    over the default group until the streams ended: the products and the
    count of sums made while rows were still streaming (every rank makes
    the same count, as a sum carries each rank's wish to go on)."""
    from pinocchio_tpu_torch.fmax_ooc import run_fmax_ooc
    from pinocchio_tpu_torch.parallel import multihost, pfft
    staged = multihost.all_to_all_staged

    def slow(kind, *args, **kw):
        if kw.get("group") is not None:
            time.sleep(0.02)
        return staged(kind, *args, **kw)
    multihost.all_to_all_staged = slow
    try:
        p, cosmo, gm = case_inputs("classic")
        n = SHARDS["busy"]
        mesh = pfft.mesh_for(n, "slab", devices=["cpu"] * (n // procs[1]),
                             procs=procs)
        res = run_fmax_ooc(p, cosmo, "cpu", mesh=mesh)
        stream = res.pending_fetch.stream
        during = 0
        while True:
            streaming = int(stream.ready[0] < stream.count)
            go = multihost.all_sum("reduce", np.array([streaming]))[0]
            if not go:
                break
            during += 1
        res.pending_fetch.join()
    finally:
        multihost.all_to_all_staged = staged
    out = case_products(res, "busy")
    out["during"] = np.array(during)
    return out


def main():
    port, rank, world, where, mode = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from pinocchio_tpu_torch import fmax_ooc
    from pinocchio_tpu_torch.parallel import multihost
    procs = multihost.initialize_cluster(world, f"localhost:{port}", rank,
                                         timeout=120.0, verbose=False)
    out = {}
    try:
        if mode == "cases":
            fmax_ooc.LAND_ROWS = LAND_ROWS
            for name in CASES:
                for streamed in (True, False):
                    out.update(run_case(name, SHARDS[mode], procs,
                                        f"{name}/{streamed}", streamed))
        else:
            out.update(busy(procs))
        out["traffic"] = np.array([[r["bytes"], r["calls"]] for r in
                                   multihost.TRAFFIC.values()])
    finally:
        multihost.shutdown_cluster()
    np.savez(os.path.join(where, f"result.{rank}.npz"), **out)
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "pinocchio_tpu" or m.startswith("pinocchio_tpu.")]
    assert not bad, bad[:5]
    print("NOJAX")


if __name__ == "__main__":
    main()
