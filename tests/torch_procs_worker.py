"""One process of tests/test_torch_procs.py's process groups.

    python tests/torch_procs_worker.py <port> <rank> <world> <dir>

joins a gloo group of ``world`` processes at localhost:<port> and runs, over
meshes split over the group, on CPU shards with inputs drawn from fixed
seeds: pfft.all_to_all over every collective of a slab 4, a pencil 2x2 and a
volumes 2x2x2 mesh, with a forward and inverse transform and the whole-field
gathers; the collapse cycle's combined means and the FmaxPDF counts; and,
with two processes, the exchange of the products in <dir>/products.npz
(single-turn, turn 0, turn 1 after the spheres' all-gather) and the two-turn
fragmentation of a host slice.  Writes <dir>/result.<rank>.npz and prints
NOJAX when neither jax nor any module of the JAX package was imported.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

N = 16
COLLECTIVES = {"slab": (("x", -2, -3), ("x", -3, -2)),
               "pencil": (("b", -1, -2), ("a", -2, -3), ("a", -3, -2),
                          ("b", -2, -1)),
               "volumes": (("c", -2, -1), (("b", "c"), -1, -2),
                           ("a", -2, -3), ("c", -1, -2))}
SHAPES = {"slab": (4,), "pencil": (2, 2), "volumes": (2, 2, 2)}


def mesh_of(kind, procs=None):
    from pinocchio_tpu_torch.parallel import pfft
    n = int(np.prod(SHAPES[kind]))
    local = n if procs is None else n // procs[1]
    return pfft.mesh_for(n, kind, devices=["cpu"] * local, procs=procs)


def shard_input(i: int) -> torch.Tensor:
    """Position i's shard of a transpose: complex64 [2, 8, 8, 8]."""
    rng = np.random.default_rng(100 + i)
    a = rng.standard_normal((2, 2, 8, 8, 8)).astype(np.float32)
    return torch.complex(torch.from_numpy(a[0]), torch.from_numpy(a[1]))


def field() -> np.ndarray:
    return np.random.default_rng(7).standard_normal(
        (N, N, N)).astype(np.float32)


def transposes(kind, procs=None) -> dict:
    """Every collective's all_to_all of the shard inputs, a forward and an
    inverse transform of field() and their gathers: {name: array}."""
    from pinocchio_tpu_torch.parallel import pfft
    mesh = mesh_of(kind, procs)
    decomp = pfft.make_decomp(mesh, N)
    shards = [shard_input(i) if mesh.local(i) else None
              for i in range(mesh.size)]
    out = {}
    for axes, split, concat in COLLECTIVES[kind]:
        got = pfft.all_to_all(shards, decomp.groups(axes), split, concat,
                              mesh)
        for i in decomp.local:
            out[f"{kind}/{axes}/{split}{concat}/{i}"] = got[i].numpy()
    k = decomp.fwd(decomp.scatter(field()))
    out[f"{kind}/k"] = decomp.gather(k, kspace=True)
    out[f"{kind}/back"] = decomp.gather(decomp.inv(k))
    return out


def reductions(kind, procs=None) -> dict:
    """_combine of per-shard statistics [9, 2] and pdf_hist of per-shard F
    (with an extra count) over the mesh."""
    from pinocchio_tpu_torch.parallel import driver, pfft
    mesh = mesh_of(kind, procs)
    decomp = pfft.make_decomp(mesh, N)
    rng = np.random.default_rng(3)
    stats = rng.standard_normal((mesh.size, 9, 2))
    F = decomp.scatter(rng.uniform(-1.0, 22.0, (N, N, N)).astype(np.float32))
    per = decomp.map(lambda i, _: torch.from_numpy(stats[i]), F)
    return {f"{kind}/combine": driver._combine(decomp, per),
            f"{kind}/hist": driver.pdf_hist(
                decomp, F, extra=[sum(i + 1 for i in decomp.local)])}


def spheres_of(h: int) -> np.ndarray:
    """Host h's turn-1 spheres: [3 + 2h, 4] float32 (cx, cy, cz, r)."""
    rng = np.random.default_rng(50 + h)
    s = rng.uniform(0.0, 32.0, (3 + 2 * h, 4)).astype(np.float32)
    s[:, 3] = rng.uniform(1.0, 6.0, len(s))
    return s


def exchange_params():
    """32^3, two outputs with a displacement set each (RECOMPUTE), four
    sub-boxes."""
    from pinocchio_tpu_torch.config import Params
    return Params(GridSize=32, BoxSize=32.0, output_z=[1.0, 0.0],
                  norad=True, plc_enabled=False, subbox_tasks=4,
                  recompute_displacements=True)


def exchanges(products: str, procs=None, host: int = None) -> dict:
    """Host ``host``'s products from the exchange of the products in
    ``products`` (Fmax and two displacement sets) over a pencil 2x2 mesh
    for 2 hosts, single-turn, turn 0 and turn 1 (every host's spheres,
    all-gathered across processes), and its two-turn fragmentation."""
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fmax import FmaxResult
    from pinocchio_tpu_torch.fragment.subbox import (
        _allgather_spheres, choose_nbox, run_fragmentation_multibox,
        subbox_geometries)
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.parallel import driver, pfft
    from pinocchio_tpu_torch.parallel.exchange import exchange_products
    p = exchange_params()
    cosmo = Cosmology(p)
    largest = largest_halo_mass(p, cosmo)
    nbox = choose_nbox(p, cosmo, largest, p.subbox_tasks)
    geoms = subbox_geometries(p, cosmo, largest, nbox)
    mesh = pfft.mesh_for(4, "pencil", devices=["cpu"] * (4 if procs is None
                                                          else 2),
                         procs=procs)
    decomp = pfft.make_decomp(mesh, p.GridSize)
    with np.load(products) as d:
        F, variance = d["F"], d["true_variance"]
        sets = [{k: d[f"{s}/{k}"] for k in ("v1", "v2", "v31", "v32")}
                for s in range(2)]
    fr = FmaxResult(products=None, grid=None, host_products=None,
                    smoothing=SimpleNamespace(true_variance=variance),
                    pdf_hist=None,
                    handoff=driver.handoff_from_arrays(decomp, F, sets,
                                                       p.Flast))
    out = {}
    spheres = (_allgather_spheres(spheres_of(host), host, 2, procs)
               if procs is not None else {h: spheres_of(h) for h in (0, 1)})
    for h, s in spheres.items():
        out[f"spheres/{h}"] = s
    for turn in (None, 0, 1):
        got = exchange_products(fr, geoms, 2, turn=turn, spheres=spheres,
                                hosts=(host,))[host]
        for k, v in (("ci", got.ci), ("F", got.F),
                     *((f"{s}/{key}", got.segments[s][key]) for s in (0, 1)
                       for key in got.vel)):
            out[f"exchange/{turn}/{k}"] = np.asarray(v)
    two = run_fragmentation_multibox(p, cosmo, fr, nbox, largest_mass=largest,
                                     two_turn=True, host_slice=(host, 2),
                                     verbose=False)
    for iout, cat in enumerate(two.catalogs):
        out[f"two_turn/{iout}/name"] = cat.name
        out[f"two_turn/{iout}/mass"] = cat.mass
    out["two_turn/copies"] = np.array([two.timings["turn0_copies"],
                                       two.timings["turn1_copies"]])
    return out


def main():
    port, rank, world, where = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from pinocchio_tpu_torch.parallel import multihost
    procs = multihost.initialize_cluster(world, f"localhost:{port}", rank,
                                         timeout=60.0, verbose=False)
    out = {}
    try:
        for kind in ("slab", "pencil", "volumes"):
            out.update(transposes(kind, procs))
            out.update(reductions(kind, procs))
        if world == 2:
            out.update(exchanges(os.path.join(where, "products.npz"), procs,
                                 rank))
        out["traffic"] = np.array([[r["bytes"], r["calls"]] for r in
                                   multihost.TRAFFIC.values()])
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    np.savez(os.path.join(where, f"result.{rank}.npz"), **out)
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "pinocchio_tpu" or m.startswith("pinocchio_tpu.")]
    assert not bad, bad[:5]
    print("NOJAX")


if __name__ == "__main__":
    main()
