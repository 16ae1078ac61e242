"""Where the time of the shard window kernels (K2s, K5s, K8s) and of K12
goes, on the card: one call, 20 calls back to back and the host's enqueue
a call, beside the bound (and K12's sector floor).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_shard_split.py [--sizes 256,512]

It uses only the wrappers' public signatures, so the same script times a
tree and the commit it started from (copy it into the other tree's
scripts/ and run both in one call, in turns).  A shard is the (1, 1) shard
of a 2x2 pencil mesh's k layout, the window [N, N/2, Nhp/2] whose last kz
plane is padding (the mesh path's); K8s gets its table as a tensor.  K12
scatters the first x-slab of a [3, N, N, N] field, two thirds of whose
cells are needed in a random order (about the classic path's share), into
the rows buffer of all needed cells.  One call: the median of 5 CUDA-event
times of a call on an idle card, so it holds the host's enqueue; back to
back: the device time of one call among 20 enqueued together; host: the
host clock over 50 calls.  Bound: bytes over 3.35 TB/s (each input read
once, each output written once); K12's sector floor prices every 32-byte
sector its needed rows touch as one read and one write, beside 16 B a cell
of coalesced reads.  Prints the card's name and power limit first, then a
line and a JSON object a kernel and size.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="256,512")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_shard_split.py: no CUDA device available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pinocchio_tpu_torch import kernels
    from pinocchio_tpu_torch.ops import compact, derivatives
    from pinocchio_tpu_torch.parallel import pfft

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    kernels.lib()
    gen = torch.Generator(device=dev)
    for N in (int(n) for n in args.sizes.split(",")):
        gen.manual_seed(N)
        decomp = pfft.make_decomp(pfft.make_pencil_mesh(4, devices=[dev] * 4),
                                  N)
        y0, ny, z0, nz = decomp.k_window(3)
        modes = N * ny * nz
        src = torch.randn((N, ny, nz), dtype=torch.complex64, generator=gen,
                          device=dev)
        gtab = torch.linspace(0.5, 1.5, 512, device=dev)
        glo, gdx = -3.0, 0.01
        cases = {
            "kspace_hessian_shard": (lambda: derivatives.hessian_kspace_shard(
                src, 0.0, N, y0, z0), 56 * modes),
            "kspace_gradient_shard": (
                lambda: derivatives.gradient_kspace_shard(src, 0.8, N, y0,
                                                          z0), 32 * modes),
            "kspace_gradient_tab_shard": (
                lambda: derivatives.gradient_kspace_tab_shard(
                    src, gtab, glo, gdx, N, y0, z0),
                32 * modes + 4 * gtab.numel()),
        }
        # K12: the first x-slab of a field with 2/3 of its cells needed
        cells = N ** 3
        need = torch.randperm(cells, generator=gen,
                              device=dev)[:2 * cells // 3]
        rank = compact.needed_rank(need, cells)
        n_slab = 16 * N * N
        rk = rank[:n_slab]
        comps = torch.randn((3, n_slab), generator=gen, device=dev)
        rows = torch.zeros((need.numel(), 3), device=dev)
        r64 = rk[rk >= 0].long()
        in_slab = r64.numel()
        sectors = torch.unique(torch.cat([(12 * r64) // 32,
                                          (12 * r64 + 11) // 32])).numel()
        cases["vrows_slab"] = (lambda: compact.vrows_slab(rk, comps, rows),
                               16 * n_slab + 12 * in_slab)
        for name, (fn, nbytes) in cases.items():
            one, batch, host = cs.time_ms(fn), cs.batch_ms(fn), cs.host_ms(fn)
            bound = 1e3 * nbytes / cs.PEAK_BYTES
            rec = dict(name=name, N=N, ms=one, batch_ms=batch,
                       host_us=1e3 * host, bound_ms=bound)
            extra = ""
            if name == "vrows_slab":
                floor = 1e3 * (64 * sectors + 16 * n_slab) / cs.PEAK_BYTES
                rec.update(sector_floor_ms=floor, rows=in_slab,
                           sectors=sectors)
                extra = (f", sector floor {floor:.4f} ms ({sectors} sectors "
                         f"of {in_slab} rows; back to back "
                         f"{batch / floor:.2f}x it)")
            print(f"[{N}^3] {name:<26s} one call {one:.4f} ms, back to back "
                  f"{batch:.4f} ms ({batch / bound:.2f}x the bound "
                  f"{bound:.4f}), host {1e3 * host:.1f} us{extra}",
                  flush=True)
            print(json.dumps(rec), flush=True)
        del src, rank, rk, comps, rows, need, r64
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
