"""Where the time of K4 (the LPT source passes) and K15 (the exchange's
row count) goes, on the card: one call, 20 calls back to back and the
host's enqueue a call, beside the bound; then the out-of-core fmax phase's
LPT times.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/torch_lpt_count_split.py [--sizes 256,512] [--ooc 256]

It uses only the wrappers' public signatures and chip_smoke.py's inputs,
so the same script times a tree and the commit it started from (copy it
into the other tree's scripts/ and run both in one call, in turns).  K4's
forms: the sources from the R=0 Hessian stack [6, N, N, N] and from an
x-slab [6, Bx, N, N], the six-pair accumulation, and one pair on an
x-slab view of the field (the out-of-core fold), with torch.addcmul_ on
the same slab beside it; each form's bits are compared with its plain
version (printed, not required: a tree may hold them to a tolerance).
K15's forms on the (1, 1) shard of a 2x2 pencil mesh: boxes for 2 hosts
(the main path's sub-boxes) and 16 (random boxes), request maps for 2
hosts.  One call: the median of 5 CUDA-event times of a call on an idle
card, so it holds the host's enqueue; back to back: the device time of one
call among 20 enqueued together; host: the host clock over 50 calls.
Bound: bytes over 3.35 TB/s (each input read once, each output written
once); the map form's floor adds each 32-byte map sector its rows read.
Then run_fmax_ooc at the --ooc size, twice: its sources, fold and spectra
phases and its lpt time (run_pipeline's fmax_lpt), s.  Prints the card's
name and power limit first, then a line and a JSON object a form.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(name, N, fn, nbytes, cs, extra=None, **more):
    """Time fn (and extra: a library call), print and return the record."""
    one, batch, host = cs.time_ms(fn), cs.batch_ms(fn), cs.host_ms(fn)
    bound = 1e3 * nbytes / cs.PEAK_BYTES
    rec = dict(name=name, N=N, ms=one, batch_ms=batch, host_us=1e3 * host,
               bound_ms=bound, **more)
    lib = ""
    if extra is not None:
        rec.update(library_ms=cs.time_ms(extra),
                   library_batch_ms=cs.batch_ms(extra))
        lib = (f"; torch.addcmul_ one call {rec['library_ms']:.4f} ms, back "
               f"to back {rec['library_batch_ms']:.4f}")
    print(f"[{N}^3] {name:<34s} one call {one:.4f} ms, back to back "
          f"{batch:.4f} ms ({batch / bound:.2f}x the bound {bound:.4f}), "
          f"host {1e3 * host:.1f} us"
          + "".join(f", {k} {v}" for k, v in more.items()) + lib,
          flush=True)
    print(json.dumps(rec), flush=True)
    return rec


def host_split(dev, cs, lpt, p1, s1, out, w):
    """Where the host's enqueue of one pair goes, us a call over 50 calls:
    the stream query, the C entry point with its arguments made beforehand,
    the launch helper, the wrapper, and the wrapper with the caller's
    slicing; torch.addcmul_ beside them (a tree whose wrapper goes through
    the ctypes library)."""
    from pinocchio_tpu_torch import kernels
    stream = kernels.stream_ptr(dev)
    fn = lpt._entry("lpt_accumulate_one")
    args = (p1.data_ptr(), s1.data_ptr(), out.data_ptr(), out.numel(),
            2.0 * w[0], stream)
    u = (s1, p1)
    calls = {"stream query": lambda: kernels.stream_ptr(dev),
             "entry point": lambda: fn(*args),
             "launch helper": lambda: lpt.launch_accumulate_one(
                 p1, s1, out, 2.0 * w[0], stream),
             "wrapper": lambda: lpt.src32_accumulate(p1, s1, out, weights=w),
             "wrapper, sliced": lambda: lpt.src32_accumulate(
                 u[1][0:1], u[0][0:1], out, weights=w),
             "torch.addcmul_": lambda: out.addcmul_(p1[0], s1[0],
                                                    value=-2.0 * w[0])}
    us = {k: round(1e3 * cs.host_ms(f), 2) for k, f in calls.items()}
    print("  host us a call, one pair: " + ", ".join(
        f"{k} {v}" for k, v in us.items()), flush=True)
    print(json.dumps(dict(name="host split", **us)), flush=True)


def count_host_split(dev, cs, xops, c, block, N, pb, po, nhosts):
    """Where the host's enqueue of K15 goes, us a call over 50 calls: the
    outputs' allocation, the C entry point with its arguments made
    beforehand, the launch helper, the wrapper (a tree whose wrapper goes
    through the ctypes library)."""
    import ctypes

    import torch
    from pinocchio_tpu_torch import kernels
    stream = kernels.stream_ptr(dev)
    n = c.numel()
    bits = torch.empty((n, xops.words(nhosts)), dtype=torch.int32,
                       device=dev)
    counts = torch.empty((-(-n // xops.THREADS), nhosts), dtype=torch.int32,
                         device=dev)
    xops.launch_count(c, block, N, pb, po, nhosts, None, bits, counts,
                      stream)
    fn = xops._COUNT
    blk = (ctypes.c_int * 6)(*block)
    args = (c.data_ptr(), n, blk, N, pb.data_ptr(), pb.shape[0],
            po.data_ptr(), None, nhosts, bits.data_ptr(), counts.data_ptr(),
            0, stream)
    calls = {"outputs": lambda: (torch.empty_like(bits),
                                 torch.empty_like(counts)),
             "entry point": lambda: fn(*args),
             "launch helper": lambda: xops.launch_count(
                 c, block, N, pb, po, nhosts, None, bits, counts, stream),
             "wrapper": lambda: xops.count(c, block, N, pb, po, nhosts)}
    us = {k: round(1e3 * cs.host_ms(f), 2) for k, f in calls.items()}
    print("  host us a call, K15 boxes: " + ", ".join(
        f"{k} {v}" for k, v in us.items()), flush=True)
    print(json.dumps(dict(name="K15 host split", **us)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="256,512")
    ap.add_argument("--ooc", type=int, default=256,
                    help="grid of the out-of-core fmax phase (0: none)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_lpt_count_split.py: no CUDA device available",
              file=sys.stderr)
        return 1
    from pinocchio_tpu_torch import kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    kernels.lib()
    split(torch.device("cuda", 0),
          [int(n) for n in args.sizes.split(",")], args.ooc)
    return 0


def split(dev, sizes, ooc_n):
    """The forms at each grid of sizes, then the out-of-core fmax phase at
    ooc_n (none at 0), on the device dev."""
    import torch

    import chip_smoke as cs
    from pinocchio_tpu_torch import fmax_ooc
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.ops import exchange as xops
    from pinocchio_tpu_torch.ops import lpt
    gen = torch.Generator(device=dev)
    for N in sizes:
        gen.manual_seed(N)
        Bx = fmax_ooc.slab_width(N)
        cells, n_slab = N ** 3, Bx * N * N
        sd = torch.randn((6, N, N, N), generator=gen, device=dev)
        phi2 = torch.randn((6, N, N, N), generator=gen, device=dev)
        sd_slab = sd[:, Bx:2 * Bx].contiguous()
        src32 = torch.randn((N, N, N), generator=gen, device=dev)
        u = torch.stack([sd[3, Bx:2 * Bx], phi2[3, Bx:2 * Bx]])
        out = src32[Bx:2 * Bx]
        w = (lpt.PHI2_WEIGHTS[3],)

        def bits(got, want):
            return all(cs.same_bits(g, r) for g, r in zip(got, want))
        report("K4 sources [6, N, N, N]", N,
               lambda: lpt.sources_pointwise(sd), 36 * cells, cs,
               bits=bits(lpt.sources_pointwise(sd),
                         lpt.sources_pointwise_plain(sd)))
        report(f"K4 sources [6, {Bx}, N, N] slab", N,
               lambda: lpt.sources_pointwise(sd_slab), 36 * n_slab, cs,
               bits=bits(lpt.sources_pointwise(sd_slab),
                         lpt.sources_pointwise_plain(sd_slab)))
        scratch = src32.clone()
        report("K4 six pairs [6, N, N, N]", N,
               lambda: lpt.src32_accumulate(phi2, sd, scratch), 56 * cells,
               cs, bits=bits([lpt.src32_accumulate(phi2, sd, src32.clone())],
                             [lpt.src32_accumulate_plain(phi2, sd, src32)]))
        want = lpt.src32_accumulate_plain(u[1:2], u[0:1], out, w)
        same = bits([lpt.src32_accumulate(u[1:2], u[0:1], out, weights=w)],
                    [want])
        p1, s1 = u[1:2], u[0:1]
        report(f"K4 one pair on a [{Bx}, N, N] slab", N,
               lambda: lpt.src32_accumulate(p1, s1, out, weights=w),
               16 * n_slab, cs,
               extra=lambda: out.addcmul_(u[1], u[0], value=-2.0 * w[0]),
               bits=same)
        if hasattr(lpt, "launch_accumulate_one"):
            host_split(dev, cs, lpt, p1, s1, out, w)
        del sd, phi2, sd_slab, src32, u, out, scratch, want
        for nhosts in (cs.HOSTS, 16):
            case = cs.exchange_inputs(N, dev, nhosts)
            pb, po, tb, to = case["tables"]
            block, c = case["block"], case["cells"]
            n, W = c.numel(), xops.words(nhosts)
            counts_bytes = 4 * -(-n // xops.THREADS) * nhosts
            got = xops.count(c, block, N, pb, po, nhosts)
            same = all(torch.equal(g, r) for g, r in zip(
                got, xops.count_plain(c, block, N, pb, po, nhosts)))
            report(f"K15 boxes, {nhosts} hosts", N,
                   lambda: xops.count(c, block, N, pb, po, nhosts),
                   n * (8 + 4 * W) + counts_bytes, cs, rows=n,
                   boxes=case["nboxes"], identical=same)
            if nhosts == cs.HOSTS and hasattr(xops, "launch_count"):
                count_host_split(dev, cs, xops, c, block, N, pb, po, nhosts)
            if nhosts == cs.HOSTS:
                plan = xops.PaintSpheres(case["spheres"], case["owner"],
                                         N).plan(block)
                hmap = xops.paint(plan, pb, po, tb, to, nhosts)
                ncell = hmap[0].numel()
                sectors = sum(int(torch.unique((h * ncell + c) // 32).numel())
                              for h in range(nhosts))
                got = xops.count(c, block, N, pb, po, nhosts, hmap=hmap)
                same = all(torch.equal(g, r) for g, r in zip(
                    got, xops.count_plain(c, block, N, pb, po, nhosts,
                                          hmap=hmap)))
                report(f"K15 request maps, {nhosts} hosts", N,
                       lambda: xops.count(c, block, N, pb, po, nhosts,
                                          hmap=hmap),
                       n * (8 + 4 * W) + counts_bytes + 32 * sectors, cs,
                       rows=n, sectors=sectors, identical=same)
                del hmap
            del case, got
    if ooc_n:
        p = cs.params_for(ooc_n, ooc="on")
        cosmo = Cosmology(p)
        for run in range(2):
            res = fmax_ooc.run_fmax_ooc(p, cosmo, dev)
            res.pending_fetch.join()
            t = {k: res.timings.get(k, float("nan"))
                 for k in ("sources", "fold", "spectra", "lpt_rows", "lpt")}
            print(f"[{ooc_n}^3] run_fmax_ooc {run + 1}: "
                  + ", ".join(f"{k} {v:.4f} s" for k, v in t.items()),
                  flush=True)
            print(json.dumps(dict(name="run_fmax_ooc", N=ooc_n, run=run,
                                  **t)), flush=True)
            del res


if __name__ == "__main__":
    sys.exit(main())
