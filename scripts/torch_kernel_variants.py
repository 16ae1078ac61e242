"""Design variants of the shard window kernel (K2s, K5s), of K12, of K4
and of K15 timed beside the library's own, on the card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_kernel_variants.py [--sizes 256,512]
        [--kernels window,vrows,lpt,count]

Each variant is the repository's source with one change, built by nvcc
(the library's flags) into pinocchio_tpu_torch/build/variants/ and called
through its C entry point with the wrapper's arguments:
- window kernel: kPairs (pairs of modes a thread) 1, 2 (the library's)
  and 4;
- K12: the library's grid-stride loop over quads at 2 blocks an SM (a
  thread loads its next quad before it stores the current one's rows),
  the same at 4; one quad a thread over a grid of every quad; and that
  asking L2 for the sectors of the quad's needed rows (prefetch.global.L2)
  right after the rank load, before the component loads;
- K4: the library's one quad a thread over a grid of every quad, plain
  loads in the stacks' forms and evict-first in the pair's; evict-first
  in every form; plain in every form; and a grid-stride loop over 6
  blocks an SM of 132 (the sources kernel's residency), with the library's
  loads and with evict-first in every form (the sources on the dense
  stack and on an x-slab, the six pairs, one pair on an x-slab);
- K15: the library's box masks on a grid of the resident blocks, each
  warp walking its runs of 256 rows; the boxes tested in turn (the loop
  the masks replace where their tables fit); the masks with a warp for
  every run; and the masks with each warp loading its next run's cells
  before it tests the current one's (2 and 16 hosts).
Every variant's output must equal the library's bit for bit. A shard is
the (1, 1) shard of a 2x2 pencil mesh's k layout; K12 scatters the first
x-slab of a field with two thirds of its cells needed in a random order
into the rows buffer of all needed cells (0.66 N^3 rows, past L2), and
also the bare scatter of the same rows by index_copy_ (their values and
ranks gathered beforehand) as a yardstick.  Times: 20 calls back to back,
the median of 5 CUDA-event runs.  Prints the card's name and power limit
first.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K12 one quad a thread over a grid of every quad (the design before the
# grid-stride loop), and the same asking L2 for the sectors of the quad's
# needed rows (prefetch.global.L2) right after its rank load
LOOP_AT = """  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int4 r = make_int4(-1, -1, -1, -1);
  float4 a{}, b{}, c{};
  if (q < nquad) vrows_load(rank, comps, n, head + 4 * q, r, a, b, c);
  while (q < nquad) {
    // the next quad's loads in flight before this one's stores
    const int64_t qn = q + stride;
    int4 rn = make_int4(-1, -1, -1, -1);
    float4 an{}, bn{}, cn{};
    if (qn < nquad) vrows_load(rank, comps, n, head + 4 * qn, rn, an, bn, cn);
    if (r.x >= 0) vrow_store(rows, r.x, a.x, b.x, c.x, pairs);
    if (r.y >= 0) vrow_store(rows, r.y, a.y, b.y, c.y, pairs);
    if (r.z >= 0) vrow_store(rows, r.z, a.z, b.z, c.z, pairs);
    if (r.w >= 0) vrow_store(rows, r.w, a.w, b.w, c.w, pairs);
    q = qn;
    r = rn;
    a = an;
    b = bn;
    c = cn;
  }
}"""
ONE_QUAD = """  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= nquad) return;
  const int64_t i = head + 4 * q;
  const int4 r = __ldcs(reinterpret_cast<const int4*>(rank + i));
  if ((r.x & r.y & r.z & r.w) < 0) return;    // none of the four needed
  PREFETCH
  const float4 a = __ldcs(reinterpret_cast<const float4*>(comps + i));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(comps + n + i));
  const float4 c = __ldcs(reinterpret_cast<const float4*>(comps + 2 * n + i));
  if (r.x >= 0) vrow_store(rows, r.x, a.x, b.x, c.x, pairs);
  if (r.y >= 0) vrow_store(rows, r.y, a.y, b.y, c.y, pairs);
  if (r.z >= 0) vrow_store(rows, r.z, a.z, b.z, c.z, pairs);
  if (r.w >= 0) vrow_store(rows, r.w, a.w, b.w, c.w, pairs);
}"""
PREFETCH = """{
    const int rr[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (rr[e] >= 0) {
        const float* row = rows + 3 * (int64_t)rr[e];
        asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(row + 2));
      }
  }"""
GRID_AT = """(int64_t)kVrowsBlocksPerSM * sms));"""
GRID_ALL = """(nquad + kThreads - 1) / kThreads));"""
PER_SM = "constexpr int kVrowsBlocksPerSM = 2;"


# K4: the stacks' loads and the pair's (evict-first), and the grid
LPT_PLAIN = "return *reinterpret_cast<const float4*>(p);"
LPT_ONCE = "return __ldcs(reinterpret_cast<const float4*>(p));"
LPT_QUAD = """  if (q < nquad) op.quad(head + 4 * q);"""
LPT_LOOP = """\
  for (int64_t i = q; i < nquad; i += (int64_t)gridDim.x * kThreads)
    op.quad(head + 4 * i);"""
LPT_GRID = "std::max<int64_t>(1, (nquad + kThreads - 1) / kThreads);"
LPT_GRID6 = ("std::max<int64_t>(1, std::min<int64_t>("
             "(nquad + kThreads - 1) / kThreads, 6 * 132));")
COUNT_MODE = "CountMode mode = map != nullptr ? kMaps : kBoxMasks;"
# K15 loading a warp's next run's cells before it tests the current one's
COUNT_NOW = """  for (int64_t run = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       run < nruns; run += (int64_t)gridDim.x * kWarps) {
    int64_t c[kCountRows];
    load_run(cells, n, vec, run, lane, c);
"""
COUNT_AHEAD = """  const int64_t step = (int64_t)gridDim.x * kWarps;
  int64_t run = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int64_t next[kCountRows];
  if (run < nruns) load_run(cells, n, vec, run, lane, next);
  for (; run < nruns; run += step) {
    int64_t c[kCountRows];
#pragma unroll
    for (int j = 0; j < kCountRows; ++j) c[j] = next[j];
    if (run + step < nruns) load_run(cells, n, vec, run + step, lane, next);
"""
COUNT_GRID_AT = "fn<<<(unsigned)std::min(blocks, most),"
COUNT_GRID_ALL = "fn<<<(unsigned)blocks,"
ENTRIES = {"window": ("kspace_hessian_shard", "kspace_gradient_shard"),
           "vrows": ("vrows_slab",),
           "lpt": ("lpt_pointwise", "lpt_accumulate", "lpt_accumulate_one"),
           "count": ("exchange_count",)}


def variants():
    """{name: (source file, text changes (old, new))}."""
    pairs = "constexpr int kPairs = 2;"
    return {
        "lpt_every_quad": ("lpt.cu",),
        "lpt_every_quad_once": ("lpt.cu", (LPT_PLAIN, LPT_ONCE)),
        "lpt_every_quad_plain": ("lpt.cu", (LPT_ONCE, LPT_PLAIN)),
        "lpt_loop6": ("lpt.cu", (LPT_QUAD, LPT_LOOP), (LPT_GRID, LPT_GRID6)),
        "lpt_loop6_once": ("lpt.cu", (LPT_QUAD, LPT_LOOP),
                           (LPT_GRID, LPT_GRID6), (LPT_PLAIN, LPT_ONCE)),
        "count_masks": ("exchange.cu",),
        "count_loop": ("exchange.cu", (COUNT_MODE, COUNT_MODE.replace(
            "kBoxMasks", "kBoxLoop"))),
        "count_every_run": ("exchange.cu", (COUNT_GRID_AT, COUNT_GRID_ALL)),
        "count_ahead": ("exchange.cu", (COUNT_NOW, COUNT_AHEAD)),
        "window_pairs1": ("kspace.cu", (pairs, "constexpr int kPairs = 1;")),
        "window_pairs2": ("kspace.cu",),
        "window_pairs4": ("kspace.cu", (pairs, "constexpr int kPairs = 4;")),
        "vrows_loop2": ("compact.cu",),
        "vrows_loop4": ("compact.cu",
                        (PER_SM, "constexpr int kVrowsBlocksPerSM = 4;")),
        "vrows_one_quad": ("compact.cu",
                           (LOOP_AT, ONE_QUAD.replace("PREFETCH", "")),
                           (GRID_AT, GRID_ALL)),
        "vrows_one_quad_prefetch": ("compact.cu",
                                    (LOOP_AT, ONE_QUAD.replace("PREFETCH",
                                                               PREFETCH)),
                                    (GRID_AT, GRID_ALL)),
    }


def build_all(kernels, out_dir, which):
    """Build the variants of the kernels ``which`` in parallel; {name:
    ctypes library}."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for name, (src, *changes) in variants().items():
        if name.split("_")[0] not in which:
            continue
        with open(os.path.join(kernels.CSRC, src)) as fd:
            text = fd.read()
        for change in changes:
            assert text.count(change[0]) == 1, (name, change[0])
            text = text.replace(change[0], change[1])
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as fd:
            fd.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        cmd = [nvcc] + kernels.NVCC_FLAGS + ["-shared", "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = kernels.bind(ctypes.CDLL(so),
                                  ENTRIES[name.split("_")[0]])
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="256,512")
    ap.add_argument("--kernels", default="window,vrows,lpt,count")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants.py: no CUDA device available",
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
    libs = build_all(kernels, os.path.join(kernels.BUILD, "variants"),
                     which)
    gen = torch.Generator(device=dev)
    for N in (int(n) for n in args.sizes.split(",")):
        gen.manual_seed(N)
        stream = kernels.stream_ptr(dev)
        if "lpt" in which:
            lpt_variants(N, dev, gen, libs, stream, cs, kernels)
        if "count" in which:
            count_variants(N, dev, libs, stream, cs, kernels)
        if not which & {"window", "vrows"}:
            continue
        decomp = pfft.make_decomp(pfft.make_pencil_mesh(4, devices=[dev] * 4),
                                  N)
        y0, ny, z0, nz = decomp.k_window(3)
        src = torch.randn((N, ny, nz), dtype=torch.complex64, generator=gen,
                          device=dev)
        for entry, ncomp, arg, per_mode, want_fn in () if (
                "window" not in which) else (
                ("kspace_hessian_shard", 6, 0.0, 56,
                 lambda: derivatives.hessian_kspace_shard(src, 0.0, N, y0,
                                                          z0)),
                ("kspace_gradient_shard", 3, 0.8, 32,
                 lambda: derivatives.gradient_kspace_shard(src, 0.8, N, y0,
                                                           z0))):
            want = want_fn()
            bound = 1e3 * per_mode * N * ny * nz / cs.PEAK_BYTES
            for name, lib in libs.items():
                if not name.startswith("window"):
                    continue
                out = torch.empty((ncomp, N, ny, nz), dtype=torch.complex64,
                                  device=dev)
                fn = getattr(lib, entry)

                def call():
                    kernels.check(name, fn(src.data_ptr(), out.data_ptr(), N,
                                           y0, ny, z0, nz, arg, stream))
                call()
                torch.cuda.synchronize()
                same = cs.same_bits(out, want)
                batch = cs.batch_ms(call)
                print(f"[{N}^3] {entry:<22s} {name:<15s} back to back "
                      f"{batch:.4f} ms ({batch / bound:.2f}x the bound "
                      f"{bound:.4f}), bits {'equal' if same else 'DIFFER'}",
                      flush=True)
            del want
        del src
        cells = N ** 3
        need = torch.randperm(cells, generator=gen,
                              device=dev)[:2 * cells // 3]
        rank = compact.needed_rank(need, cells)
        n_slab = 16 * N * N
        rk = rank[:n_slab]
        comps = torch.randn((3, n_slab), generator=gen, device=dev)
        want = torch.zeros((need.numel(), 3), device=dev)
        compact.vrows_slab(rk, comps, want)
        r64 = rk[rk >= 0].long()
        sectors = torch.unique(torch.cat([(12 * r64) // 32,
                                          (12 * r64 + 11) // 32])).numel()
        floor = 1e3 * (64 * sectors + 16 * n_slab) / cs.PEAK_BYTES
        for name, lib in libs.items():
            if not name.startswith("vrows"):
                continue
            rows = torch.zeros_like(want)

            def call():
                kernels.check(name, lib.vrows_slab(
                    rk.data_ptr(), comps.data_ptr(), n_slab, rows.data_ptr(),
                    stream))
            call()
            torch.cuda.synchronize()
            same = torch.equal(rows, want)
            batch = cs.batch_ms(call)
            print(f"[{N}^3] vrows_slab             {name:<15s} back to back "
                  f"{batch:.4f} ms ({batch / floor:.2f}x the sector floor "
                  f"{floor:.4f}), {'equal' if same else 'DIFFER'}",
                  flush=True)
        if "vrows" not in which:
            continue
        vals = comps[:, rk >= 0].T.contiguous()
        rows = torch.zeros_like(want)
        bare = cs.batch_ms(lambda: rows.index_copy_(0, r64, vals))
        print(f"[{N}^3] vrows_slab             bare index_copy_ of the "
              f"{r64.numel()} rows: back to back {bare:.4f} ms "
              f"({bare / floor:.2f}x the sector floor)", flush=True)
        del rank, rk, comps, want, rows, need, r64, vals
        torch.cuda.empty_cache()
    return 0


def lpt_variants(N, dev, gen, libs, stream, cs, kernels):
    """K4's forms through each variant's entry points, back to back."""
    import torch
    from pinocchio_tpu_torch import fmax_ooc
    from pinocchio_tpu_torch.ops import lpt
    Bx = fmax_ooc.slab_width(N)
    sd = torch.randn((6, N, N, N), generator=gen, device=dev)
    phi2 = torch.randn((6, N, N, N), generator=gen, device=dev)
    slab = sd[:, Bx:2 * Bx].contiguous()
    src = torch.randn((N, N, N), generator=gen, device=dev)
    u = torch.stack([sd[3, Bx:2 * Bx], phi2[3, Bx:2 * Bx]])
    out = src[Bx:2 * Bx]
    n, ns = N ** 3, Bx * N * N
    forms = {
        "sources": (lambda lib, o: lib.lpt_pointwise(
            sd.data_ptr(), o.data_ptr(), n, stream), (3, N, N, N),
            lambda: torch.stack(lpt.sources_pointwise_plain(sd)), 36 * n),
        "sources slab": (lambda lib, o: lib.lpt_pointwise(
            slab.data_ptr(), o.data_ptr(), ns, stream), (3, Bx, N, N),
            lambda: torch.stack(lpt.sources_pointwise_plain(slab)), 36 * ns),
        "six pairs": (lambda lib, o: lib.lpt_accumulate(
            phi2.data_ptr(), sd.data_ptr(), o.data_ptr(), n, stream),
            src, lambda: lpt.src32_accumulate_plain(phi2, sd, src), 56 * n),
        "one pair": (lambda lib, o: lib.lpt_accumulate_one(
            u[1].data_ptr(), u[0].data_ptr(), o.data_ptr(), ns, 4.0, stream),
            out, lambda: lpt.src32_accumulate_plain(u[1:2], u[0:1], out,
                                                    (2.0,)), 16 * ns),
    }
    for form, (call, like, plain, nbytes) in forms.items():
        want = plain()
        bound = 1e3 * nbytes / cs.PEAK_BYTES
        for name, lib in libs.items():
            if not name.startswith("lpt"):
                continue
            o = (torch.empty(like, device=dev) if isinstance(like, tuple)
                 else like.clone())
            kernels.check(name, call(lib, o))
            torch.cuda.synchronize()
            same = cs.same_bits(o, want)
            if not isinstance(like, tuple):
                o = like.clone()       # the accumulations time in place
            batch = cs.batch_ms(lambda: kernels.check(name, call(lib, o)))
            print(f"[{N}^3] K4 {form:<12s} {name:<21s} back to back "
                  f"{batch:.4f} ms ({batch / bound:.2f}x the bound "
                  f"{bound:.4f}), bits {'equal' if same else 'DIFFER'}",
                  flush=True)
        del want
    del sd, phi2, slab, src, u, out
    torch.cuda.empty_cache()


def count_variants(N, dev, libs, stream, cs, kernels):
    """K15 through each variant's entry point on chip_smoke.py's inputs,
    back to back."""
    import torch
    from pinocchio_tpu_torch.ops import exchange as xops
    for nhosts in (cs.HOSTS, 16):
        case = cs.exchange_inputs(N, dev, nhosts)
        pb, po = case["tables"][:2]
        block, c = case["block"], case["cells"]
        n = c.numel()
        want = xops.count_plain(c, block, N, pb, po, nhosts)
        bound = 1e3 * (n * (8 + 4 * want[0].shape[1])
                       + 4 * want[1].numel()) / cs.PEAK_BYTES
        blk = (ctypes.c_int * 6)(*block)
        for name, lib in libs.items():
            if not name.startswith("count"):
                continue
            bits, counts = torch.empty_like(want[0]), torch.empty_like(
                want[1])

            def call():
                kernels.check(name, lib.exchange_count(
                    c.data_ptr(), n, blk, N, pb.data_ptr(), pb.shape[0],
                    po.data_ptr(), None, nhosts, bits.data_ptr(),
                    counts.data_ptr(), 0, stream))
            call()
            torch.cuda.synchronize()
            same = torch.equal(bits, want[0]) and torch.equal(counts, want[1])
            batch = cs.batch_ms(call)
            print(f"[{N}^3] K15 {nhosts:2d} hosts {name:<17s} back to back "
                  f"{batch:.4f} ms ({batch / bound:.2f}x the bound "
                  f"{bound:.4f}), {'equal' if same else 'DIFFER'}",
                  flush=True)
        del case, want
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
