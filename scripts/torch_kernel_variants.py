"""Design variants of the shard window kernel (K2s, K5s) and of K12 timed
beside the library's own, on the card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_kernel_variants.py [--sizes 256,512]

Each variant is the repository's source with one change, built by nvcc
(the library's flags) into pinocchio_tpu_torch/build/variants/ and called
through its C entry point with the wrapper's arguments:
- window kernel: kPairs (pairs of modes a thread) 1, 2 (the library's)
  and 4;
- K12: the library's grid-stride loop over quads at 2 blocks an SM (a
  thread loads its next quad before it stores the current one's rows),
  the same at 4; one quad a thread over a grid of every quad; and that
  asking L2 for the sectors of the quad's needed rows (prefetch.global.L2)
  right after the rank load, before the component loads.
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


def variants():
    """{name: (source file, text changes (old, new))}."""
    pairs = "constexpr int kPairs = 2;"
    return {
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


def build_all(kernels, out_dir):
    """Build every variant in parallel; {name: ctypes library}."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for name, (src, *changes) in variants().items():
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
        entries = (("kspace_hessian_shard", "kspace_gradient_shard")
                   if name.startswith("window") else ("vrows_slab",))
        libs[name] = kernels.bind(ctypes.CDLL(so), entries)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="256,512")
    args = ap.parse_args(argv)
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
    libs = build_all(kernels, os.path.join(kernels.BUILD, "variants"))
    gen = torch.Generator(device=dev)
    for N in (int(n) for n in args.sizes.split(",")):
        gen.manual_seed(N)
        stream = kernels.stream_ptr(dev)
        decomp = pfft.make_decomp(pfft.make_pencil_mesh(4, devices=[dev] * 4),
                                  N)
        y0, ny, z0, nz = decomp.k_window(3)
        src = torch.randn((N, ny, nz), dtype=torch.complex64, generator=gen,
                          device=dev)
        for entry, ncomp, arg, per_mode, want_fn in (
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
        vals = comps[:, rk >= 0].T.contiguous()
        rows = torch.zeros_like(want)
        bare = cs.batch_ms(lambda: rows.index_copy_(0, r64, vals))
        print(f"[{N}^3] vrows_slab             bare index_copy_ of the "
              f"{r64.numel()} rows: back to back {bare:.4f} ms "
              f"({bare / floor:.2f}x the sector floor)", flush=True)
        del rank, rk, comps, want, rows, need, r64, vals
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
