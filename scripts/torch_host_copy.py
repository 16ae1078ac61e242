#!/usr/bin/env python3
"""Device-to-host copies of the out-of-core engine's products on one GPU,
five ways.

The engine ends with the needed cells' products on the card: the cell
indices (int64), F (float32) and the [count, 3] float32 rows of each
displacement field.  Each buffer is copied to the host, as
pinocchio_tpu_torch/kernels/__init__.py:to_host does, into

  engine    page-locked memory of the buffer's size rounded up to 2 MiB
            (cudaHostAlloc through the port's kernel library,
            kernels.pinned_empty), the engine's way;
  exact     the same, allocated at the buffer's exact size;
  pow2      the same, allocated at the next power of two;
  pageable  ordinary host memory (Tensor.cpu());
  cached    PyTorch's pinned allocator (torch.empty(pin_memory=True)),
            which rounds each buffer up to a power of two and keeps it
            cached after it is freed, so a second round reuses it.

Each way named in --ways runs in turn, in that order; a round copies every
buffer and frees the host copies.  Prints seconds, GB/s and the host's
MemAvailable per round, then one JSON line.

    python3 scripts/torch_host_copy.py [--count 704237034] [--fields 4]
        [--ways engine,exact,pow2,pageable,cached,cached]

The default count is the needed cells of the 1024^3 classic run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mem_available() -> float:
    with open("/proc/meminfo") as fd:
        for line in fd:
            if line.startswith("MemAvailable:"):
                return float(line.split()[1]) * 1024.0
    return float("nan")


def main() -> int:
    import torch
    from pinocchio_tpu_torch import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count", type=int, default=704237034)
    ap.add_argument("--fields", type=int, default=4)
    ap.add_argument("--ways", default="engine,exact,pow2,pageable,cached,"
                    "cached")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_host_copy.py: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    n = args.count
    bufs = [torch.zeros(n, dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev)]
    bufs += [torch.zeros((n, 3), dtype=torch.float32, device=dev)
             for _ in range(args.fields)]
    nbytes = sum(b.numel() * b.element_size() for b in bufs)
    torch.cuda.synchronize()

    kernels.lib()                                  # built before timing

    def pinned(t, align):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        size = t.numel() * t.element_size()
        host = torch.from_numpy(kernels.pinned_empty(tuple(t.shape), dtype,
                                                     align(size)))
        host.copy_(t)
        return host

    def cached(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    ways = {"engine": lambda t: pinned(t, lambda b: kernels.PINNED_ALIGN),
            "exact": lambda t: pinned(t, lambda b: 1),
            "pow2": lambda t: pinned(t, lambda b: 1 << (b - 1).bit_length()),
            "pageable": lambda t: t.cpu(), "cached": cached}
    rounds = []
    for name in args.ways.split(","):
        before = mem_available()
        t0 = time.perf_counter()
        hosts = [ways[name](b) for b in bufs]
        secs = time.perf_counter() - t0
        held = before - mem_available()
        del hosts
        rounds.append(dict(way=name, seconds=secs,
                           gb_per_s=nbytes / secs / 1e9,
                           host_bytes_held=held,
                           mem_available_before=before))
        print(f"{name:9s} {secs:8.3f} s  {nbytes / secs / 1e9:6.2f} GB/s  "
              f"host memory taken {held / 2 ** 30:7.2f} GiB of "
              f"{nbytes / 2 ** 30:.2f} GiB copied (MemAvailable before "
              f"{before / 2 ** 30:.2f} GiB)", flush=True)
    print(json.dumps(dict(card=card, count=n, fields=args.fields,
                          bytes=nbytes, rounds=rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
