#!/usr/bin/env python3
"""The threefry2x32 draw of K1 alone on one GPU, two ways.

K1 (pinocchio_tpu_torch/csrc/ic_kdensity.cu) spends most of its
instructions in threefry_bits: 20 rounds of an add, a 32-bit rotation and
an exclusive or, on 32-bit integers.  This script builds a small CUDA
library that includes the kernel's source, so its threefry_bits is the one
timed, and times 2^26 draws (8 a thread, their sum written per thread, so
that the writes cost nothing) two ways:

  funnel    threefry_bits as the kernel has it: the rotation as two shifts
            and an or, which the compiler turns into one funnel shift;
  multiply  the same rounds with the rotation as the low and the high half
            of a multiply by 2^r (a power of two the compiler cannot see),
            which moves it from the integer pipe to the multiply-add pipe.

Both must give the same bits.  Prints the card's name and power limit,
each way's milliseconds and picoseconds a draw (median of 5 CUDA-event runs
of 10 launches), the opcode mix of the SASS of the funnel way's loop (one
draw an iteration) and of K1's kernel (all its paths; the listing is
written to pinocchio_tpu_torch/build/kdensity_kernel.sass), then one JSON
line.

    python3 scripts/torch_threefry_probe.py

It builds into pinocchio_tpu_torch/build/ (listed in .gitignore) with the
kernels' flags.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pinocchio_tpu_torch import kernels  # noqa: E402

SOURCE = r"""
#include "%(csrc)s/ic_kdensity.cu"

namespace {
__constant__ uint32_t kPow2[32];

template <int R>
__device__ __forceinline__ uint32_t rotl_mul(uint32_t x) {
  uint32_t lo, hi;
  asm("mul.lo.u32 %%0, %%1, %%2;" : "=r"(lo) : "r"(x), "r"(kPow2[R]));
  asm("mul.hi.u32 %%0, %%1, %%2;" : "=r"(hi) : "r"(x), "r"(kPow2[R]));
  return lo | hi;
}

#define MUL_ROUND(r) x0 += x1; x1 = rotl_mul<r>(x1); x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_mul(uint32_t k0, uint32_t k1,
                                                 uint64_t counter) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(counter >> 32) + k0;
  uint32_t x1 = (uint32_t)(counter & 0xffffffffu) + k1;
  MUL_ROUND(13) MUL_ROUND(15) MUL_ROUND(26) MUL_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  MUL_ROUND(17) MUL_ROUND(29) MUL_ROUND(16) MUL_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  MUL_ROUND(13) MUL_ROUND(15) MUL_ROUND(26) MUL_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  MUL_ROUND(17) MUL_ROUND(29) MUL_ROUND(16) MUL_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  MUL_ROUND(13) MUL_ROUND(15) MUL_ROUND(26) MUL_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

template <bool MUL>
__global__ void __launch_bounds__(256)
draws(uint32_t* out, uint32_t k0, uint32_t k1, uint32_t n) {
  const uint32_t i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  uint32_t acc = 0;
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const uint64_t c = (uint64_t)i * 8 + j;
    acc += MUL ? threefry_mul(k0, k1, c) : threefry_bits(k0, k1, c);
  }
  out[i] = acc;
}
}  // namespace

extern "C" int probe_setup() {
  uint32_t p[32];
  for (int r = 0; r < 32; ++r) p[r] = 1u << r;
  return (int)cudaMemcpyToSymbol(kPow2, p, sizeof(p));
}

extern "C" int probe_draws(int mul, void* out, uint32_t k0, uint32_t k1,
                           uint32_t n) {
  const unsigned grid = (n + 255) / 256;
  if (mul)
    draws<true><<<grid, 256>>>((uint32_t*)out, k0, k1, n);
  else
    draws<false><<<grid, 256>>>((uint32_t*)out, k0, k1, n);
  return (int)cudaGetLastError();
}
"""

THREADS = 1 << 23        # 8 draws a thread
# a SASS line's opcode, after its address and any predicate
OPCODE = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
KEYS = (0x12345678, 0x9ABCDEF0)


def build() -> str:
    os.makedirs(kernels.BUILD, exist_ok=True)
    src = os.path.join(kernels.BUILD, "threefry_probe.cu")
    lib = os.path.join(kernels.BUILD, "threefry_probe.so")
    with open(src, "w") as fd:
        fd.write(SOURCE % dict(csrc=kernels.CSRC))
    subprocess.run([kernels._nvcc()] + kernels.NVCC_FLAGS
                   + ["-shared", "-o", lib, src], check=True)
    return lib


def sass_functions(library: str) -> dict:
    """{mangled function name: [SASS lines]} from cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None and re.search(r"/\*[0-9a-f]{4}\*/", line):
            out[name].append(line)
    return out


def opcode_mix(lines) -> dict:
    """{opcode without modifiers: count} of SASS lines, NOPs left out."""
    mix = collections.Counter()
    for line in lines:
        m = OPCODE.search(line)
        if m and m.group(1) != "NOP":
            mix[m.group(1)] += 1
    return dict(mix.most_common())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_threefry_probe.py: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = ctypes.CDLL(build())
    lib.probe_draws.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_uint32, ctypes.c_uint32,
                                ctypes.c_uint32]
    if lib.probe_setup() != 0:
        raise RuntimeError("probe_setup failed")
    outs = {}
    for way, mul in (("funnel", 0), ("multiply", 1)):
        outs[way] = torch.empty(THREADS, dtype=torch.int32, device="cuda")
        if lib.probe_draws(mul, outs[way].data_ptr(), *KEYS, THREADS):
            raise RuntimeError(f"the {way} launch failed")
    torch.cuda.synchronize()
    same = torch.equal(outs["funnel"], outs["multiply"])
    print(f"the two ways give the same bits: {same}", flush=True)
    result = dict(card=card, draws=8 * THREADS, same_bits=same)
    for way, mul in (("funnel", 0), ("multiply", 1)):
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                lib.probe_draws(mul, outs[way].data_ptr(), *KEYS, THREADS)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 10)
        ms = statistics.median(times)
        ps = 1e9 * ms / (8 * THREADS)
        print(f"{way:<9s} {ms:.4f} ms for {8 * THREADS} draws, {ps:.3f} ps "
              "a draw", flush=True)
        result[way] = dict(ms=ms, ps_per_draw=ps)
    probe = sass_functions(lib._name)
    draw = next(v for k, v in probe.items() if "drawsILb0" in k)
    port = sass_functions(kernels.build())
    k1 = next(v for k, v in port.items() if "kdensity_kernel" in k
              and "planes" not in k)
    with open(os.path.join(kernels.BUILD, "kdensity_kernel.sass"),
              "w") as fd:
        fd.write("\n".join(k1) + "\n")
    result["sass"] = dict(draw_loop=opcode_mix(draw),
                          kdensity_kernel=opcode_mix(k1))
    for what, mix in result["sass"].items():
        print(f"SASS of {what}: {sum(mix.values())} instructions, "
              + ", ".join(f"{k} {v}" for k, v in mix.items()), flush=True)
    print(json.dumps(result), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
