"""K16's launch path (ops/exchange.py) on the CPU: the hand-over of its
arguments to the C entry point of csrc/exchange.cu, looked up in the kernel
library once and called through ctypes against the argtypes of
kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the same entry point
stands in for it and records the arguments each call receives: every
pointer, the counts and table widths (count, the bitmask words W, the
hosts H, ndmax, the row channels) and the stream, in the order of the C
prototype.  The kernel's float offsets are 64-bit and its ranks 32-bit:
a shard whose float offsets (count * (2 + 3 nch)) pass 2^31 - 1 is handed
over as any other, and one of 2^32 rows or more is refused.
"""

import ctypes
import subprocess

import pytest
import torch

from pinocchio_tpu_torch import kernels
from pinocchio_tpu_torch.ops import exchange as xops

STUB = r"""
#include <stdint.h>
int64_t seen[15];
#define P(x) ((int64_t)(intptr_t)(x))
int exchange_pack(const void* perm, const void* buf, int64_t count,
                  const void* bits, int W, const void* block_off, int H,
                  const void* host_nd, const void* host_devs, int ndmax,
                  const void* seg_base, const void* seg_n, int nch,
                  void* out, void* stream) {
  int64_t v[] = {P(perm), P(buf), count, P(bits), W, P(block_off), H,
                 P(host_nd), P(host_devs), ndmax, P(seg_base), P(seg_n),
                 nch, P(out), P(stream)};
  for (int i = 0; i < 15; ++i) seen[i] = v[i];
  return 0;
}
"""

STREAM = (1 << 44) + 56


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub library, bound as kernels.lib() binds the kernel library,
    standing in for it."""
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)), ["exchange_pack"])
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(xops, "_PACK", None)
    return lib


def _tables(count, nhosts, nch, ndmax=3, ndest=5):
    """K16's tensors for a shard of count rows (each a distinct small
    tensor: the hand-over reads their pointers and widths only)."""
    W = xops.words(nhosts)
    nb = -(-min(count, 4096) // xops.THREADS)
    return dict(perm=torch.zeros(3, dtype=torch.int64),
                buf=torch.zeros(2 + 3 * nch),
                bits=torch.zeros((2, W), dtype=torch.int32),
                block_off=torch.zeros((nb, nhosts), dtype=torch.int64),
                host_nd=torch.ones(nhosts, dtype=torch.int32),
                host_devs=torch.zeros((nhosts, ndmax), dtype=torch.int32),
                seg_base=torch.zeros(ndest, dtype=torch.int64),
                seg_n=torch.zeros(ndest, dtype=torch.int64),
                out=torch.zeros(7))


def _hand_over(stub, count, nhosts, nch):
    t = _tables(count, nhosts, nch)
    assert xops.launch_pack(t["perm"], t["buf"], count, t["bits"],
                            t["block_off"], t["host_nd"], t["host_devs"],
                            t["seg_base"], t["seg_n"], nch, t["out"],
                            STREAM) == 0
    seen = list((ctypes.c_int64 * 15).in_dll(stub, "seen"))
    want = [t["perm"].data_ptr(), t["buf"].data_ptr(), count,
            t["bits"].data_ptr(), xops.words(nhosts),
            t["block_off"].data_ptr(), nhosts, t["host_nd"].data_ptr(),
            t["host_devs"].data_ptr(), 3, t["seg_base"].data_ptr(),
            t["seg_n"].data_ptr(), nch, t["out"].data_ptr()]
    assert seen == want + [STREAM]


@pytest.mark.parametrize("nhosts,nch", [(2, 4), (1, 1), (33, 8), (16, 0)])
def test_arguments_in_prototype_order(stub, nhosts, nch):
    """A main-path shard (2 hosts, 4 channels) and others: every argument
    in the order of the C prototype, the entry point looked up once."""
    _hand_over(stub, 2_520_000, nhosts, nch)
    entry = xops._PACK
    assert entry is not None and entry.__name__ == "exchange_pack"
    _hand_over(stub, 5, nhosts, nch)
    assert xops._PACK is entry


@pytest.mark.parametrize("nch", [0, 1, 4, 16])
def test_counts_past_32_bits_take_the_64_bit_path(stub, nch):
    """The kernel's 64-bit float offsets: the shards just below and from
    the first whose float offsets reach 2^31 are handed over whole, up to
    2^32 - 1 rows (32-bit ranks); 2^32 rows raise before any call."""
    rowf = 2 + 3 * nch
    edge = -(-2 ** 31 // rowf)                  # least count with offsets
    assert edge * rowf >= 2 ** 31 > (edge - 1) * rowf      # past 2^31 - 1
    for count in (edge - 1, edge, 2 ** 32 - 1):
        _hand_over(stub, count, 2, nch)
    (ctypes.c_int64 * 15).in_dll(stub, "seen")[2] = 0
    t = _tables(2 ** 32, 2, nch)
    with pytest.raises(ValueError, match="at most 2\\^32 - 1"):
        xops.launch_pack(t["perm"], t["buf"], 2 ** 32, t["bits"],
                         t["block_off"], t["host_nd"], t["host_devs"],
                         t["seg_base"], t["seg_n"], nch, t["out"], STREAM)
    assert (ctypes.c_int64 * 15).in_dll(stub, "seen")[2] == 0
