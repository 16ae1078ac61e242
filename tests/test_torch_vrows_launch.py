"""K12's launch path (ops/compact.py) on the CPU: the hand-over of its
arguments to the C entry point vrows_slab of csrc/compact.cu, looked up in
the kernel library once, through ctypes against the argtypes of
kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the entry point stands in
for it and records the arguments each call receives, and the current
stream is a fixed number.  The engine's slabs of a rank field (the first, a
middle and the last, and a view off the 16-byte grid) reach it with the
pointers of rank, the components and the rows buffer, n as a plain 64-bit
int and the stream, in the C prototype's order, and the launch is counted;
a wrong type, shape, layout or device raises before any call, and a CPU
slab takes the plain version.
"""

import ctypes
import subprocess

import pytest
import torch

from pinocchio_tpu_torch import kernels
from pinocchio_tpu_torch.ops import compact

STUB = r"""
#include <stdint.h>
int64_t seen[5];
int calls;
#define P(x) ((int64_t)(intptr_t)(x))
int vrows_slab(const void* rank, const void* comps, int64_t n, void* rows,
               void* st) {
  int64_t v[] = {P(rank), P(comps), n, P(rows), P(st)};
  for (int i = 0; i < 5; ++i) seen[i] = v[i];
  ++calls;
  return 0;
}
"""

N = 32
BX = 4
STREAM = (1 << 45) + 72


class Lookups:
    """Counts the kernel library's attribute lookups."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        self.names.append(name)
        return getattr(self.lib, name)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)), ("vrows_slab",))
    looked = Lookups(lib)
    monkeypatch.setattr(kernels, "lib", lambda: looked)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: STREAM)
    monkeypatch.setattr(compact, "_VROWS", [])
    return lib, looked


def _seen(lib):
    return (list((ctypes.c_int64 * 5).in_dll(lib, "seen")),
            ctypes.c_int.in_dll(lib, "calls").value)


def _slabs():
    """The rank of a 32^3 field (every third cell needed) cut into the
    engine's x-slabs of BX planes: (rank view, comps, rows) of the first,
    a middle and the last slab, and of a view one cell off the 16-byte
    grid."""
    n3, n = N ** 3, BX * N * N
    rank = torch.full((n3,), -1, dtype=torch.int32)
    need = torch.arange(0, n3, 3)
    rank[need] = torch.randperm(need.numel(), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(0))
    rows = torch.zeros((need.numel(), 3))
    out = []
    for x in (0, N // 2, N - BX):
        out.append((rank[x * N * N:x * N * N + n], torch.zeros((3, n)), rows))
    out.append((rank[1:1 + n], torch.zeros((3, n + 1))[:, 1:].contiguous(),
                rows))
    return out


def test_each_slab_hands_its_arguments_over(stub):
    lib, looked = stub
    before = kernels.LAUNCHES["vrows_slab"]
    slabs = _slabs()
    for rank, comps, rows in slabs:
        assert compact.launch_vrows(rank, comps, rows) is rows
        seen, _ = _seen(lib)
        assert seen == [rank.data_ptr(), comps.data_ptr(), rank.numel(),
                        rows.data_ptr(), STREAM]
    assert kernels.LAUNCHES["vrows_slab"] == before + len(slabs)
    assert looked.names == ["vrows_slab"]               # looked up once
    assert compact._vrows_entry().__name__ == "vrows_slab"


def test_the_wrapper_launches_a_card_slab(stub, monkeypatch):
    """vrows_slab on a CUDA slab (standing for itself through is_cuda)
    goes to the launch."""
    lib, _ = stub
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    rank, comps, rows = _slabs()[1]
    compact.vrows_slab(rank, comps, rows)
    assert _seen(lib) == ([rank.data_ptr(), comps.data_ptr(), rank.numel(),
                           rows.data_ptr(), STREAM], 1)


@pytest.mark.parametrize("bad", ["rank_dtype", "comps_dtype", "rows_dtype",
                                 "comps_shape", "rows_shape", "rank_dim",
                                 "strided", "device"])
def test_wrong_slabs_are_refused(stub, bad):
    lib, _ = stub
    rank, comps, rows = _slabs()[0]
    if bad == "rank_dtype":
        rank = rank.long()
    elif bad == "comps_dtype":
        comps = comps.double()
    elif bad == "rows_dtype":
        rows = rows.double()
    elif bad == "comps_shape":
        comps = comps[:2]
    elif bad == "rows_shape":
        rows = torch.zeros((rows.shape[0], 4))
    elif bad == "rank_dim":
        rank = rank.reshape(BX, -1)
    elif bad == "strided":
        comps = torch.zeros((rank.numel(), 3)).T
    else:
        rows = torch.zeros(rows.shape, device="meta")
    before = kernels.LAUNCHES["vrows_slab"]
    with pytest.raises(ValueError, match="vrows_slab"):
        compact.launch_vrows(rank, comps, rows)
    assert kernels.LAUNCHES["vrows_slab"] == before
    assert _seen(lib)[1] == 0


def test_the_cpu_takes_the_plain_version_and_others_raise():
    rank, comps, rows = _slabs()[3]
    comps = torch.randn(comps.shape)
    got = compact.vrows_slab(rank, comps, rows.clone())
    want = compact.vrows_slab_plain(rank, comps, rows.clone())
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unsupported device"):
        compact.vrows_slab(rank, comps.to("meta"), rows)
