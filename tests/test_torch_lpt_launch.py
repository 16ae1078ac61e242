"""K4's launch path (ops/lpt.py) on the CPU: the hand-over of its
arguments to the three C entry points of csrc/lpt.cu (lpt_pointwise,
lpt_accumulate, lpt_accumulate_one), each looked up in the kernel library
once and called through ctypes against the argtypes of kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the same entry points
stands in for it and records the arguments each call receives, and the
current stream is a fixed number.  Every form reaches its entry point
with the tensors' pointers, the cells n of one component as a 64-bit int,
the one-pair weight 2 w as a float and the stream, in the order of the C
prototypes; a slab view off the 16-byte grid or of an odd length is
handed over as any other (the kernel takes its head and tail cell by
cell), and what the kernel does not take is refused before any call.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch import kernels
from pinocchio_tpu_torch.ops import lpt

STUB = r"""
#include <stdint.h>
int64_t seen[6];
float weight;
int calls, which;
#define P(x) ((int64_t)(intptr_t)(x))
int lpt_pointwise(const void* sd, void* out, int64_t n, void* st) {
  int64_t v[] = {P(sd), P(out), n, P(st)};
  for (int i = 0; i < 4; ++i) seen[i] = v[i];
  ++calls;
  which = 0;
  return 0;
}
int lpt_accumulate(const void* phi2, const void* sd, void* src32, int64_t n,
                   void* st) {
  int64_t v[] = {P(phi2), P(sd), P(src32), n, P(st)};
  for (int i = 0; i < 5; ++i) seen[i] = v[i];
  ++calls;
  which = 1;
  return 0;
}
int lpt_accumulate_one(const void* phi2, const void* sd, void* src32,
                       int64_t n, float w2, void* st) {
  int64_t v[] = {P(phi2), P(sd), P(src32), n, P(st)};
  for (int i = 0; i < 5; ++i) seen[i] = v[i];
  weight = w2;
  ++calls;
  which = 2;
  return 0;
}
"""

ENTRIES = ("lpt_pointwise", "lpt_accumulate", "lpt_accumulate_one")
STREAM = (1 << 44) + 24
N = 12
BX = 3


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
    lib = kernels.bind(ctypes.CDLL(str(so)), ENTRIES)
    looked = Lookups(lib)
    monkeypatch.setattr(kernels, "lib", lambda: looked)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: STREAM)
    monkeypatch.setattr(lpt, "_ENTRIES", {})
    return lib, looked


def _seen(lib, k):
    return (list((ctypes.c_int64 * 6).in_dll(lib, "seen"))[:k],
            ctypes.c_int.in_dll(lib, "calls").value,
            ENTRIES[ctypes.c_int.in_dll(lib, "which").value])


def _weight(lib):
    return ctypes.c_float.in_dll(lib, "weight").value


def _stack(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _off_grid(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_each_form_hands_its_arguments_over(stub):
    """The dense stack, an x-slab and a one-pair slab of the fold: every
    argument in the order of the C prototypes, each entry point looked up
    once."""
    lib, looked = stub
    for shape in ((6, N, N, N), (6, BX, N, N)):
        sd = _stack(*shape)
        out = torch.empty((3,) + shape[1:])
        assert lpt.launch_pointwise(sd, out, STREAM) == 0
        n = sd[0].numel()
        assert _seen(lib, 4)[0] == [sd.data_ptr(), out.data_ptr(), n, STREAM]
        phi2, src = _stack(*shape, seed=1), out[2]
        assert lpt.launch_accumulate(phi2, sd, src, STREAM) == 0
        assert _seen(lib, 5)[0] == [phi2.data_ptr(), sd.data_ptr(),
                                    src.data_ptr(), n, STREAM]
        assert lpt.launch_accumulate_one(phi2[3:4], sd[3:4], src, 4.0,
                                         STREAM) == 0
        assert _seen(lib, 5)[0] == [phi2[3:4].data_ptr(), sd[3:4].data_ptr(),
                                    src.data_ptr(), n, STREAM]
        assert _weight(lib) == 4.0
    assert looked.names == list(ENTRIES)                # looked up once
    assert _seen(lib, 0)[1] == 6


def test_n_is_handed_over_as_int64(stub):
    """A stack of more than 2^31 cells a component reaches the kernel
    whole: n is a 64-bit argument (expanded tensors, no memory behind
    them)."""
    lib, _ = stub
    n = 2 ** 31 + 5
    one = torch.zeros(1).expand(1, n)
    src = torch.zeros(1).expand(n)
    assert lpt.launch_accumulate_one(one, one, src, 2.0, STREAM) == 0
    assert _seen(lib, 5)[0][3] == n
    six = torch.zeros(1).expand(6, n)
    assert lpt.launch_pointwise(six, six, STREAM) == 0
    assert _seen(lib, 4)[0][2] == n
    assert lpt.launch_accumulate(six, six, src, STREAM) == 0
    assert _seen(lib, 5)[0][3] == n


def _as_card(monkeypatch):
    """The wrappers' device guards made to take CPU tensors for the card's
    (the kernel library is the stub): plain_or_kernel answers 'launch',
    require_cuda holds one device and contiguity only."""
    def require(name, *tensors):
        for t in tensors:
            if t.device != tensors[0].device or not t.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous")
    monkeypatch.setattr(kernels, "plain_or_kernel", lambda name, t: True)
    monkeypatch.setattr(kernels, "require_cuda", require)


@pytest.mark.parametrize("w", [1.0, 2.0, 0.3])
def test_the_fold_hands_over_its_weight_as_a_float(stub, monkeypatch, w):
    """src32_accumulate of one pair hands 2 w over as the float the plain
    version's Python product 2.0 * w rounds to, and counts the launch."""
    lib, _ = stub
    _as_card(monkeypatch)
    u = _stack(2, BX, N, N)
    src = torch.zeros((BX, N, N))
    before = kernels.LAUNCHES["lpt_src32_accumulate"]
    assert lpt.src32_accumulate(u[1:2], u[0:1], src, weights=(w,)) is src
    assert kernels.LAUNCHES["lpt_src32_accumulate"] == before + 1
    seen, calls, which = _seen(lib, 5)
    assert which == "lpt_accumulate_one" and calls == 1
    assert seen == [u[1:2].data_ptr(), u[0:1].data_ptr(), src.data_ptr(),
                    src.numel(), STREAM]
    assert _weight(lib) == np.float32(2.0 * w)


@pytest.mark.parametrize("shape", [(1, 3, 5, 7), (1, BX, N, N)])
def test_odd_and_off_grid_slabs_are_handed_over(stub, monkeypatch, shape):
    """A slab of an odd cell count and views 4 bytes past a 16-byte
    boundary go to the kernel, which takes such heads and tails itself."""
    lib, _ = stub
    _as_card(monkeypatch)
    p, s = _off_grid(_stack(*shape)), _stack(*shape, seed=1)
    src = _off_grid(torch.zeros(shape[1:]))
    assert src.data_ptr() % 16 == 4
    lpt.src32_accumulate(p, s, src, weights=(2.0,))
    assert _seen(lib, 5) == ([p.data_ptr(), s.data_ptr(), src.data_ptr(),
                              src.numel(), STREAM], 1, "lpt_accumulate_one")
    sd = _off_grid(_stack(6, *shape[1:]))
    got = lpt.sources_pointwise(sd)
    seen, calls, which = _seen(lib, 4)
    assert which == "lpt_pointwise" and calls == 2
    assert seen == [sd.data_ptr(), got[0].data_ptr(), src.numel(), STREAM]
    assert [g.shape for g in got] == [src.shape] * 3
    assert got[1].data_ptr() == got[0].data_ptr() + 4 * src.numel()


def test_six_pairs_through_the_wrapper(stub, monkeypatch):
    lib, _ = stub
    _as_card(monkeypatch)
    sd, phi2 = _stack(6, N, N, N), _stack(6, N, N, N, seed=1)
    src = torch.zeros((N, N, N))
    before = kernels.LAUNCHES["lpt_src32_accumulate"]
    assert lpt.src32_accumulate(phi2, sd, src) is src
    assert kernels.LAUNCHES["lpt_src32_accumulate"] == before + 1
    assert _seen(lib, 5) == ([phi2.data_ptr(), sd.data_ptr(), src.data_ptr(),
                              src.numel(), STREAM], 1, "lpt_accumulate")


@pytest.mark.parametrize("bad", ["dtype", "ncomp", "phi2_shape",
                                 "src_shape", "weights", "six_weights",
                                 "strided"])
def test_what_the_kernels_do_not_take_is_refused(stub, monkeypatch, bad):
    lib, _ = stub
    _as_card(monkeypatch)
    sd, phi2 = _stack(6, BX, N, N), _stack(6, BX, N, N, seed=1)
    src, w = torch.zeros((BX, N, N)), lpt.PHI2_WEIGHTS
    if bad == "dtype":
        sd = sd.double()
    elif bad == "ncomp":
        sd, phi2 = sd[:3], phi2[:3]
    elif bad == "phi2_shape":
        phi2 = phi2[:, :, :, :N - 1].contiguous()
    elif bad == "src_shape":
        src = torch.zeros((BX, N, N - 1))
    elif bad == "weights":
        sd, phi2, w = sd[:1], phi2[:1], (1.0, 2.0)
    elif bad == "six_weights":
        w = (1.0,) * 6
    else:
        src = torch.zeros((N, N, BX)).permute(2, 0, 1)
    with pytest.raises(ValueError, match="lpt_src32_accumulate"):
        lpt.src32_accumulate(phi2, sd, src, weights=w)
    if bad in ("dtype", "ncomp"):
        with pytest.raises(ValueError, match="lpt_sources_pointwise"):
            lpt.sources_pointwise(sd)
    assert _seen(lib, 0)[1] == 0


def test_the_cpu_takes_the_plain_version():
    sd, phi2 = _stack(6, BX, N, N), _stack(6, BX, N, N, seed=1)
    got = lpt.sources_pointwise(sd)
    want = lpt.sources_pointwise_plain(sd)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    src = want[2].clone()
    assert torch.equal(lpt.src32_accumulate(phi2, sd, src),
                       lpt.src32_accumulate_plain(phi2, sd, want[2]))
    assert torch.equal(src, want[2])       # the plain version is not in place
