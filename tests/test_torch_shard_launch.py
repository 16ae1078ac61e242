"""The launch path of the shard window kernels K2s, K5s and K8s
(ops/derivatives.py) on the CPU: the hand-over of their arguments to the
three C entry points of csrc/kspace.cu, each looked up in the kernel
library once, through ctypes against the argtypes of kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the same entry points
stands in for it and records the arguments each call receives, the current
stream is a fixed number and the current card an index the test sets.
Each shard of a 2x2 pencil mesh's k layout (and a ragged window reaching
into the padded planes) reaches its entry point with its pointers, N, the
window (y0, ny, z0, nz), the kernel's own floats (K8s: its GrowthTable's
float32 scalars, made once for every launch) and the stream, in the order
of the C prototypes, and the launch is counted; the device guard is
entered only where another card is current; a wrong type, shape, layout or
table device raises before any call.
"""

import contextlib
import ctypes
import subprocess

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch import kernels
from pinocchio_tpu_torch.ops import derivatives
from pinocchio_tpu_torch.parallel import pfft

STUB = r"""
#include <stdint.h>
int64_t seen[11];
float seen_f[3];
int calls;
#define P(x) ((int64_t)(intptr_t)(x))
static int keep(int form, const void* s, void* o, int N, int y0, int ny,
                int z0, int nz, const void* g, int ntab, float f0, float f1,
                float f2, void* st) {
  int64_t v[] = {P(s), P(o), N, y0, ny, z0, nz, P(g), ntab, P(st), form};
  for (int i = 0; i < 11; ++i) seen[i] = v[i];
  seen_f[0] = f0;
  seen_f[1] = f1;
  seen_f[2] = f2;
  ++calls;
  return 0;
}
int kspace_hessian_shard(const void* s, void* o, int N, int y0, int ny,
                         int z0, int nz, float R, void* st) {
  return keep(1, s, o, N, y0, ny, z0, nz, 0, 0, R, 0.0f, 0.0f, st);
}
int kspace_gradient_shard(const void* s, void* o, int N, int y0, int ny,
                          int z0, int nz, float g, void* st) {
  return keep(2, s, o, N, y0, ny, z0, nz, 0, 0, g, 0.0f, 0.0f, st);
}
int kspace_gradient_tab_shard(const void* s, void* o, int N, int y0, int ny,
                              int z0, int nz, const void* g, int ntab,
                              float glo, float gdx, float tmax, void* st) {
  return keep(3, s, o, N, y0, ny, z0, nz, g, ntab, glo, gdx, tmax, st);
}
"""

NAMES = ("kspace_hessian_shard", "kspace_gradient_shard",
         "kspace_gradient_tab_shard")
N = 32
STREAM = (1 << 45) + 56
CARD = -1                       # a CPU tensor's get_device()


class Lookups:
    """Counts the kernel library's attribute lookups."""

    def __init__(self, lib):
        self.lib, self.names = lib, []

    def __getattr__(self, name):
        self.names.append(name)
        return getattr(self.lib, name)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub library, bound as kernels.lib() binds the kernel library,
    standing in for it (its lookups counted), a fixed current stream, the
    shard's card current, and no entry point looked up yet."""
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)), NAMES)
    looked = Lookups(lib)
    monkeypatch.setattr(kernels, "lib", lambda: looked)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: STREAM)
    monkeypatch.setattr(kernels, "current_device", lambda: CARD)
    monkeypatch.setattr(derivatives, "_SHARD_ENTRIES", {})
    return lib, looked


def _seen(lib):
    return (list((ctypes.c_int64 * 11).in_dll(lib, "seen")),
            list((ctypes.c_float * 3).in_dll(lib, "seen_f")),
            ctypes.c_int.in_dll(lib, "calls").value)


def _windows():
    """(y0, ny, z0, nz) of each shard of a 2x2 pencil mesh's k layout
    (the padded kz axis Nhp split over it), and a ragged window: odd y0 and
    ny, reaching into the padded planes."""
    decomp = pfft.make_decomp(pfft.make_pencil_mesh(4, devices=["cpu"] * 4),
                              N)
    wins = [decomp.k_window(i) for i in range(4)]
    assert wins[3][2] + wins[3][3] > N // 2 + 1       # padded planes
    return wins + [(N // 2 + 1, N // 2 - 3, N // 4 + 1, N // 4 + 3)]


def _table():
    gtab = torch.linspace(0.5, 1.5, 64, dtype=torch.float32)
    return derivatives.GrowthTable(gtab, -2.3, 0.05)


# name, ncomp, form, the wrapper's own arguments -> (tail floats)
def _cases(table):
    return [("kspace_hessian_shard", 6, 1, (1.7,), [1.7, 0.0, 0.0]),
            ("kspace_gradient_shard", 3, 2, (0.8,), [0.8, 0.0, 0.0]),
            ("kspace_gradient_tab_shard", 3, 3, (table, -2.3, 0.05),
             [-2.3, 0.05, 64 - 1.001])]


WRAPPERS = {"kspace_hessian_shard": derivatives.hessian_kspace_shard,
            "kspace_gradient_shard": derivatives.gradient_kspace_shard,
            "kspace_gradient_tab_shard":
                derivatives.gradient_kspace_tab_shard}


@pytest.mark.parametrize("which", range(3))
def test_each_window_hands_its_arguments_over(stub, which):
    lib, looked = stub
    table = _table()
    name, ncomp, form, own, floats = _cases(table)[which]
    before = kernels.LAUNCHES[name]
    wins = _windows()
    for y0, ny, z0, nz in wins:
        src = torch.zeros((N, ny, nz), dtype=torch.complex64)
        tail = (table.args(name) if name.endswith("tab_shard")
                else tuple(float(x) for x in own))
        out = derivatives._shard_launch(name, src, ncomp, N, y0, z0, tail)
        assert tuple(out.shape) == (ncomp, N, ny, nz)
        assert out.dtype == torch.complex64 and out.is_contiguous()
        seen, seen_f, _ = _seen(lib)
        gptr, ntab = ((table.gtab.data_ptr(), 64) if form == 3 else (0, 0))
        assert seen == [src.data_ptr(), out.data_ptr(), N, y0, ny, z0, nz,
                        gptr, ntab, STREAM, form]
        assert seen_f == [float(np.float32(x)) for x in floats]
    assert kernels.LAUNCHES[name] == before + len(wins)
    assert looked.names == [name]                      # looked up once
    assert derivatives._shard_entry(name).__name__ == name


def test_table_scalars_made_once(stub, monkeypatch):
    """A GrowthTable's scalars are computed on its first launch only, for
    every shard after it; pfft builds one per device for a call."""
    made = []
    real = derivatives._table_scalars

    def counted(*a):
        made.append(a[0])
        return real(*a)

    monkeypatch.setattr(derivatives, "_table_scalars", counted)
    # the wrappers' kernel path (a CUDA shard stands for itself through
    # is_cuda), four shards of one device sharing the table
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    lib, looked = stub
    table = _table()
    for y0, ny, z0, nz in _windows()[:4]:
        src = torch.zeros((N, ny, nz), dtype=torch.complex64)
        derivatives.gradient_kspace_tab_shard(src, table, -2.3, 0.05, N,
                                              y0, z0)
        seen, seen_f, _ = _seen(lib)
        assert seen[2:9] == [N, y0, ny, z0, nz, table.gtab.data_ptr(), 64]
        assert seen_f == [float(np.float32(-2.3)), float(np.float32(0.05)),
                          float(np.float32(64 - 1.001))]
    assert made == ["kspace_gradient_tab_shard"]
    assert looked.names == ["kspace_gradient_tab_shard"]
    # K2s and K5s hand their float over as it is
    src = torch.zeros((N, 8, 9), dtype=torch.complex64)
    derivatives.hessian_kspace_shard(src, 1.25, N, 3, 2)
    assert _seen(lib)[0][2:7] == [N, 3, 8, 2, 9]
    assert _seen(lib)[1][0] == 1.25
    derivatives.gradient_kspace_shard(src, 0.5, N, 0, 0)
    assert _seen(lib)[1][0] == 0.5 and _seen(lib)[0][10] == 2


def test_the_mesh_builds_one_table_per_device(monkeypatch):
    """distributed_first_derivatives_tab hands every shard of a device the
    same GrowthTable (the plain versions run on the CPU)."""
    seen = []
    real = derivatives.gradient_kspace_tab_shard

    def spy(k, gtab, glo, gdx, N_, y0, z0):
        seen.append(gtab)
        return real(k, gtab, glo, gdx, N_, y0, z0)

    monkeypatch.setattr(derivatives, "gradient_kspace_tab_shard", spy)
    decomp = pfft.make_decomp(pfft.make_pencil_mesh(4, devices=["cpu"] * 4),
                              N)
    rng = np.random.default_rng(3)
    k = torch.from_numpy((rng.standard_normal((N, N, N // 2 + 1))
                          + 1j * rng.standard_normal((N, N, N // 2 + 1)))
                         .astype(np.complex64))
    gtab = torch.linspace(0.5, 1.5, 64, dtype=torch.float32)
    shards = decomp.scatter(k.numpy(), kspace=True)
    pfft.distributed_first_derivatives_tab(decomp, shards, gtab, -2.3, 0.05)
    assert len(seen) == 4
    assert all(isinstance(t, derivatives.GrowthTable) for t in seen)
    assert all(t is seen[0] for t in seen)


def test_the_guard_only_for_another_card(stub, monkeypatch):
    lib, _ = stub
    entered = []

    @contextlib.contextmanager
    def guard(device):
        entered.append(device)
        yield

    monkeypatch.setattr(kernels, "on_device", guard)
    src = torch.zeros((N, 8, 9), dtype=torch.complex64)
    derivatives._shard_launch("kspace_gradient_shard", src, 3, N, 0, 0,
                              (1.0,))
    assert entered == []
    monkeypatch.setattr(kernels, "current_device", lambda: 3)
    derivatives._shard_launch("kspace_gradient_shard", src, 3, N, 0, 0,
                              (1.0,))
    assert entered == [src.device]
    assert _seen(lib)[2] == 2


@pytest.mark.parametrize("bad", ["dtype", "rank", "rows", "window", "z0",
                                 "strides"])
def test_wrong_shards_are_refused(stub, bad):
    lib, _ = stub
    src = torch.zeros((N, 8, 9), dtype=torch.complex64)
    y0, z0 = 0, 0
    if bad == "dtype":
        src = src.to(torch.complex128)
    elif bad == "rank":
        src = src[0]
    elif bad == "rows":
        src = torch.zeros((N + 2, 8, 9), dtype=torch.complex64)
    elif bad == "window":
        y0 = N - 4
    elif bad == "z0":
        z0 = -1
    else:
        src = torch.zeros((N, 9, 8), dtype=torch.complex64).transpose(1, 2)
    before = kernels.LAUNCHES["kspace_hessian_shard"]
    with pytest.raises(ValueError, match="kspace_hessian_shard"):
        derivatives._shard_launch("kspace_hessian_shard", src, 6, N, y0, z0,
                                  (1.0,))
    assert kernels.LAUNCHES["kspace_hessian_shard"] == before
    assert _seen(lib)[2] == 0


def test_a_table_on_another_device_is_refused(stub, monkeypatch):
    """K8s refuses a table that is not on the shard's card before it
    launches (a CUDA shard stands for itself through is_cuda)."""
    lib, _ = stub
    src = torch.zeros((N, 8, 9), dtype=torch.complex64)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    table = derivatives.GrowthTable(torch.zeros(8, device="meta"), 0.0, 0.1)
    with pytest.raises(ValueError, match="one CUDA device"):
        derivatives.gradient_kspace_tab_shard(src, table, 0.0, 0.1, N, 0, 0)
    with pytest.raises(ValueError, match="differ"):
        derivatives.gradient_kspace_tab_shard(src, table, 0.0, 0.2, N, 0, 0)
    assert _seen(lib)[2] == 0


def test_other_devices_are_refused():
    src = torch.zeros((N, 8, 9), dtype=torch.complex64, device="meta")
    for name, fn in WRAPPERS.items():
        args = ((torch.zeros(8), 0.0, 0.1) if name.endswith("tab_shard")
                else (1.0,))
        with pytest.raises(ValueError, match="unsupported device"):
            fn(src, *args, N, 0, 0)


def test_the_cpu_takes_the_plain_versions():
    """A CPU shard (and a GrowthTable in place of the table) runs the plain
    twins, equal to them bit for bit."""
    rng = np.random.default_rng(1)
    y0, ny, z0, nz = _windows()[3]
    src = torch.from_numpy((rng.standard_normal((N, ny, nz))
                            + 1j * rng.standard_normal((N, ny, nz)))
                           .astype(np.complex64))
    table = _table()
    pairs = [(derivatives.hessian_kspace_shard(src, 1.3, N, y0, z0),
              derivatives.hessian_kspace_shard_plain(src, 1.3, N, y0, z0)),
             (derivatives.gradient_kspace_shard(src, 0.7, N, y0, z0),
              derivatives.gradient_kspace_shard_plain(src, 0.7, N, y0, z0)),
             (derivatives.gradient_kspace_tab_shard(src, table, -2.3, 0.05,
                                                    N, y0, z0),
              derivatives.gradient_kspace_tab_shard_plain(
                  src, table.gtab, -2.3, 0.05, N, y0, z0))]
    for got, want in pairs:
        assert torch.equal(torch.view_as_real(got).view(torch.int32),
                           torch.view_as_real(want).view(torch.int32))
