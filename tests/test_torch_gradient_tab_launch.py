"""K14's launch path (ops/derivatives.py) on the CPU: the form that the
strides of a source batch pick, and the hand-over of its arguments to the
two C entry points of csrc/kspace.cu (derivatives.launch_factors' mode
"gradient_tab"), looked up in the kernel library once and called through
ctypes against the argtypes of kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the same two entry points
stands in for it and records the arguments each call receives: a
contiguous plane batch goes to the contiguous form with its kz and x
strides, a resident spectrum's window and its one-plane batch (kz = N/2,
the last of the kz schedule) to the kz-fastest form with their x and y
strides; every pointer, kz0, B, the table's float32 scalars and the stream
arrive in the order of the C prototypes, and any other layout raises.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch import fmax_ooc, kernels
from pinocchio_tpu_torch.ops import derivatives

STUB = r"""
#include <stdint.h>
int64_t seen[12];
float seen_f[3];
#define P(x) ((int64_t)(intptr_t)(x))
static int keep(int form, const void* s, int64_t a, int64_t b, void* o,
                int N, int kz0, int B, const void* g, int ntab, float glo,
                float gdx, float tmax, void* st) {
  int64_t v[] = {P(s), a, b, P(o), N, kz0, B, P(g), ntab, P(st), form};
  for (int i = 0; i < 11; ++i) seen[i] = v[i];
  seen_f[0] = glo;
  seen_f[1] = gdx;
  seen_f[2] = tmax;
  return 0;
}
int ooc_gradient_tab_kz(const void* s, int64_t sx, int64_t sy, void* o,
                        int N, int kz0, int B, const void* g, int ntab,
                        float glo, float gdx, float tmax, void* st) {
  return keep(1, s, sx, sy, o, N, kz0, B, g, ntab, glo, gdx, tmax, st);
}
int ooc_gradient_tab_rows(const void* s, int64_t sb, int64_t sx, void* o,
                          int N, int kz0, int B, const void* g, int ntab,
                          float glo, float gdx, float tmax, void* st) {
  return keep(2, s, sb, sx, o, N, kz0, B, g, ntab, glo, gdx, tmax, st);
}
"""

NAMES = ("ooc_gradient_tab_kz", "ooc_gradient_tab_rows")
N = 32
NH = N // 2 + 1
STREAM = (1 << 45) + 24


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub library, bound as kernels.lib() binds the kernel library,
    standing in for it."""
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)), NAMES)
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(derivatives, "_ENTRIES", {})
    return lib


def _spectrum():
    return torch.zeros((N, N, NH), dtype=torch.complex64)


def _table():
    gtab = torch.linspace(0.5, 1.0, 512)
    return derivatives.GrowthTable(gtab, -3.123456789, 0.0123456789)


def _sources():
    """(name, source, kz0, form, its two strides) of the three batches the
    engine hands K14, and the contiguous one-plane batch."""
    spec = _spectrum()
    kz0, B = fmax_ooc.kz_schedule(NH, fmax_ooc.KZ_BATCH)[0]
    last = fmax_ooc.kz_schedule(NH, fmax_ooc.KZ_BATCH)[-1]
    assert last == (N // 2, 1)
    view = spec[:, :, kz0:kz0 + B].permute(2, 0, 1)
    one = spec[:, :, last[0]:last[0] + 1].permute(2, 0, 1)
    return [("contiguous", view.contiguous(), kz0, 2, (N * N, N)),
            ("kz-fastest", view, kz0, 1, (N * NH, NH)),
            ("one plane", one, last[0], 1, (N * NH, NH)),
            ("one plane, contiguous", one.contiguous(), last[0], 2,
             (N * N, N))]


@pytest.mark.parametrize("case", range(4))
def test_each_source_reaches_its_form(stub, case):
    what, src, kz0, form, strides = _sources()[case]
    table = _table()
    entry = derivatives._entry("gradient_tab")
    assert derivatives._entry("gradient_tab") is entry
    assert [e.__name__ for e in entry] == list(NAMES)
    out = torch.empty((3, src.shape[0], N, N), dtype=torch.complex64)
    assert derivatives.launch_factors("gradient_tab", src, kz0, N, out,
                                      table.args(), STREAM) == 0
    seen = list((ctypes.c_int64 * 12).in_dll(stub, "seen"))
    seen_f = list((ctypes.c_float * 3).in_dll(stub, "seen_f"))
    gtab = table.gtab
    assert seen[:11] == [src.data_ptr(), *strides, out.data_ptr(), N, kz0,
                         src.shape[0], gtab.data_ptr(), 512, STREAM, form], \
        what
    assert seen_f == [np.float32(-3.123456789), np.float32(0.0123456789),
                      np.float32(512 - 1.001)]


def test_table_scalars_made_once():
    """GrowthTable computes its C arguments on the first launch only."""
    table = _table()
    first = table.args()
    assert table.args() is first
    assert first[1:] == (512, float(np.float32(-3.123456789)),
                         float(np.float32(0.0123456789)),
                         float(np.float32(510.999)))
    with pytest.raises(ValueError, match="ntab >= 2"):
        derivatives.GrowthTable(torch.zeros(1), 0.0, 1.0).args()


def test_a_strided_table_is_refused():
    """A table that is not one contiguous run of floats raises when its
    arguments are made, as _table_args does for K8 and K8s."""
    gtab = torch.linspace(0.5, 1.0, 1024)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        derivatives.GrowthTable(gtab, -3.0, 0.01).args()


def test_other_layouts_are_refused(stub):
    """A batch with neither its iy nor its kz axis contiguous raises before
    any launch."""
    spec = _spectrum()
    src = spec[:, :, :4].permute(2, 0, 1).contiguous().transpose(1, 2)
    out = torch.empty((3, 4, N, N), dtype=torch.complex64)
    with pytest.raises(ValueError, match="iy or its kz axis contiguous"):
        derivatives.launch_factors("gradient_tab", src, 0, N, out,
                                   _table().args(), STREAM)
    assert (ctypes.c_int64 * 12).in_dll(stub, "seen")[10] == 0
