"""K10's launch path (ops/derivatives.py) on the CPU: the form that the
strides of each source batch pick for the Hessian, gradient and pair modes,
and the hand-over of their arguments to the five C entry points of
csrc/kspace.cu (looked up in the kernel library once a mode) through
ctypes against the argtypes of kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the same entry points
stands in for it and records the arguments each call receives, and the
current stream is a fixed number.  The engine's batches go through the
wrappers' launch (``derivatives._launch``, which the CUDA wrappers call): a
batch of K9's planes goes to the rows form with its kz and x strides, a
resident spectrum's window (and its one-plane batch kz = N/2, the last of
the kz schedule) to the kz-fastest form with its x and y strides; the pair
mode reads its first source, K9's planes, by rows beside either form of
its second; the Hessian mode, which only reads K9's planes, has the rows
form alone and refuses a window.  Every pointer, kz0, B, the mode's own arguments and the stream
arrive in the order of the C prototypes and the launch is counted; other
layouts, planes outside 0..N/2 and mismatched pair sources raise before
any call.
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
int64_t seen[14];
float seen_f;
#define P(x) ((int64_t)(intptr_t)(x))
static int keep(int form, const void* s0, int64_t a0, int64_t b0,
                const void* s, int64_t a, int64_t b, void* o, int N,
                int kz0, int B, int i0, int i1, float f, void* st) {
  int64_t v[] = {P(s0), a0, b0, P(s), a, b, P(o), N, kz0, B, i0, i1,
                 P(st), form};
  for (int i = 0; i < 14; ++i) seen[i] = v[i];
  seen_f = f;
  return 0;
}
#define ONE(name, form)                                                     \
  int name(const void* s, int64_t a, int64_t b, void* o, int N, int kz0,   \
           int B, float f, void* st) {                                     \
    return keep(form, 0, 0, 0, s, a, b, o, N, kz0, B, 0, 0, f, st);        \
  }
ONE(ooc_hessian_rows, 2)
ONE(ooc_gradient_kz, 3)
ONE(ooc_gradient_rows, 4)
#define PAIR(name, form)                                                    \
  int name(const void* s0, int64_t a0, int64_t b0, const void* s,          \
           int64_t a, int64_t b, void* o, int N, int kz0, int B, int ia,   \
           int ib, void* st) {                                             \
    return keep(form, s0, a0, b0, s, a, b, o, N, kz0, B, ia, ib, 0.0f,     \
                st);                                                       \
  }
PAIR(ooc_pair_kz, 5)
PAIR(ooc_pair_rows, 6)
"""

NAMES = ("ooc_hessian_rows", "ooc_gradient_kz",
         "ooc_gradient_rows", "ooc_pair_kz", "ooc_pair_rows")
N = 32
NH = N // 2 + 1
STREAM = (1 << 45) + 40


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub library, bound as kernels.lib() binds the kernel library,
    standing in for it, and a fixed current stream."""
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)), NAMES)
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: STREAM)
    monkeypatch.setattr(derivatives, "_ENTRIES", {})
    return lib


def _seen(stub):
    return (list((ctypes.c_int64 * 14).in_dll(stub, "seen")),
            ctypes.c_float.in_dll(stub, "seen_f").value)


def _batches():
    """(spectrum window, K9-like planes) of the first batch and of the
    one-plane last batch kz = N/2 of the kz schedule."""
    spec = torch.zeros((N, N, NH), dtype=torch.complex64)
    sched = fmax_ooc.kz_schedule(NH, fmax_ooc.KZ_BATCH)
    assert sched[-1] == (N // 2, 1)
    out = []
    for kz0, B in (sched[0], sched[-1]):
        view = spec[:, :, kz0:kz0 + B].permute(2, 0, 1)
        out.append((kz0, view, view.contiguous()))
    return out


# (mode, batch: 0 first or 1 last, source: "window" or "planes", form)
CASES = [("hessian", 0, "planes", 2), ("hessian", 1, "planes", 2),
         ("gradient", 0, "planes", 4), ("gradient", 0, "window", 3),
         ("gradient", 1, "window", 3), ("gradient", 1, "planes", 4),
         ("pair", 0, "window", 5), ("pair", 0, "planes", 6),
         ("pair", 1, "window", 5), ("pair", 1, "planes", 6)]
NCOMP = {"hessian": 6, "gradient": 3, "pair": 2}
TAIL = {"hessian": (1.7,), "gradient": (0.8,), "pair": (0, 2)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_each_source_reaches_its_form(stub, case):
    mode, which, layout, form = case
    kz0, window, planes = _batches()[which]
    src = window if layout == "window" else planes
    B = src.shape[0]
    name = f"ooc_factors_{mode}"
    before = kernels.LAUNCHES[name]
    src0 = planes.clone() if mode == "pair" else None
    out = derivatives._launch(name, mode, src, kz0, N, NCOMP[mode],
                              TAIL[mode], src0)
    assert tuple(out.shape) == (NCOMP[mode], B, N, N)
    assert out.dtype == torch.complex64 and out.is_contiguous()
    assert kernels.LAUNCHES[name] == before + 1
    entry = derivatives._entry(mode)
    assert derivatives._entry(mode) is entry
    assert [e and e.__name__ for e in entry] == [
        None if mode == "hessian" else f"ooc_{mode}_kz", f"ooc_{mode}_rows"]
    seen, seen_f = _seen(stub)
    strides = (src.stride()[1:] if layout == "window"
               else src.stride()[:2])
    assert strides == ((N * NH, NH) if layout == "window" else (N * N, N))
    head = ([src0.data_ptr(), N * N, N] if mode == "pair" else [0, 0, 0])
    ints = list(TAIL[mode]) if mode == "pair" else [0, 0]
    assert seen == head + [src.data_ptr(), *strides, out.data_ptr(), N, kz0,
                           B] + ints + [STREAM, form]
    want_f = TAIL[mode][0] if mode != "pair" else 0.0
    assert seen_f == np.float32(want_f)


@pytest.mark.parametrize("mode", ["hessian", "gradient", "pair"])
def test_other_layouts_are_refused(stub, mode):
    """A batch with neither its iy nor its kz axis contiguous, and a pair
    whose first source is not K9's planes (iy contiguous), raise before
    any launch."""
    kz0, window, planes = _batches()[0]
    name = f"ooc_factors_{mode}"
    before = kernels.LAUNCHES[name]
    bad = planes.transpose(1, 2)
    src0 = planes if mode == "pair" else None
    axes = "its iy axis" if mode == "hessian" else "iy or its kz axis"
    with pytest.raises(ValueError, match=f"{axes} contiguous"):
        derivatives._launch(name, mode, bad, kz0, N, NCOMP[mode], TAIL[mode],
                            src0)
    if mode == "pair":
        for first in (window, bad):
            with pytest.raises(ValueError, match="first source batch with "
                               "its iy axis contiguous"):
                derivatives._launch(name, mode, planes, kz0, N, 2,
                                    TAIL[mode], first)
    assert _seen(stub)[0][13] == 0
    assert kernels.LAUNCHES[name] == before


@pytest.mark.parametrize("which", [0, 1])
def test_a_hessian_window_is_refused(stub, which):
    """The Hessian mode has no kz-fastest form: a resident spectrum's window
    (the first batch and the one-plane last one) raises before any call."""
    kz0, window, _ = _batches()[which]
    name = "ooc_factors_hessian"
    before = kernels.LAUNCHES[name]
    with pytest.raises(ValueError, match="its iy axis contiguous"):
        derivatives._launch(name, "hessian", window, kz0, N, 6, (1.7,))
    assert _seen(stub)[0][13] == 0
    assert kernels.LAUNCHES[name] == before


@pytest.mark.parametrize("mode", ["hessian", "gradient", "pair"])
def test_planes_outside_the_half_spectrum_are_refused(stub, mode):
    """A batch that reaches past kz = N/2 (or starts below 0), a source of
    another shape or type, and a pair whose sources differ in B raise
    before any launch."""
    spec = torch.zeros((N, N, NH + 4), dtype=torch.complex64)
    name = f"ooc_factors_{mode}"
    src0 = (torch.zeros((4, N, N), dtype=torch.complex64)
            if mode == "pair" else None)
    for kz0 in (NH - 3, -1):
        src = spec[:, :, max(kz0, 0):max(kz0, 0) + 4].permute(2, 0, 1)
        with pytest.raises(ValueError, match=f"planes in 0..{N // 2}"):
            derivatives._launch(name, mode, src, kz0, N, NCOMP[mode],
                                TAIL[mode], src0)
    for src in (torch.zeros((4, N, N + 1), dtype=torch.complex64),
                torch.zeros((4, N, N), dtype=torch.complex128)):
        with pytest.raises(ValueError, match="source batch"):
            derivatives._launch(name, mode, src, 0, N, NCOMP[mode],
                                TAIL[mode], src0)
    if mode == "pair":
        with pytest.raises(ValueError, match="sources of one batch"):
            derivatives._launch(name, mode, src0, 0, N, 2, TAIL[mode],
                                src0[:3])
    assert _seen(stub)[0][13] == 0
