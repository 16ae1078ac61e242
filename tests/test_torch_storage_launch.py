"""K18's and K19's launch path (ops/storage.py) on the CPU: their four C
entry points looked up once in the kernel library and called through ctypes
with plain ints, against the argtypes declared in kernels._SIGNATURES.

The kernel library needs nvcc, so here a stub of the same four entry points
stands in for it and records the arguments each call receives.  The test
holds the hand-over of every argument (64-bit pointers, 64-bit sizes and
the stream) in the order of the C prototypes of csrc/storage.cu.
"""

import ctypes
import subprocess

import pytest

from pinocchio_tpu_torch import kernels
from pinocchio_tpu_torch.ops import storage

STUB = r"""
#include <stdint.h>
int64_t seen[10];
static int keep(int n, const int64_t* a) {
  for (int i = 0; i < n; ++i) seen[i] = a[i];
  seen[9] = n;
  return n;
}
#define P(x) ((int64_t)(intptr_t)(x))
int storage_store_kz(const void* s, void* d, int kind, int64_t C, int64_t M,
                     int64_t B, int64_t W, int64_t k, void* st) {
  int64_t a[] = {P(s), P(d), kind, C, M, B, W, k, P(st)};
  return keep(9, a);
}
int storage_store_rows(const void* s, void* d, int kind, int64_t A,
                       int64_t W, int64_t Ws, int64_t c, void* st) {
  int64_t a[] = {P(s), P(d), kind, A, W, Ws, c, P(st)};
  return keep(8, a);
}
int storage_load_kz(const void* s, void* d, int kind, int64_t C, int64_t M,
                    int64_t B, int64_t W, int64_t k, void* st) {
  int64_t a[] = {P(s), P(d), kind, C, M, B, W, k, P(st)};
  return keep(9, a);
}
int storage_load_rows(const void* s, void* d, int kind, int64_t C,
                      int64_t n, int64_t sc, void* st) {
  int64_t a[] = {P(s), P(d), kind, C, n, sc, P(st)};
  return keep(7, a);
}
"""

NAMES = ("storage_store_kz", "storage_store_rows", "storage_load_kz",
         "storage_load_rows")


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
    monkeypatch.setattr(storage, "_ENTRY", None)
    return lib


@pytest.mark.parametrize("which,n", [(0, 9), (1, 8), (2, 9), (3, 7)])
def test_launch_hands_every_argument_over(stub, which, n):
    entry = storage._entry()
    assert storage._entry() is entry
    assert entry[which].__name__ == NAMES[which]
    args = [(1 << 47) - 8, (1 << 46) + 16, 1, 6, 1 << 33, 16, 513,
            (1 << 40) + 3, 0x7f12_3456_7890][:n - 1] + [(1 << 45) + 24]
    assert entry[which](*args) == n
    seen = (ctypes.c_int64 * 10).in_dll(stub, "seen")
    assert list(seen[:n]) == args and seen[9] == n
    with pytest.raises(TypeError):
        entry[which](*args[:-1])
    with pytest.raises(ctypes.ArgumentError):
        entry[which](*args[:-1], 1.5)
