"""Native (C) runtime components, compiled on demand.

The hot sequential piece of the pipeline — the fragmentation sweep — is C
(like the reference's build_groups.c), and so are the catalog writers.  The
shared library is built with the system compiler on first use into the
package's build directory (``pinocchio_tpu_torch/build``, beside the CUDA
kernel library), never next to the source; it is rebuilt when the source is
newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_HERE), "build")
_LOCK = threading.Lock()
_LIBS = {}

_CFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c11",
           "-fno-math-errno"]


def _build(name: str) -> str:
    src = os.path.join(_HERE, name + ".c")
    lib = os.path.join(BUILD, "lib" + name + ".so")
    if (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src)):
        os.makedirs(BUILD, exist_ok=True)
        # a private name, then an atomic rename: processes that build at
        # the same time never load a half-written library
        tmp = f"{lib}.{os.getpid()}"
        cmd = ["cc"] + _CFLAGS + ["-o", tmp, src, "-lm"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"failed to build {name}: {res.stderr}\n{' '.join(cmd)}")
        os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_build(name))
        return _LIBS[name]
