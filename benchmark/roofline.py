"""The yardstick of the kernels: the published peaks of one H100 and each
operation's work per realization.

An operation is one file, ``roofline/<op>.json``:

  name      the operation
  kernels   regular expressions of the device kernel names that do it
  ops       floating-point operations per realization, an expression
  bytes     bytes per realization (each input read once, each output
            written once), an expression
  library   true for a library call's work (cuFFT): counted in the whole
            step's share of the peak, not in the kernels' roofline
  from      where the arithmetic comes from

The expressions use + - * / ** ( ) log2() and the cell's shapes: N, Nh
(N/2+1), cells (N^3), modes (N^2 Nh), nsmooth (radii of the ladder),
nsets (displacement sets), nfields (fields per set) and count (needed
rows, the mean over the traced realizations).  A cell names the operations
it is measured against in its own file (``cells/<cell>.json``), so an
operation's file describes one engine's work and holds no switch of its
own.  An operation's bound is the larger of bytes over PEAK_BYTES and
ops over PEAK_OPS (the arithmetic of chip_smoke.py's ``bound``, frozen
here).
"""

from __future__ import annotations

import ast
import math
import operator
import re

# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3 bandwidth and
# float32 outside the tensor cores (the kernels' and cuFFT's arithmetic)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12

_BIN = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.Div: operator.truediv, ast.Pow: operator.pow}
_FUN = {"log2": math.log2}


def evaluate(expr: str, shapes: dict) -> float:
    """The value of an arithmetic expression over ``shapes``."""
    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.Name):
            return float(shapes[n.id])
        if isinstance(n, ast.BinOp) and type(n.op) in _BIN:
            return _BIN[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in _FUN and len(n.args) == 1):
            return _FUN[n.func.id](ev(n.args[0]))
        raise ValueError(f"not an arithmetic expression: {expr!r}")
    return ev(ast.parse(expr, mode="eval"))


def shapes(run: dict) -> dict:
    """The cell's shapes of the module docstring, from a run's record."""
    recs = run["records"]
    N = run["N"]
    Nh = N // 2 + 1
    first = recs[0]
    return dict(N=N, Nh=Nh, cells=N ** 3, modes=N * N * Nh,
                nsmooth=first["nsmooth"], nsets=first["nsets"],
                nfields=first["nfields"],
                count=sum(r["count"] for r in recs) / len(recs))


def work(op: dict, sh: dict) -> tuple:
    """(ops, bytes, bound seconds) of one realization of ``op``."""
    ops = evaluate(op["ops"], sh)
    nbytes = evaluate(op["bytes"], sh)
    return ops, nbytes, max(nbytes / PEAK_BYTES, ops / PEAK_OPS)


def kernel_seconds(op: dict, kernels: dict) -> float:
    """The device seconds of the traced kernels whose names ``op`` covers."""
    pats = [re.compile(p) for p in op["kernels"]]
    return sum(s for name, s in kernels.items()
               if any(p.search(name) for p in pats))
