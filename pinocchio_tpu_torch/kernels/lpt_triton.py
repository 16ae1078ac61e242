"""Triton kernels for the LPT sources (K4; replaces the pointwise parts of
pinocchio_tpu/ops/lpt.py:lpt_sources).

Both passes are fused elementwise work over flat fp32 streams: 6 Hessian
streams in and 3 out for the source pass, 6 phi2 + 6 Hessian + src32 in and
src32 out for the accumulation (1 + 1 + 1 in and 1 out for the accumulation
of one component pair, the out-of-core engine's fold).  On the H100 they are bound by device
memory bytes (36 B per cell for the first pass, 56 B for the second, at
3.35 TB/s peak), so the design is one masked, coalesced block load per
stream per program, every intermediate in registers, and no second pass
over memory.  The arithmetic keeps the JAX expression order.

This module imports triton at the top and is imported only by the
launching functions in ``ops/lpt.py``.
"""

from __future__ import annotations

import triton
import triton.language as tl

BLOCK = 1024


@triton.jit
def lpt_sources_pointwise(sd_ptr, out_ptr, n, BLOCK: tl.constexpr):
    n64 = n.to(tl.int64)
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n64
    sxx = tl.load(sd_ptr + offs, mask=m)
    syy = tl.load(sd_ptr + n64 + offs, mask=m)
    szz = tl.load(sd_ptr + 2 * n64 + offs, mask=m)
    sxy = tl.load(sd_ptr + 3 * n64 + offs, mask=m)
    sxz = tl.load(sd_ptr + 4 * n64 + offs, mask=m)
    syz = tl.load(sd_ptr + 5 * n64 + offs, mask=m)
    src2 = (sxx * syy + sxx * szz + syy * szz
            - sxy * sxy - sxz * sxz - syz * syz)
    src31 = 3.0 * (sxx * (syy * szz - syz * syz)
                   - sxy * (sxy * szz - sxz * syz)
                   + sxz * (sxy * syz - sxz * syy))
    src32 = 2.0 * (sxx + syy + szz) * src2
    tl.store(out_ptr + offs, src2, mask=m)
    tl.store(out_ptr + n64 + offs, src31, mask=m)
    tl.store(out_ptr + 2 * n64 + offs, src32, mask=m)


@triton.jit
def _term(phi_ptr, sd_ptr, i, n64, offs, m, w: tl.constexpr):
    p = tl.load(phi_ptr + i * n64 + offs, mask=m)
    s = tl.load(sd_ptr + i * n64 + offs, mask=m)
    return w * p * s


@triton.jit
def lpt_src32_accumulate(phi_ptr, sd_ptr, src_ptr, n, BLOCK: tl.constexpr):
    # weights 2 * w_ij: w = 1 on the diagonal (xx yy zz), 2 off it
    n64 = n.to(tl.int64)
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n64
    acc = tl.load(src_ptr + offs, mask=m)
    acc = acc - _term(phi_ptr, sd_ptr, 0, n64, offs, m, 2.0)
    acc = acc - _term(phi_ptr, sd_ptr, 1, n64, offs, m, 2.0)
    acc = acc - _term(phi_ptr, sd_ptr, 2, n64, offs, m, 2.0)
    acc = acc - _term(phi_ptr, sd_ptr, 3, n64, offs, m, 4.0)
    acc = acc - _term(phi_ptr, sd_ptr, 4, n64, offs, m, 4.0)
    acc = acc - _term(phi_ptr, sd_ptr, 5, n64, offs, m, 4.0)
    tl.store(src_ptr + offs, acc, mask=m)


@triton.jit
def lpt_src32_accumulate_one(phi_ptr, sd_ptr, src_ptr, n, w2,
                             BLOCK: tl.constexpr):
    # one component pair of the out-of-core fold: src32 - (2 w) phi2 sd
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n.to(tl.int64)
    p = tl.load(phi_ptr + offs, mask=m)
    s = tl.load(sd_ptr + offs, mask=m)
    acc = tl.load(src_ptr + offs, mask=m)
    tl.store(src_ptr + offs, acc - w2 * p * s, mask=m)


def launch_pointwise(sd, out):
    n = sd[0].numel()
    grid = (triton.cdiv(n, BLOCK),)
    lpt_sources_pointwise[grid](sd, out, n, BLOCK=BLOCK, num_warps=8)


def launch_accumulate(phi2, sd, src32):
    n = src32.numel()
    grid = (triton.cdiv(n, BLOCK),)
    lpt_src32_accumulate[grid](phi2, sd, src32, n, BLOCK=BLOCK, num_warps=8)


def launch_accumulate_one(phi2, sd, src32, w2: float):
    n = src32.numel()
    grid = (triton.cdiv(n, BLOCK),)
    lpt_src32_accumulate_one[grid](phi2, sd, src32, n, w2, BLOCK=BLOCK,
                                   num_warps=8)
