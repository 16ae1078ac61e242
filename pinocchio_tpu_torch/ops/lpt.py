"""2LPT / 3LPT source terms (counterpart of pinocchio_tpu/ops/lpt.py).

  source_2LPT   = sum_{i<j} (phi,ii phi,jj - phi,ij^2)           (LPT.c:70-76)
  source_3LPT_1 = 3 det(phi,ij)                                  (LPT.c:79-87)
  source_3LPT_2 = 2 nabla^2(phi) * source_2LPT
                  - 2 sum_{ij} w_ij phi2,ij phi,ij               (LPT.c:89-141)

The two pointwise passes are the Triton kernels of
``kernels/lpt_triton.py`` on the card; the second derivatives of the 2LPT
potential reuse the CUDA Hessian multiply at R=0, where exp(0) = 1 makes it
exactly the JAX package's ``kvec2 * inv_k2 * k_a k_b``.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..grids import irfft3, rfft3
from .derivatives import hessian_kspace

# ider order: 0:xx 1:yy 2:zz 3:xy 4:xz 5:yz
_XX, _YY, _ZZ, _XY, _XZ, _YZ = range(6)
# weight of each phi2,ij * phi,ij product in source_3LPT_2 (in ider order)
PHI2_WEIGHTS = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)


def sources_pointwise_plain(sd):
    sxx, syy, szz, sxy, sxz, syz = (sd[i] for i in range(6))
    src2 = (sxx * syy + sxx * szz + syy * szz
            - sxy * sxy - sxz * sxz - syz * syz)
    src31 = 3.0 * (sxx * (syy * szz - syz * syz)
                   - sxy * (sxy * szz - sxz * syz)
                   + sxz * (sxy * syz - sxz * syy))
    # factor 2: nabla2(phi) here is half the theoretical one (LPT.c:89-91)
    src32 = 2.0 * (sxx + syy + szz) * src2
    return src2, src31, src32


def src32_accumulate_plain(phi2, sd, src32, weights=PHI2_WEIGHTS):
    for ider, w in enumerate(weights):
        src32 = src32 - 2.0 * w * phi2[ider] * sd[ider]
    return src32


def _check_stack(name, sd, *more, ncomp=(6,)):
    kernels.require_cuda(name, sd, *more)
    for t in (sd,) + more:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 tensors expected")
    if sd.shape[0] not in ncomp:
        raise ValueError(f"{name}: a [{' or '.join(map(str, ncomp))}, ...] "
                         "Hessian stack expected")


def sources_pointwise(sd):
    """(src2, src31, src32 seed) from the R=0 Hessian stack [6, *S]."""
    if not kernels.plain_or_kernel("lpt_sources_pointwise", sd):
        return sources_pointwise_plain(sd)
    _check_stack("lpt_sources_pointwise", sd)
    from ..kernels import lpt_triton
    out = torch.empty((3,) + tuple(sd.shape[1:]), dtype=torch.float32,
                      device=sd.device)
    lpt_triton.launch_pointwise(sd, out)
    kernels.LAUNCHES["lpt_sources_pointwise"] += 1
    return out[0], out[1], out[2]


def src32_accumulate(phi2, sd, src32, weights=PHI2_WEIGHTS):
    """src32 - sum_ij 2 w_ij phi2,ij sd_ij, accumulated in ider order: all
    six components (phi2, sd [6, *S], the weights PHI2_WEIGHTS), or one
    component pair of the out-of-core fold (phi2, sd [1, *S], its weight).
    On the card src32 is updated IN PLACE and returned."""
    if not kernels.plain_or_kernel("lpt_src32_accumulate", sd):
        return src32_accumulate_plain(phi2, sd, src32, weights)
    _check_stack("lpt_src32_accumulate", sd, phi2, src32, ncomp=(1, 6))
    if (phi2.shape != sd.shape or src32.shape != sd.shape[1:]
            or len(weights) != sd.shape[0]
            or (sd.shape[0] == 6 and tuple(weights) != PHI2_WEIGHTS)):
        raise ValueError("lpt_src32_accumulate: phi2 and sd [6, *S] with "
                         "the weights PHI2_WEIGHTS, or [1, *S] with one "
                         "weight, and src32 [*S] expected")
    from ..kernels import lpt_triton
    if sd.shape[0] == 6:
        lpt_triton.launch_accumulate(phi2, sd, src32)
    else:
        lpt_triton.launch_accumulate_one(phi2, sd, src32,
                                         2.0 * float(weights[0]))
    kernels.LAUNCHES["lpt_src32_accumulate"] += 1
    return src32


def lpt_sources(sd, N: int):
    """k-space 2LPT and 3LPT sources from the R=0 Hessian stack [6,N,N,N]:
    (kvec_2LPT, kvec_3LPT_1, kvec_3LPT_2), each complex64 [N,N,N//2+1]."""
    src2, src31, src32 = sources_pointwise(sd)
    kvec2 = rfft3(src2)
    del src2
    # second derivatives of the 2LPT potential (LPT.c:116-141)
    phi2 = irfft3(hessian_kspace(kvec2, 0.0, N), N)
    src32 = src32_accumulate(phi2, sd, src32)
    del phi2
    return kvec2, rfft3(src31), rfft3(src32)
