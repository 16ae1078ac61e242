"""A gap of the JAX package's out-of-core engine that the port mirrors
(ROADMAP.md, queue 1 item 13): with float16 storage the source spectra,
unnormalized forward transforms, overflow to inf.  At 64^3 the src32
spectrum does, and every v32 row of both packages is non-finite, while
Fmax and the other fields stay finite; no clamp (bfloat16 has float32's
range).  The JAX run is tests/torch_jax16.py's, on the CPU.
"""

import numpy as np
import torch

from pinocchio_tpu_torch import fmax_ooc
from pinocchio_tpu_torch.cosmology import Cosmology
from torch_jax16 import jax_run_fmax_ooc
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)


def _nonfinite_rows(sp):
    return {k: int((~np.isfinite(np.asarray(sp.vel[k]))).any(axis=1).sum())
            for k in ("v1", "v2", "v31", "v32")}


def test_float16_overflows_the_src32_spectrum_like_jax():
    jp, p = params_pair(**bench_kwargs(64), ooc_dtype="float16")
    jres = jax_run_fmax_ooc(jp)
    res = fmax_ooc.run_fmax_ooc(p, Cosmology(p), "cpu")
    res.pending_fetch.join()
    got, want = _nonfinite_rows(res.host_products), _nonfinite_rows(
        jres.host_products)
    assert want == {"v1": 0, "v2": 0, "v31": 0,
                    "v32": len(jres.host_products.ci)}
    assert got == {"v1": 0, "v2": 0, "v31": 0,
                   "v32": len(res.host_products.ci)}
    assert np.all(np.isfinite(res.products.Fmax.numpy()))
    assert np.all(np.isfinite(np.asarray(jres.products.Fmax)))
