"""The JAX package's out-of-core engine with 16-bit storage on the CPU, for
the port's tests.

XLA's CPU backend has no bfloat16 dot with a float32 result (the JAX
engine's slab einsums raise UNIMPLEMENTED there), so the run swaps the
engine module's jnp for one whose einsum widens bfloat16 and float16
operands to float32 first.  That is exact: a product of two 16-bit numbers
is exact in float32, and the einsums accumulate in float32 already.
Nothing in the JAX package changes.
"""

import dataclasses

import jax.numpy as jnp
import pytest

import pinocchio_tpu.fmax_ooc as jfmax_ooc
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology


class WideningJnp:
    """jax.numpy whose einsum widens 16-bit operands to float32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, **kw):
        ops = [o.astype(jnp.float32)
               if o.dtype in (jnp.bfloat16, jnp.float16) else o for o in ops]
        return jnp.einsum(spec, *ops, **kw)


def jax_run_fmax_ooc(jp):
    """The JAX package's run_fmax_ooc of the JAX Params jp (any ooc_dtype)
    on the CPU, blocking, with dense products."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfmax_ooc, "jnp", WideningJnp())
        return jfmax_ooc.run_fmax_ooc(dataclasses.replace(
            jp, sparse_transfer=False, transfer_f16=False),
            JaxCosmology(jp), verbose=False, overlap=False)
