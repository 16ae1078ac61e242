"""Initial conditions of the PyTorch port against the JAX package.

The port's threefry2x32 must reproduce jax.random.split, jax.random.bits
and jax.random.uniform bit for bit; delta(k) must then agree with
ic.generate_kdensity to float32 rounding of the transcendentals (1e-5 of
max |delta|), for the default, Fixed and Paired fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu import ic as jic
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.grids import Grid as JGrid
from pinocchio_tpu_torch import ic
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.grids import Grid
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
SEEDS = (486604, 7, 2**33 + 5)


@pytest.fixture(scope="module")
def setup():
    jp, p = params_pair(**bench_kwargs(N))
    return jp, JaxCosmology(jp), p, Cosmology(p)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert ic.prng_key(seed) == tuple(int(v) for v in np.asarray(key))
    jkp, jka = jax.random.split(key)
    kp, ka = ic.split(ic.prng_key(seed))
    assert kp == tuple(int(v) for v in np.asarray(jkp))
    assert ka == tuple(int(v) for v in np.asarray(jka))
    shape = (N, N, N // 2 + 1)
    n = int(np.prod(shape))
    for jk, k in ((jkp, kp), (jka, ka)):
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).ravel()
        got = ic.random_bits(k, torch.arange(n)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["phase", "amplitude"])
def test_uniform_bit_identical(which):
    kp, ka = jax.random.split(jax.random.PRNGKey(SEEDS[0]))
    shape = (N, N, N // 2 + 1)
    n = int(np.prod(shape))
    if which == "phase":
        jk, lo, hi = kp, 0.0, 2.0 * np.pi
    else:
        jk, lo, hi = ka, 1.1754944e-38, 1.0
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
    key = tuple(int(v) for v in np.asarray(jk))
    got = ic.uniform(key, torch.arange(n), lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.ravel().view(np.uint32))


@pytest.mark.parametrize("fixed,paired", [(False, False), (True, False),
                                          (False, True)])
def test_kdensity_matches_jax(setup, fixed, paired):
    jp, jcosmo, p, cosmo = setup
    want = np.asarray(jic.generate_kdensity(
        JGrid(N=N, BoxSize=jp.BoxSize_htrue), jcosmo, jp.RandomSeed,
        fixed=fixed, paired=paired))
    got = ic.generate_kdensity(Grid(N, p.BoxSize_htrue), cosmo,
                               p.RandomSeed, "cpu", fixed=fixed,
                               paired=paired).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    # the same empty modes (Nyquist planes, spherical cut, k=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    # measured 9e-8 of max |delta| (float32 transcendentals)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def setup96():
    jp, p = params_pair(**bench_kwargs(96))
    return jp, JaxCosmology(jp), p, Cosmology(p)


@pytest.mark.parametrize("fixed,paired", [(False, False), (True, False),
                                          (False, True)])
def test_kdensity_matches_jax_96(setup96, fixed, paired):
    """As at 32^3, at 96^3 (Nh = 49, odd; a row of kz is not a multiple of
    a warp): the same empty modes, delta within 1e-5 of max |delta|.  (The
    signs of the empty modes' zeros differ: JAX builds the complex number
    as re + 1j * im, whose real part adds a +0.)"""
    jp, jcosmo, p, cosmo = setup96
    want = np.asarray(jic.generate_kdensity(
        JGrid(N=96, BoxSize=jp.BoxSize_htrue), jcosmo, jp.RandomSeed,
        fixed=fixed, paired=paired))
    got = ic.generate_kdensity(Grid(96, p.BoxSize_htrue), cosmo,
                               p.RandomSeed, "cpu", fixed=fixed,
                               paired=paired).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_kdensity_hermitian_kz0_plane(setup):
    """The kz=0 plane is Hermitian: delta(-kx, -ky, 0) = conj(delta)."""
    _, _, p, cosmo = setup
    d = ic.generate_kdensity(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed,
                             "cpu").numpy()[:, :, 0]
    idx = (-np.arange(N)) % N
    np.testing.assert_array_equal(d[np.ix_(idx, idx)], np.conj(d))
