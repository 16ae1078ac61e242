"""The port's exchange against the JAX package's exchange_products on
JAX's products over the slab mesh of 8 devices, 2 hosts, turn 1 (the
boundary spheres of one quick pass); and the volumes mesh, where both
packages refuse the exchange (tests/torch_exchange_jax_cases.py)."""

import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.parallel import exchange as jexchange
from pinocchio_tpu.parallel import pfft as jpfft
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fragment.subbox import run_fragmentation_multibox
from pinocchio_tpu_torch.parallel import driver, exchange, pfft
from torch_exchange_jax_cases import (CPU8, N, assert_exchange_equals_jax,
                                      geometries, jax_products,
                                      jax_run_fmax_distributed)
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)


def test_exchange_equals_jax_slab_turn1():
    """(a) Identical cells, F and rows per host on the slab mesh, turn 1."""
    assert_exchange_equals_jax(jax_products("slab"), 2, 1)


def test_volumes_mesh_with_hosts_raises():
    """(h) On a volumes mesh the JAX package's exchange fails (its shard
    coordinates ask for the slab axis 'x'), and the port's raises
    NotImplementedError, from the exchange and from a host slice."""
    jp, p = params_pair(**bench_kwargs(N))
    jres = jax_run_fmax_distributed(jp, JaxCosmology(jp),
                                    jpfft.make_volume_mesh(8))
    cosmo = Cosmology(p)
    geoms, nbox, largest = geometries(p, cosmo, 4)
    with pytest.raises(NameError, match="axis name"):
        jexchange.exchange_products(jp, jres, jres.products.Fmax.sharding.mesh,
                                    geoms, 2, f16=False)
    fr = driver.run_fmax_distributed(p, cosmo,
                                     pfft.make_volume_mesh(8, devices=CPU8),
                                     defer_handoff=True)
    with pytest.raises(NotImplementedError, match="volumes mesh"):
        exchange.exchange_products(fr, geoms, 2)
    with pytest.raises(NotImplementedError, match="volumes mesh"):
        run_fragmentation_multibox(p, cosmo, fr, nbox, largest_mass=largest,
                                   host_slice=(0, 2), verbose=False)
