"""The port's exchange against the JAX package's exchange_products on
JAX's products over the pencil (2x4) mesh: 4 hosts, turn 0, the
well-resolved regions and their 1-cell rims
(tests/torch_exchange_jax_cases.py)."""

import torch

from torch_exchange_jax_cases import assert_exchange_equals_jax, jax_products

torch.set_num_threads(2)


def test_exchange_equals_jax_pencil_turn0_four_hosts():
    """(a) Identical cells, F and rows per host: pencil, 4 hosts, turn 0."""
    assert_exchange_equals_jax(jax_products("pencil"), 4, 0)
