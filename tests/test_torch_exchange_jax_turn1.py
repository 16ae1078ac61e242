"""The port's exchange against the JAX package's exchange_products on
JAX's products over the pencil (2x4) mesh: 2 hosts, turn 1, the cells of
each host's boundary spheres inside its padded volumes and outside its
turn-0 regions (tests/torch_exchange_jax_cases.py)."""

import torch

from torch_exchange_jax_cases import assert_exchange_equals_jax, jax_products

torch.set_num_threads(2)


def test_exchange_equals_jax_pencil_turn1():
    """(a) Identical cells, F and rows per host: pencil, 2 hosts, turn 1
    (each host's spheres from one quick pass)."""
    assert_exchange_equals_jax(jax_products("pencil"), 2, 1)
