"""The port's exchange against the JAX package's exchange_products on
JAX's products over the pencil (2x4) mesh: 2 hosts, single-turn
(tests/torch_exchange_jax_cases.py; 4 hosts and turn 0 are
test_torch_exchange_jax_turn0.py, turn 1 test_torch_exchange_jax_turn1.py,
the slab mesh (turn 1) and the volumes mesh
test_torch_exchange_jax_slab.py, one JAX exchange per file so that the test
workers run them side by side; every combination is held to a brute-force
selection in test_torch_exchange.py)."""

import torch

from torch_exchange_jax_cases import assert_exchange_equals_jax, jax_products

torch.set_num_threads(2)


def test_exchange_equals_jax_pencil_single_turn():
    """(a) Identical cells, F and rows per host: pencil, 2 hosts."""
    assert_exchange_equals_jax(jax_products("pencil"), 2, None)
