"""The needed-particle hand-off of the PyTorch port (the plain versions of
K6a gather_rows and K6b pdf_hist, and the sort order) against the JAX
package's compaction helpers (pinocchio_tpu/fmax.py _compact_idx,
_gather_rows, _pdf_bincount): all exactly equal (copies, integer counts and
an order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu import fmax as jfmax
from pinocchio_tpu_torch.ops import compact
from torch_hist_cases import NAMES, adversarial_F

torch.set_num_threads(2)

N = 24


@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(11)
    # collapse times with ties, fail cells (-10), never-collapse cells (0)
    # and values on the PDF bin edges
    F = rng.choice(np.arange(-10.0, 30.0, 0.1, dtype=np.float32),
                   N ** 3).astype(np.float32)
    F[::7] = -10.0
    F[::11] = 0.0
    F[:5] = [20.9, 21.0, 1e6, np.inf, 1.0]
    vel = [rng.standard_normal((3, N, N, N)).astype(np.float32)
           for _ in range(4)]
    return F.reshape(N, N, N), vel


def test_needed_order_matches_jax(grids):
    F, _ = grids
    idx = compact.needed_order(torch.from_numpy(F), 1.0)
    count = int((F >= 1.0).sum())
    jidx, jF = jfmax._compact_idx(jnp.asarray(F), 1.0, count)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(F.ravel()[idx.numpy()], np.asarray(jF))


@pytest.mark.parametrize("with_F", [True, False])
def test_gather_rows_matches_jax(grids, with_F):
    F, vel = grids
    idx = compact.needed_order(torch.from_numpy(F), 1.0)
    count = idx.numel()
    out = torch.empty(compact.packed_size(count, len(vel), with_F))
    compact.gather_rows(idx, [torch.from_numpy(v) for v in vel], out,
                        F=torch.from_numpy(F) if with_F else None)
    out = out.numpy()
    off = 0
    if with_F:
        np.testing.assert_array_equal(out[:count].view(np.int32),
                                      idx.numpy().astype(np.int32))
        np.testing.assert_array_equal(out[count:2 * count],
                                      F.ravel()[idx.numpy()])
        off = 2 * count
    jidx = jnp.asarray(idx.numpy().astype(np.int32))
    for v in vel:
        want = np.asarray(jfmax._gather_rows(jnp.asarray(v), jidx, False))
        np.testing.assert_array_equal(
            out[off:off + 3 * count].reshape(count, 3), want)
        off += 3 * count
    assert off == out.size


def test_pdf_hist_matches_jax(grids):
    F, _ = grids
    got = compact.pdf_hist(torch.from_numpy(F)).numpy()
    want = np.asarray(jfmax._pdf_bincount(jnp.asarray(F)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == F.size and got.shape == (compact.PDF_BINS,)



@pytest.mark.parametrize("name", NAMES)
def test_pdf_hist_adversarial_matches_jax(name):
    """pdf_hist (the plain twin here) on adversarial F against JAX's
    _pdf_bincount (tests/torch_hist_cases.py)."""
    F = adversarial_F("cpu", 4096)[name]
    got = compact.pdf_hist(F).numpy()
    want = np.asarray(jfmax._pdf_bincount(jnp.asarray(F.numpy())))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == F.numel()
