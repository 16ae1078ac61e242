"""The redesigned K6a (the needed rows scattered from the cells in order
through a row rank) and K3 (the cube root without a float64 pow), on the
CPU.

- gather_rows with a precomputed rank (needed_rank) equals gather_rows
  without one, and both equal the JAX package's _compact_idx and
  _gather_rows exactly, at 32^3 and 48^3: with and without F, 1 to 8
  stacks, no needed cell, every cell needed;
- needed_rank equals the inverse of the JAX order;
- the kernel's cube-root rule (csrc/collapse.cu cube_root: the float64
  cbrt rounded to float32, and the float64 pow only within kCbrtWindow
  float64 ulps of a float32 rounding midpoint), written in numpy, equals
  the float64 pow rounded once on 10^6 seeded float32 values across the
  exponent range and on values whose cube roots lie at float32 midpoints;
- the planner's dense displacement phase holds the rank field, and its
  row-gather phase the rank and the row records;
- K1's dead-mode rule (csrc/ic_kdensity.cu dead_zero: the signs of cos
  and sin of the phase from the parity of the odd and of the even quarter
  turns kQuarter at or below it), in numpy, gives the signs of the float64
  cos and sin on every phase the generator can draw (2^23 uniforms of
  [0, 2 pi), and the same shifted by float32(pi)), and each quarter turn
  is the least float32 above k pi / 2;
- the kernels' division by a multiply (Div: m = ceil(2^(31+s) / d),
  s = ceil(log2 d)) gives n // d for every d up to 2^16 and 2^31 - 1 on the
  numerators where it is tightest.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu import fmax as jfmax
from pinocchio_tpu_torch import planner
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.ops import compact

torch.set_num_threads(2)

COLLAPSE_CU = os.path.join(os.path.dirname(__file__), os.pardir,
                           "pinocchio_tpu_torch", "csrc", "collapse.cu")
IC_CU = os.path.join(os.path.dirname(__file__), os.pardir,
                     "pinocchio_tpu_torch", "csrc", "ic_kdensity.cu")


def _state(N, flast, seed):
    """Collapse times with ties, fail cells (-10) and never-collapse cells
    (0), and eight [3, N^3] stacks; the needed order for F >= flast."""
    rng = np.random.default_rng(seed)
    F = rng.choice(np.arange(-10.0, 30.0, 0.1, dtype=np.float32),
                   N ** 3).astype(np.float32)
    F[::7] = -10.0
    F[::13] = 0.0
    vel = [rng.standard_normal((3, N, N, N)).astype(np.float32)
           for _ in range(compact.MAX_STACKS)]
    idx = compact.needed_order(torch.from_numpy(F.reshape(N, N, N)), flast)
    return F.reshape(N, N, N), vel, idx


def _jax_rows(F, vel, idx, nstack, with_F, flast):
    """The packed buffer from the JAX package's helpers."""
    count = idx.numel()
    parts = []
    if with_F:
        jidx, jF = jfmax._compact_idx(jnp.asarray(F), flast, count)
        parts += [np.asarray(jidx).view(np.float32), np.asarray(jF)]
    jidx = jnp.asarray(idx.numpy().astype(np.int32))
    for v in vel[:nstack]:
        parts.append(np.asarray(jfmax._gather_rows(jnp.asarray(v), jidx,
                                                   False)).reshape(-1))
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


@pytest.mark.parametrize("N", [32, 48])
@pytest.mark.parametrize("flast", [1.0, -np.inf, np.inf],
                         ids=["some", "every", "none"])
@pytest.mark.parametrize("nstack", [1, 4, 8])
@pytest.mark.parametrize("with_F", [True, False])
def test_gather_rows_with_rank_matches_jax(N, flast, nstack, with_F):
    F, vel, idx = _state(N, flast, seed=N)
    count = idx.numel()
    if flast == -np.inf:
        assert count == N ** 3
    if flast == np.inf:
        assert count == 0
    stacks = [torch.from_numpy(v) for v in vel[:nstack]]
    Ft = torch.from_numpy(F) if with_F else None
    size = compact.packed_size(count, nstack, with_F)
    a = torch.full((size,), np.nan)
    b = torch.full((size,), np.nan)
    compact.gather_rows(idx, stacks, a, F=Ft,
                        rank=compact.needed_rank(idx, N ** 3))
    compact.gather_rows(idx, stacks, b, F=Ft)
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  b.numpy().view(np.int32))
    with_jax_F = with_F and count > 0   # _compact_idx needs a count > 0
    want = _jax_rows(F, vel, idx, nstack, with_jax_F, flast)
    off = 0 if with_jax_F or not with_F else 2 * count
    np.testing.assert_array_equal(a.numpy()[off:].view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("N", [32, 48])
def test_needed_rank_inverts_the_jax_order(N):
    F, _, idx = _state(N, 1.0, seed=3)
    count = idx.numel()
    jidx, _ = jfmax._compact_idx(jnp.asarray(F), 1.0, count)
    jidx = np.asarray(jidx)
    rank = compact.needed_rank(idx, N ** 3).numpy()
    assert rank.dtype == np.int32 and rank.shape == (N ** 3,)
    np.testing.assert_array_equal(rank[jidx], np.arange(count))
    assert (rank >= 0).sum() == count
    assert (rank[rank < 0] == -1).all()


def _cbrt_window():
    with open(COLLAPSE_CU) as fd:
        m = re.search(r"kCbrtWindow = (\d+);", fd.read())
    return int(m.group(1))


def cube_root(x):
    """The kernel's rule in numpy: float32 x >= 0 -> float32."""
    x64 = x.astype(np.float64)
    y = np.cbrt(x64)
    lo = y.view(np.uint64) & np.uint64((1 << 29) - 1)
    dist = np.abs(lo.astype(np.int64) - (1 << 28))
    near = dist <= _cbrt_window()
    out = y.astype(np.float32)
    out[near] = np.power(x64[near], 1.0 / 3.0).astype(np.float32)
    return out, near


def _midpoint_cases(rng, n):
    """Floats whose cube roots lie at (or next to) float32 midpoints: the
    float32 cube of the midpoint between a float32 and the next."""
    f = np.exp2(rng.uniform(-48.0, 42.0, n)).astype(np.float32)
    nxt = np.nextafter(f, np.float32(np.inf))
    mid = 0.5 * (f.astype(np.float64) + nxt.astype(np.float64))
    x = (mid ** 3).astype(np.float32)
    near = np.concatenate([x, np.nextafter(x, np.float32(0)),
                           np.nextafter(x, np.float32(np.inf))])
    return near[np.isfinite(near) & (near > 0)]


def test_cube_root_rule_equals_the_float64_pow():
    rng = np.random.default_rng(2024)
    # every binade of the positive floats, subnormals included
    bits = rng.integers(1, 0x7F800000, 10 ** 6, dtype=np.uint32)
    x = np.concatenate([bits.view(np.float32),
                        _midpoint_cases(rng, 200_000),
                        np.array([0.0, np.inf, 1.0, 8.0, 27.0, 1e-45,
                                  np.finfo(np.float32).max], np.float32)])
    got, near = cube_root(x)
    want = np.power(x.astype(np.float64), 1.0 / 3.0).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the window catches the midpoint cases and almost nothing else
    assert near.sum() > 0
    assert near[:10 ** 6].mean() < 1e-4
    # away from the window, cbrt and pow agree to a few float64 ulps
    x64 = x[np.isfinite(x) & (x > 0)].astype(np.float64)
    ulps = np.abs(np.cbrt(x64).view(np.int64)
                  - np.power(x64, 1.0 / 3.0).view(np.int64))
    assert ulps.max() < _cbrt_window() // 4, ulps.max()


def test_planner_maps_the_rank_in_the_displacement_phase():
    p = Params(GridSize=64, BoxSize=64.0, output_z=[0.0], norad=True,
               plc_enabled=False)
    phases = planner._dense_phases(p, 0.5)
    assert phases["displacements"]["needed_rank"] == 4.0 * 64 ** 3
    # gather_rows' scratch, one 32-byte record per needed row, beside the
    # set's stacks but not its transforms' buffers
    gather = phases["row gather"]
    assert gather["row_records"] == 4.0 * compact.ROW_RECORD * 0.5 * 64 ** 3
    assert gather["needed_rank"] == 4.0 * 64 ** 3
    assert "ifft2_out" not in gather
    assert sum(gather.values()) < sum(phases["displacements"].values())


def _quarter_turns():
    """kQuarter of csrc/ic_kdensity.cu, its float32 hex literals."""
    with open(IC_CU) as fd:
        m = re.search(r"kQuarter\[8\] = \{([^}]*)\}", fd.read())
    lits = [t.strip().rstrip("f") for t in m.group(1).split(",")]
    return np.array([float.fromhex(t) for t in lits], np.float32)


def _generator_phases():
    """Every phase the kernels can draw, as the plain version computes it:
    jax.random.uniform of each of the 2^23 mantissas scaled to [0, 2 pi)
    in float32, then the same plus float32(pi) (PairedIC)."""
    k = np.arange(2 ** 23, dtype=np.uint32)
    u = (k | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    ph = np.maximum(np.float32(0.0), u * np.float32(2.0 * np.pi)
                    + np.float32(0.0))
    return np.concatenate([ph, ph + np.float32(np.pi)])


def test_dead_mode_signs_follow_the_phase():
    q = _quarter_turns()
    # each is the least float32 above k pi / 2
    for k, v in enumerate(q, start=1):
        assert float(v) > k * np.pi / 2
        assert float(np.nextafter(v, np.float32(0.0))) < k * np.pi / 2
    ph = _generator_phases()
    assert ph.dtype == np.float32 and ph.max() < q[-1]
    # the parity of the odd quarter turns at or below the phase (cos), of
    # the even ones (sin)
    beyond = [ph >= v for v in q]
    cneg = beyond[0] ^ beyond[2] ^ beyond[4] ^ beyond[6]
    sneg = beyond[1] ^ beyond[3] ^ beyond[5] ^ beyond[7]
    x = ph.astype(np.float64)
    np.testing.assert_array_equal(cneg, np.cos(x) < 0)
    np.testing.assert_array_equal(sneg, np.sin(x) < 0)
    # numpy's float32 cos and sin give the same signs
    np.testing.assert_array_equal(cneg, np.signbit(np.cos(ph)))
    np.testing.assert_array_equal(sneg, np.signbit(np.sin(ph)))


def _div(n, d):
    """The kernels' n // d for 0 <= n < 2^31 (csrc/ic_kdensity.cu Div)."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << (31 + s)) + d - 1) // d
    assert m < 2 ** 32
    return (n * np.uint64(m)) >> np.uint64(31 + s)


def test_division_by_a_multiply():
    top = 2 ** 31 - 1
    for d in list(range(1, 2 ** 16 + 1)) + [2 ** 31 - 1, 2 ** 30 + 1]:
        # the largest numerators, and those on either side of a multiple
        q = top // d
        n = [0, 1, d - 1, d, top, top - 1, q * d, q * d - 1, (q // 2) * d,
             (q // 2) * d - 1]
        n = np.array([v for v in n if 0 <= v <= top], np.uint64)
        np.testing.assert_array_equal(_div(n, d), n // np.uint64(d))
