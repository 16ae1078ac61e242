"""K17's plan on the CPU, where the kernel cannot run: ops/exchange's
PaintSpheres, built once from all the spheres, cut to a PaintPlan per
shard.  The plan is walked here as csrc/exchange.cu walks it (a block's rows
from its first row to the next block's, one row a sphere; a column's x
and y from its rank in the sphere's square, kept in the ball's disc; its
z cells from the integer square root, cut to the shard in at most two
runs).

- The walk of one sphere's plan covers exactly the cells that the cube walk
  of the plain version (the JAX package's _paint_block) keeps before its
  box tests, each once, on a seeded set of spheres: r = 0, r = 1, a
  fractional r, 2r = N, 2r > N, r >= N (several wraps), a negative r,
  centres on the grid's edge, spheres wholly outside the shard; on slab,
  pencil and odd windows.  Offsets that wrap onto one cell are one cell, so
  the sets compared are of cells.
- The integer square root rule equals a float64 brute force on every
  integer up to 2^22.
- Painting from the walk, with the boxes tested per cell, equals JAX's
  _paint_block on the cases of tests/test_torch_exchange.py (3 hosts on a
  pencil and a slab layout), on quick-pass spheres of the port's own
  products (2 and 4 hosts, as tests/torch_exchange_jax_cases.py draws
  them), and on 16 hosts with random boxes (wrapped, one wider than the
  grid) and one host with neither boxes nor spheres.
"""

import numpy as np
import pytest
import torch

from pinocchio_tpu.parallel import exchange as jexchange
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fragment.subbox import choose_nbox, subbox_geometries
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.ops import exchange as ops
from pinocchio_tpu_torch.parallel import driver, exchange, pfft
from torch_exchange_jax_cases import _spheres as quick_pass_spheres
from torch_params import bench_kwargs

torch.set_num_threads(2)

N = 32

# (cx, cy, cz, r) at N = 32
ADVERSARIAL = np.array([
    [5, 6, 7, 0], [9, 9, 9, 1], [20, 3, 30, 2.7], [1, 30, 16, 0.5],
    [16, 16, 16, 16], [0, 31, 5, 20], [31, 31, 0, 32], [3, 17, 29, 40],
    [12, 12, 12, 75], [0, 0, 0, 7], [31, 0, 31, 9], [25, 25, 25, -2],
    [24, 26, 2, 3], [8, 20, 11, 15.99], [30, 2, 18, 17]], np.float32)

# (x0, nx, y0, ny, z0, nz): the whole grid, a slab, a pencil and odd windows
WINDOWS = [(0, N, 0, N, 0, N), (8, 4, 0, N, 0, N), (16, 16, 0, 16, 0, N),
           (5, 7, 3, 11, 13, 19), (29, 3, 31, 1, 0, 1), (0, 1, 7, 25, 30, 2)]


def isqrt(q):
    """floor(sqrt(q)) of int64 q in [0, 2^30] by K17's rule: the float32
    square root, truncated, then one step up or down."""
    q = np.asarray(q, np.int64)
    z = np.sqrt(q.astype(np.float32)).astype(np.int64)
    z -= z * z > q
    z += (z + 1) * (z + 1) <= q
    return z


def walk(plan):
    """The kernel's walk of a plan: (host, lx, ly, lz) of every cell of
    every column in a ball's disc, before the box tests (each block's rows
    are the ones from its first row to the next block's)."""
    N_, (x0, nx, y0, ny, z0, nz) = plan.N, plan.block
    empty = np.zeros(0, np.int64)
    if plan.ncols == 0:
        return (empty,) * 4
    rows = plan.rows.astype(np.int64)
    col0 = rows[:, 7]
    c = np.arange(plan.ncols)
    b = c // ops.PAINT_COLS
    r0 = plan.first[b]
    r1 = np.append(plan.first[1:], len(rows) - 1)[b]
    assert np.all(r1 - r0 <= ops.PAINT_COLS)
    row = np.searchsorted(col0, c, side="right") - 1
    assert np.all((r0 <= row) & (row <= r1))
    rw = rows[row]
    j = c - rw[:, 7]
    ix, iy = j // rw[:, 6], j % rw[:, 6]
    lx = np.where(ix < rw[:, 1], rw[:, 0] + ix, rw[:, 2] + ix - rw[:, 1])
    ly = np.where(iy < rw[:, 4], rw[:, 3] + iy, rw[:, 5] + iy - rw[:, 4])
    assert np.all((lx >= 0) & (lx < nx) & (ly >= 0) & (ly < ny))
    cx, cy, cz, r, h = rw[:, 8:13].T

    def dist(g, cc):
        d = (g - cc) % N_
        return np.minimum(d, N_ - d)
    q = r * r - dist(x0 + lx, cx) ** 2 - dist(y0 + ly, cy) ** 2
    disc = np.flatnonzero(q >= 0)
    lx, ly, cz, r, h = lx[disc], ly[disc], cz[disc], r[disc], h[disc]
    zr = isqrt(q[disc])
    zlen = zr + np.minimum(zr, r - 1) + 1
    a = (cz - zr) % N_
    full = zlen >= N_
    lo = [np.where(full, 0, a), np.zeros_like(a)]
    hi = [np.where(full, N_, np.minimum(a + zlen, N_)),
          np.where(full, 0, np.maximum(a + zlen - N_, 0))]
    out = []
    for k in range(2):
        zs = np.maximum(lo[k], z0) - z0
        ze = np.minimum(hi[k], z0 + nz) - z0
        n = np.maximum(ze - zs, 0)
        col = np.repeat(np.arange(len(disc)), n)
        lz = zs[col] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        out.append((col, lz))
    col = np.concatenate([o[0] for o in out])
    lz = np.concatenate([o[1] for o in out])
    return h[col], lx[col], ly[col], lz


def cube_cells(sphere, block, N_):
    """The local cells that _paint_block's cube walk keeps for one sphere
    before its box tests."""
    x0, nx, y0, ny, z0, nz = block
    cx, cy, cz, s = np.asarray(sphere, np.float64)
    s = int(s)
    if s <= 0:
        return set()
    off = np.arange(-s, s)
    loc, keep = [], []
    for c, o, e in ((cx, x0, nx), (cy, y0, ny), (cz, z0, nz)):
        ld = (int(c) + off) % N_ - o
        k = (ld >= 0) & (ld < e)
        loc.append(ld[k])
        keep.append(off[k])
    sel = (keep[0][:, None, None] ** 2 + keep[1][None, :, None] ** 2
           + keep[2][None, None, :] ** 2 <= s * s)
    i, j, k = np.nonzero(sel)
    return set(zip(loc[0][i].tolist(), loc[1][j].tolist(),
                   loc[2][k].tolist()))


def _sphere_sets():
    rng = np.random.default_rng(11)
    rand = np.column_stack([rng.integers(0, N, (24, 3)),
                            rng.uniform(-1, 24, 24)]).astype(np.float32)
    return np.concatenate([ADVERSARIAL, rand])


@pytest.mark.parametrize("block", WINDOWS)
def test_plan_covers_the_cube_walks_cells(block):
    """One sphere's plan, walked as the kernel walks it, gives each cell of
    the ball that the cube walk keeps in the shard once, and no other; a
    plan of all the spheres walks each sphere's cells under its host."""
    sph = _sphere_sets()
    owner = np.arange(len(sph), dtype=np.int32) % 5
    union = set()
    for s, h in zip(sph, owner):
        plan = ops.PaintSpheres(s[None], np.array([h]), N).plan(block)
        hh, lx, ly, lz = walk(plan)
        got = list(zip(lx.tolist(), ly.tolist(), lz.tolist()))
        want = cube_cells(s, block, N)
        assert len(got) == len(set(got)), f"a cell twice for {s}"
        assert set(got) == want, f"sphere {s} in {block}"
        assert np.all(hh == h)
        union |= {(int(h),) + g for g in want}
    hh, lx, ly, lz = walk(ops.PaintSpheres(sph, owner, N).plan(block))
    assert set(zip(hh.tolist(), lx.tolist(), ly.tolist(),
                   lz.tolist())) == union


def test_plan_sizes():
    """The plan drops r <= 0 and spheres outside the shard, gives each
    sphere one row of its square's columns in the shard, counts its blocks,
    and refuses a grid whose r^2 leaves an int32 and a block that wraps."""
    sph = np.array([[5, 5, 5, 0], [5, 5, 5, -1], [5, 5, 5, 2],
                    [30, 30, 30, 2]], np.float32)
    plan = ops.PaintSpheres(sph, np.zeros(4, np.int32), N).plan(
        (0, 8, 0, 8, 0, 8))
    assert plan.nrows == 1                  # the r = 2 at x, y 3..6
    assert plan.ncols == 16
    hh, lx, ly, _ = walk(plan)
    assert len(set(zip(lx.tolist(), ly.tolist()))) == 11 == len(
        {(x, y) for x, y, _ in cube_cells(sph[2], plan.block, N)})
    assert plan.nblocks == 1 and list(plan.first) == [0]
    big = ops.PaintSpheres(np.array([[0, 0, 0, 40], [3, 3, 3, 1]],
                                    np.float32), np.zeros(2, np.int32),
                           N).plan((0, N, 0, N, 0, N))
    assert big.nrows == 2 and big.ncols == N * N + 4
    assert big.nblocks == N * N // ops.PAINT_COLS + 1
    assert list(big.first) == [0] * (big.nblocks - 1) + [1]
    with pytest.raises(ValueError, match="above"):
        ops.PaintSpheres(sph, np.zeros(4, np.int32), ops.PAINT_MAX_N + 1)
    with pytest.raises(ValueError, match="not a window"):
        ops.PaintSpheres(sph, np.zeros(4, np.int32), N).plan(
            (30, 4, 0, 8, 0, 8))


def test_isqrt_rule_equals_float64_brute_force():
    """floor(sqrt(q)) by K17's rule (float32 root, one step either way) on
    every integer q up to 2^22, against float64 and its square check."""
    q = np.arange(2 ** 22 + 1, dtype=np.int64)
    want = np.floor(np.sqrt(q.astype(np.float64))).astype(np.int64)
    assert np.all(want * want <= q) and np.all((want + 1) ** 2 > q)
    assert np.array_equal(isqrt(q), want)


def paint_from_plan(plan, pad, t0, nhosts):
    """The kernel's map from its plan (walk) and the boxes tested per
    cell: uint8 [H, nx, ny, nz]."""
    x0, nx, y0, ny, z0, nz = plan.block
    out = np.zeros((nhosts, nx, ny, nz), np.uint8)
    h, lx, ly, lz = walk(plan)
    g = (x0 + lx, y0 + ly, z0 + lz)

    def member(regions):
        m = np.zeros(len(h), bool)
        for hh in range(nhosts):
            at = h == hh
            for box in regions[hh]:
                m[at] |= np.all([(gd[at] - b0) % N < L for gd, (b0, L)
                                 in zip(g, box)], axis=0)
        return m
    keep = member(pad) & ~member(t0)
    out[h[keep], lx[keep], ly[keep], lz[keep]] = 1
    return out


def _against_jax(sph, pad, t0, nhosts, blocks):
    """Paint every block from the plan and compare each host's map with
    JAX's _paint_block; returns the painted cells."""
    hosts = [h for h in range(nhosts) if len(sph.get(h, ()))]
    all_sph = (np.concatenate([sph[h] for h in hosts]).astype(np.float32)
               if hosts else np.zeros((0, 4), np.float32))
    owner = np.concatenate([np.full(len(sph[h]), h, np.int32)
                            for h in hosts] or [np.zeros(0, np.int32)])
    balls = ops.PaintSpheres(all_sph, owner, N)
    painted = 0
    for block in blocks:
        x0, nx, y0, ny, z0, nz = block
        sls = (slice(x0, x0 + nx), slice(y0, y0 + ny), slice(z0, z0 + nz))
        got = paint_from_plan(balls.plan(block), pad, t0, nhosts)
        for h in range(nhosts):
            if h in hosts:
                want = jexchange._paint_block(sph[h], pad[h], t0[h], N,
                                              *sls)
            else:
                want = np.zeros((nx, ny, nz), np.uint8)
            np.testing.assert_array_equal(got[h], want)
        painted += int(got.sum())
    return painted


def _bench(nhosts, ntasks):
    p = Params(**bench_kwargs(N))
    cosmo = Cosmology(p)
    largest = largest_halo_mass(p, cosmo)
    geoms = subbox_geometries(p, cosmo, largest,
                              choose_nbox(p, cosmo, largest, ntasks))
    return (p, cosmo, geoms, exchange.build_host_regions(geoms, nhosts, N),
            exchange.build_host_regions(geoms, nhosts, N, turn0=True))


def _blocks(kind):
    mesh = (pfft.make_pencil_mesh(8, devices=["cpu"] * 8) if kind == "pencil"
            else pfft.make_mesh(8, devices=["cpu"] * 8))
    decomp = pfft.make_decomp(mesh, N)
    return [decomp.real_block(i) for i in range(8)], mesh


@pytest.mark.parametrize("kind", ["pencil", "slab"])
def test_paint_from_plan_equals_jax_on_the_exchange_cases(kind):
    """test_torch_exchange.py's case: 3 hosts, random spheres and spheres
    across the shard edges and the wrap, a radius beyond N/2, a zero
    radius; and the adversarial spheres, on every shard."""
    _, _, _, pad, t0 = _bench(3, 8)
    rng = np.random.default_rng(7)
    sph = {h: np.concatenate([
        np.column_stack([rng.integers(0, N, (6, 3)),
                         rng.integers(1, 7, 6)]).astype(np.float32),
        np.array([[0, N - 1, 15, 5], [31, 0, 0, 3], [8, 8, 8, 20],
                  [4, 4, 4, 0]], np.float32)]) for h in range(3)}
    sph[1] = np.concatenate([sph[1], ADVERSARIAL])
    blocks, _ = _blocks(kind)
    assert _against_jax(sph, pad, t0, 3, blocks + WINDOWS[3:]) > 0


@pytest.mark.parametrize("nhosts", [2, 4])
def test_paint_from_plan_equals_jax_on_quick_pass_spheres(nhosts):
    """Each host's boundary spheres from one quick pass per own sub-box
    over the port's products (a pencil mesh of 8 CPU shards), as the
    exchange's parity cases draw them."""
    p, cosmo, geoms, pad, t0 = _bench(nhosts, 4)
    blocks, mesh = _blocks("pencil")
    fr = driver.run_fmax_distributed(p, cosmo, mesh, defer_handoff=True)
    sph = quick_pass_spheres(p, cosmo, fr, geoms, nhosts)
    fr.handoff.release()
    assert sum(len(s) for s in sph.values()) > 0
    assert _against_jax(sph, pad, t0, nhosts, blocks) > 0


def test_paint_from_plan_equals_jax_with_16_hosts():
    """16 hosts with one to three random boxes each (some wrapped, one
    wider than the grid), the last host with no box and no sphere."""
    rng = np.random.default_rng(5)
    H = 16

    def boxes():
        out = [tuple(tuple((int(rng.integers(0, N)),
                            int(rng.integers(N // 8, N + N // 4)))
                           for _ in range(3))
                     for _ in range(rng.integers(1, 4)))
               for _ in range(H - 1)] + [()]
        out[0] += (((N - 5, N + 9), (0, N), (N - 3, 12)),)
        return tuple(out)
    pad, t0 = boxes(), boxes()
    sph = {h: np.column_stack([rng.integers(0, N, (8, 3)),
                               rng.uniform(0, 12, 8)]).astype(np.float32)
           for h in range(H - 1)}
    sph[3] = np.concatenate([sph[3], ADVERSARIAL])
    blocks, _ = _blocks("pencil")
    assert _against_jax(sph, pad, t0, H, blocks + WINDOWS) > 0
