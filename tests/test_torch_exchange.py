"""The port's cross-host exchange (parallel/exchange.py, with K15-K17 as
their plain versions on the CPU), with hosts mocked over 8 CPU shards as
the JAX package's tests mock them over 8 virtual devices (test_exchange.py,
test_multihost.py); the parity with the JAX package's exchange_products on
the same products is tests/test_torch_exchange_jax*.py.

On the port's own products over a pencil and a slab mesh: each host's set
equals a brute-force selection for 2 and 4 hosts, single-turn, turn 0 and
turn 1, with the per-device loads of the JAX package's round-robin rule;
the turn-1 paint equals JAX's _paint_block shard by shard; the union of
the host-sliced catalogs equals the single-process multibox run exactly
(single- and two-turn, every output); RECOMPUTE sets are routed row for
row; the local fetch partitions the products; a host without a sub-box
raises; the plain count and pack follow their definitions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pinocchio_tpu.parallel import exchange as jexchange
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fragment.driver import run_fragmentation
from pinocchio_tpu_torch.fragment.subbox import (
    _base_mask, choose_nbox, quick_pass_spheres,
    run_fragmentation_multibox, subbox_geometries)
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.ops import exchange as ops
from pinocchio_tpu_torch.parallel import driver, exchange, pfft
from pinocchio_tpu_torch.parallel.multihost import (fetch_local_sparse,
                                                    host_subboxes)
from torch_params import bench_kwargs

torch.set_num_threads(2)

N = 32
CPU8 = ["cpu"] * 8
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)


def _geoms(p, cosmo, ntasks):
    largest = largest_halo_mass(p, cosmo)
    nbox = choose_nbox(p, cosmo, largest, ntasks)
    return subbox_geometries(p, cosmo, largest, nbox), nbox, largest


def _port_mesh(kind):
    if kind == "pencil":
        return pfft.make_pencil_mesh(8, devices=CPU8)
    return pfft.make_mesh(8, devices=CPU8)


def _spheres(p, cosmo, fr, geoms, nhosts):
    """Each host's boundary spheres from one quick pass per own sub-box
    over the whole products."""
    full = dataclasses.replace(fr, host_products=fetch_local_sparse(fr),
                               handoff=None)
    out = {}
    for h in range(nhosts):
        parts = [np.zeros((0, 4), np.float32)]
        for g in host_subboxes(geoms, h, nhosts):
            base, r1, r2 = _base_mask(g)
            q = run_fragmentation(p, cosmo, full, geom=g, cell_mask=base,
                                  quick=True, verbose=False)
            parts.append(quick_pass_spheres(p, g, q, r1, r2))
        out[h] = np.concatenate(parts)
    return out


def _by_cell(sp):
    o = np.argsort(sp.ci, kind="stable")
    return sp.ci[o], sp.F[o], {k: v[o] for k, v in sp.vel.items()}


def _jax_rule_loads(F, Flast, regions_or_maps, host_devs, blocks):
    """Each destination device's rows under the JAX package's pack_local
    rule: a source shard's members of host h in C order, rank i to
    host_devs[h][i % nd]."""
    loads = np.zeros(len(blocks), np.int64)
    for x0, nx, y0, ny, z0, nz in blocks:
        sl = (slice(x0, x0 + nx), slice(y0, y0 + ny), slice(z0, z0 + nz))
        need = F[sl] >= Flast
        for h, devs in enumerate(host_devs):
            m = need & regions_or_maps(h, sl)
            c = int(m.sum())
            for j, q in enumerate(devs):
                loads[q] += max(0, -(-(c - j) // len(devs)))
    return loads


def _member_grid(boxes):
    coord = np.arange(N)
    m = np.zeros((N, N, N), bool)
    for (x0, lx), (y0, ly), (z0, lz) in boxes:
        m |= (((coord - x0) % N < lx)[:, None, None]
              & ((coord - y0) % N < ly)[None, :, None]
              & ((coord - z0) % N < lz)[None, None, :])
    return m


@pytest.fixture(scope="module", params=["pencil", "slab"])
def port_products(request):
    """The port's classic fmax over a pencil (2x4) or slab mesh of 8 CPU
    shards with the hand-off deferred (kept on the shards)."""
    return _mesh_run(request.param)


@pytest.mark.parametrize("nhosts", [2, 4])
@pytest.mark.parametrize("turn", [None, 0, 1])
def test_exchange_matches_bruteforce(port_products, nhosts, turn):
    """(b) Each host's set equals the brute-force selection from the
    gathered products (the needed cells of its padded volumes, turn-0
    regions or clipped spheres; JAX test_exchange.py:31-46), in the
    sweep's order, with F and rows equal to the grid's; each destination
    device's load follows the JAX package's round-robin rule; a cell
    needed by two hosts reaches both."""
    p, cosmo, fr, _ = port_products
    decomp = fr.handoff.decomp
    geoms, _, _ = _geoms(p, cosmo, 4)
    spheres = (_spheres(p, cosmo, fr, geoms, nhosts) if turn == 1
               else None)
    stats = {}
    got = exchange.exchange_products(fr, geoms, nhosts,
                                     turn=turn, spheres=spheres, stats=stats)
    F, _ = fr.products.gather()
    whole = fetch_local_sparse(fr)
    row = {c: i for i, c in enumerate(whole.ci.tolist())}
    pad = exchange.build_host_regions(geoms, nhosts, N)
    t0 = exchange.build_host_regions(geoms, nhosts, N, turn0=True)
    sels = []
    for h in range(nhosts):
        if turn == 1:
            sel = np.zeros((N, N, N), bool)
            for cx, cy, cz, r in spheres.get(h, []):
                s = int(r)
                off = np.arange(-s, s)
                gx, gy, gz = ((int(c) + off) % N for c in (cx, cy, cz))
                ball = (off[:, None, None] ** 2 + off[None, :, None] ** 2
                        + off[None, None, :] ** 2 <= s * s)
                i, j, k = np.nonzero(ball)
                sel[gx[i], gy[j], gz[k]] = True
            sel &= _member_grid(pad[h]) & ~_member_grid(t0[h])
        else:
            sel = _member_grid((t0 if turn == 0 else pad)[h])
        sels.append(sel)
        sp = got[h]
        assert np.all((np.diff(sp.F) < 0) | ((np.diff(sp.F) == 0)
                                            & (np.diff(sp.ci) > 0)))
        np.testing.assert_array_equal(
            np.sort(sp.ci), np.flatnonzero((sel & (F >= p.Flast)).ravel()))
        idx = np.array([row[c] for c in sp.ci.tolist()], np.int64)
        np.testing.assert_array_equal(sp.F, whole.F[idx])
        for k in whole.vel:
            np.testing.assert_array_equal(sp.vel[k], whole.vel[k][idx])
    if turn != 1:
        host_devs = [[i for i in range(8) if i // (8 // nhosts) == h]
                     for h in range(nhosts)]
        loads = _jax_rule_loads(F, p.Flast, lambda h, sl: sels[h][sl],
                                host_devs, [decomp.real_block(i)
                                            for i in range(8)])
        assert stats["device_rows"] == loads.tolist()
        both = sels[0] & sels[1] & (F >= p.Flast)
        assert both.any()
        c = int(np.flatnonzero(both.ravel())[0])
        assert c in set(got[0].ci.tolist()) and c in set(got[1].ci.tolist())
    assert stats["rows"] == sum(len(s.ci) for s in got.values())
    assert stats["wire_bytes"] == 4 * stats["rows"] * (2 + 3 * 4)


def test_paint_equals_jax_paint_block():
    """(c) The plain K17 paint equals JAX's _paint_block on every shard of
    a pencil and a slab layout: spheres across shard edges and the
    periodic wrap, a radius beyond N/2, a zero radius, 3 hosts."""
    par = Params(**bench_kwargs(N))
    cosmo = Cosmology(par)
    geoms, _, _ = _geoms(par, cosmo, 8)
    H = 3
    pad = exchange.build_host_regions(geoms, H, N)
    t0 = exchange.build_host_regions(geoms, H, N, turn0=True)
    rng = np.random.default_rng(7)
    sph = {h: np.concatenate([
        np.column_stack([rng.integers(0, N, (6, 3)),
                         rng.integers(1, 7, 6)]).astype(np.float32),
        np.array([[0, N - 1, 15, 5], [31, 0, 0, 3], [8, 8, 8, 20],
                  [4, 4, 4, 0]], np.float32)]) for h in range(H)}
    for mesh in (_port_mesh("pencil"), _port_mesh("slab")):
        decomp = pfft.make_decomp(mesh, N)
        maps = exchange.build_turn1_maps(sph, geoms, H, N, decomp)
        for i in range(8):
            x0, nx, y0, ny, z0, nz = decomp.real_block(i)
            sls = (slice(x0, x0 + nx), slice(y0, y0 + ny),
                   slice(z0, z0 + nz))
            for h in range(H):
                want = jexchange._paint_block(sph[h], pad[h], t0[h], N, *sls)
                np.testing.assert_array_equal(maps[i][h].numpy(), want)
        assert sum(int(m.sum()) for m in maps) > 0


def _mesh_run(kind, **kw):
    p = Params(**bench_kwargs(N, **kw))
    cosmo = Cosmology(p)
    gm = None
    if cosmo.scale_dep:
        from pinocchio_tpu_torch.fmax import Smoothing
        from pinocchio_tpu_torch.scaledep import set_scaledep_gm
        gm = set_scaledep_gm(p, cosmo, Smoothing.build(p, cosmo),
                             largest_halo_mass(p, cosmo), verbose=False)
    fr = driver.run_fmax_distributed(p, cosmo, _port_mesh(kind),
                                     scaledep_gm=gm, defer_handoff=True)
    return p, cosmo, fr, gm


@pytest.mark.parametrize("two_turn", [False, True])
def test_host_sliced_catalogs_unite_exactly(port_products, two_turn):
    """(d) The union over 2 hosts of run_fragmentation_multibox(host_slice)
    fed by the exchange equals the single-process multibox on the same
    products exactly (names and masses, every output); the two-turn wire
    carries fewer copies in turn 0 than the single-turn exchange."""
    p, cosmo, fr, _ = port_products
    _, nbox, largest = _geoms(p, cosmo, 4)
    whole = dataclasses.replace(fr, host_products=fetch_local_sparse(fr),
                                handoff=None)
    full = run_fragmentation_multibox(p, cosmo, whole, nbox,
                                      largest_mass=largest,
                                      two_turn=two_turn, verbose=False)
    parts = [run_fragmentation_multibox(p, cosmo, fr, nbox,
                                        largest_mass=largest,
                                        two_turn=two_turn,
                                        host_slice=(h, 2), verbose=False)
             for h in range(2)]
    assert fr.handoff is not None and fr.handoff.bufs is not None
    for iout in range(len(p.output_z)):
        names = np.concatenate([r.catalogs[iout].name for r in parts])
        masses = np.concatenate([r.catalogs[iout].mass for r in parts])
        want = full.catalogs[iout]
        assert len(np.unique(names)) == len(names)
        o, ow = np.argsort(names), np.argsort(want.name)
        np.testing.assert_array_equal(names[o], want.name[ow])
        np.testing.assert_array_equal(masses[o], want.mass[ow])
    assert len(full.catalogs[-1].name) > 0
    if two_turn:
        geoms, _, _ = _geoms(p, cosmo, 4)
        single = exchange.exchange_products(fr, geoms, 2)
        for r in parts:
            assert r.timings["turn0_copies"] > 0
        assert (sum(r.timings["turn0_copies"] for r in parts)
                < sum(len(s.ci) for s in single.values()))


def test_recompute_sets_are_routed():
    """(e) f(R) growth with RECOMPUTE over a pencil mesh: every routed
    displacement set's rows equal the direct selection from the whole
    hand-off, for 2 hosts, single-turn and turn 0."""
    p, cosmo, fr, _ = _mesh_run("pencil", **FR)
    whole = fetch_local_sparse(fr)
    assert len(whole.segments) == len(p.output_z)
    row = {c: i for i, c in enumerate(whole.ci.tolist())}
    geoms, _, _ = _geoms(p, cosmo, 4)
    for turn in (None, 0):
        out = exchange.exchange_products(fr, geoms, 2, turn=turn)
        for h in range(2):
            sp = out[h]
            idx = np.array([row[c] for c in sp.ci.tolist()], np.int64)
            assert len(sp.segments) == len(p.output_z)
            np.testing.assert_array_equal(sp.F, whole.F[idx])
            for seg, want in zip(sp.segments, whole.segments):
                for k in want:
                    np.testing.assert_array_equal(seg[k], want[k][idx])


@pytest.mark.parametrize("turn", [None, 0])
def test_exchange_for_one_host(port_products, turn):
    """exchange_products(hosts=(h,)) routes to and extracts only host h's
    devices, and its products equal host h's of the exchange for every
    host."""
    p, cosmo, fr, _ = port_products
    geoms, _, _ = _geoms(p, cosmo, 4)
    every = exchange.exchange_products(fr, geoms, 4, turn=turn)
    owner = exchange.host_of_device_default(fr.handoff.decomp.mesh, 4)
    for h in range(4):
        stats = {}
        one = exchange.exchange_products(fr, geoms, 4, turn=turn,
                                         hosts=(h,), stats=stats)
        assert list(one) == [h]
        np.testing.assert_array_equal(one[h].ci, every[h].ci)
        np.testing.assert_array_equal(one[h].F, every[h].F)
        np.testing.assert_array_equal(one[h].vel["v1"], every[h].vel["v1"])
        assert stats["rows"] == sum(n for q, n in
                                    enumerate(stats["device_rows"])
                                    if owner[q] == h) == len(one[h].ci)


def test_local_fetch_partitions_the_products():
    """(f) fetch_local_sparse over 2 and 4 mocked hosts (contiguous blocks
    of the mesh): disjoint shares whose union is the whole hand-off."""
    p, _, fr, _ = _mesh_run("pencil")
    full = fetch_local_sparse(fr)
    for H in (2, 4):
        owner = exchange.host_of_device_default(fr.handoff.decomp.mesh, H)
        parts = [fetch_local_sparse(fr, lambda i, h=h: owner[i] == h)
                 for h in range(H)]
        ci = np.concatenate([s.ci for s in parts])
        assert len(np.unique(ci)) == len(ci) == len(full.ci)
        merged = driver.merge_parts(parts, N)
        np.testing.assert_array_equal(merged.ci, full.ci)
        np.testing.assert_array_equal(merged.vel["v1"], full.vel["v1"])
    # the finished hand-off is the same products
    np.testing.assert_array_equal(fr.handoff.finish().ci, full.ci)


def test_host_without_a_subbox_raises():
    """(g) A host that owns no sub-box raises ValueError."""
    p, cosmo, fr, _ = _mesh_run("slab")
    with pytest.raises(ValueError, match="owns no sub-box"):
        run_fragmentation_multibox(p, cosmo, fr, (2, 1, 1),
                                   host_slice=(3, 4), verbose=False)


def test_plain_count_and_pack_follow_their_definitions():
    """The plain K15 and K16 on a ragged shard (n not a multiple of 256),
    9 hosts with wrapped boxes and a host with no box: the bitmask, the
    per-block counts, and every member row at its round-robin slot."""
    rng = np.random.default_rng(3)
    block = (8, 8, 0, 16, 0, 16)
    ncell = 8 * 16 * 16
    cells = torch.from_numpy(np.sort(rng.choice(ncell, 700, replace=False)))
    H = 9
    boxes = [[((rng.integers(0, N), int(rng.integers(4, 40)))
               for _ in range(3))] for _ in range(H - 1)] + [[]]
    regions = tuple(tuple(tuple(dim) for dim in box) for box in boxes)
    bt, bo = exchange.region_tables(regions, "cpu")
    bits, counts = ops.count(cells, block, N, bt, bo, H)
    gx, gy, gz = (8 + cells // 256, cells // 16 % 16, cells % 16)
    for h in range(H):
        m = np.zeros(len(cells), bool)
        for (x0, lx), (y0, ly), (z0, lz) in regions[h]:
            m |= (((gx - x0) % N < lx) & ((gy - y0) % N < ly)
                  & ((gz - z0) % N < lz)).numpy()
        got = ((bits[:, h // 32] >> (h % 32)) & 1).numpy() == 1
        np.testing.assert_array_equal(got, m)
        per_block = np.add.reduceat(m.astype(np.int64),
                                    np.arange(0, len(m), 256))
        np.testing.assert_array_equal(counts[:, h].numpy(), per_block)
    assert counts[:, H - 1].sum() == 0
    # pack: two destinations per host, rows of 2 channels
    n, nch = len(cells), 2
    buf = torch.from_numpy(rng.standard_normal(n * (2 + 3 * nch))
                           .astype(np.float32))
    perm = torch.from_numpy(rng.permutation(n))
    host_devs = torch.tensor([[2 * h, 2 * h + 1] for h in range(H)],
                             dtype=torch.int32)
    host_nd = torch.full((H,), 2, dtype=torch.int32)
    tot = counts.sum(0).tolist()
    seg_n = np.array([(c + 1 - j) // 2 for c in tot for j in range(2)],
                     np.int64)
    rowf = 2 + 3 * nch
    seg_base = np.concatenate([[0], np.cumsum(seg_n * rowf)[:-1]])
    out = torch.zeros(int(seg_n.sum()) * rowf)
    block_off = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    ops.pack(perm, buf, n, bits, block_off, host_nd, host_devs,
             torch.from_numpy(seg_base), torch.from_numpy(seg_n), nch, out)
    for h in range(H):
        mem = np.flatnonzero(((bits[:, h // 32] >> (h % 32)) & 1).numpy())
        for i, t in enumerate(mem):
            q = 2 * h + i % 2
            ns, base, slot = seg_n[q], seg_base[q], i // 2
            r = int(perm[t])
            assert out[base + slot] == buf[r]
            assert out[base + ns + slot] == buf[n + r]
            for ch in range(nch):
                np.testing.assert_array_equal(
                    out[base + 2 * ns + 3 * ch * ns + 3 * slot:][:3].numpy(),
                    buf[2 * n + 3 * ch * n + 3 * r:][:3].numpy())
