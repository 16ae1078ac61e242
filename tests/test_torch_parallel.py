"""The port's mesh decompositions, distributed transforms, shard kernels'
plain versions and sharded hand-off, on 8-shard CPU meshes against the JAX
package on its 8 virtual CPU devices (tests/conftest.py) and against the
port's single-device functions, at N = 32.

Tolerances:
- the forward transform within rtol 2e-4, atol 2e-2 of np.fft.rfftn, the
  round trip within 1e-4, padded kz planes exactly zero (JAX
  test_parallel.py);
- the distributed Hessian and first-derivative stacks within 2e-4 of the
  maximum of JAX's distributed ones on the same delta (JAX
  test_parallel.py:78; float32 FFT round-off in another order);
- delta(k) over every mesh bit-equal to the port's single-device delta
  (every mode draws at its global counter), and so within 1e-5 of the
  maximum of JAX's build_kdensity with the same empty modes (the port's
  single-device tolerance: float32 transcendentals differ by ulps);
- a shard kernel's plain version on any window bit-equal to the full-grid
  plain version there, exact zeros on the padded planes;
- the sharded hand-off exactly equal to the single-device SparseProducts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.grids import Grid as JGrid
from pinocchio_tpu.parallel import pfft as jpfft
from pinocchio_tpu.parallel.driver import build_kdensity as jax_build_kdensity
from pinocchio_tpu_torch import fmax, ic, planner
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.grids import Grid
from pinocchio_tpu_torch.ops import compact, derivatives
from pinocchio_tpu_torch.parallel import driver, pfft
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
CPU8 = ["cpu"] * 8
# name -> (the port's mesh builder, JAX's), both over 8 devices
MESHES = {
    "slab8": (lambda: pfft.make_mesh(8, devices=CPU8),
              lambda: jpfft.make_mesh(8)),
    "pencil42": (lambda: pfft.make_pencil_mesh(8, (4, 2), devices=CPU8),
                 lambda: jpfft.make_pencil_mesh(8, (4, 2))),
    "pencil24": (lambda: pfft.make_pencil_mesh(8, (2, 4), devices=CPU8),
                 lambda: jpfft.make_pencil_mesh(8, (2, 4))),
    "vol222": (lambda: pfft.make_volume_mesh(8, devices=CPU8),
               lambda: jpfft.make_volume_mesh(8)),
    "vol421": (lambda: pfft.make_volume_mesh(8, (4, 2, 1), devices=CPU8),
               lambda: jpfft.make_volume_mesh(8, (4, 2, 1))),
}


def _decomps(name):
    mine, theirs = MESHES[name]
    return pfft.make_decomp(mine(), N), jpfft.make_decomp(theirs(), N)


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
def test_mesh_factorizations_match_jax(n):
    assert pfft.make_mesh(n, devices=["cpu"] * n).devices.shape == (n,)
    for mine, theirs in ((pfft.make_pencil_mesh, jpfft.make_pencil_mesh),
                         (pfft.make_volume_mesh, jpfft.make_volume_mesh)):
        assert (mine(n, devices=["cpu"] * n).devices.shape
                == theirs(n).devices.shape)
    auto = pfft.mesh_for(n, devices=["cpu"] * n)
    assert len(auto.axis_names) == (2 if n >= 4 and n % 2 == 0 else 1)


def test_mesh_without_its_cards_raises():
    """With n alone a mesh takes cuda:0..n-1 and raises when fewer cards
    exist; only an explicit device list may repeat a device."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for make in (pfft.make_mesh, pfft.make_pencil_mesh,
                 pfft.make_volume_mesh):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make(have + 1)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        pfft.mesh_for(have + 4, "auto")
    with pytest.raises(ValueError):
        pfft.make_pencil_mesh(8, (3, 3), devices=CPU8)


@pytest.mark.parametrize("name", MESHES)
def test_roundtrip_and_forward(name):
    decomp, _ = _decomps(name)
    r = np.random.default_rng(7).standard_normal((N, N, N)).astype(
        np.float32)
    k = pfft.distributed_rfft3(decomp, decomp.scatter(r))
    full = decomp.gather(k, kspace=True)
    assert full.shape == (N, N, decomp.Nhp)
    Nh = N // 2 + 1
    np.testing.assert_allclose(full[:, :, :Nh], np.fft.rfftn(r), rtol=2e-4,
                               atol=2e-2)
    assert np.all(full[:, :, Nh:] == 0)
    back = pfft.distributed_irfft3(decomp, k)
    assert np.abs(decomp.gather(back) - r).max() < 1e-4


def _delta(seed=3):
    rng = np.random.default_rng(seed)
    Nh = N // 2 + 1
    return (rng.standard_normal((N, N, Nh))
            + 1j * rng.standard_normal((N, N, Nh))).astype(np.complex64)


def _growth_table():
    """A growth table over log10 |k| (grid units) that varies with k, on
    the range of fmax.growth_k_tables."""
    lo = float(np.float32(np.log10(2.0 * np.pi / N) - 2.0))
    logk = np.linspace(lo, np.log10(np.pi * np.sqrt(3.0)) + 0.1, 512)
    gtab = (0.6 + 0.1 * np.sin(3.0 * logk)).astype(np.float32)
    return gtab, lo, float(np.float32(logk[1] - logk[0]))


@pytest.mark.parametrize("which", ["second", "first", "first_tab"])
@pytest.mark.parametrize("name", MESHES)
def test_distributed_derivatives_match_jax(name, which):
    decomp, jdecomp = _decomps(name)
    kd = _delta()
    kpad = np.zeros(jdecomp.k_global_shape, np.complex64)
    kpad[:, :, :N // 2 + 1] = kd
    kdev = jax.device_put(kpad, jdecomp.kspace_sharding())
    shards = decomp.scatter(kd, kspace=True)
    gtab, glo, gdx = _growth_table()
    if which == "second":
        want = jax.jit(jpfft.distributed_second_derivatives(jdecomp))(
            kdev, jnp.float32(1.5))
        got = pfft.distributed_second_derivatives(decomp, shards, 1.5)
    elif which == "first":
        want = jax.jit(jpfft.distributed_first_derivatives(jdecomp))(
            kdev, jnp.float32(0.7))
        got = pfft.distributed_first_derivatives(decomp, shards, 0.7)
    else:
        want = jax.jit(jpfft.distributed_first_derivatives_tab(jdecomp))(
            kdev, jnp.asarray(gtab), jnp.float32(glo), jnp.float32(gdx))
        got = pfft.distributed_first_derivatives_tab(
            decomp, shards, torch.from_numpy(gtab), glo, gdx)
    want = np.asarray(want)
    got = decomp.gather(got)
    assert got.shape == want.shape == ((6,) if which == "second" else (3,)) \
        + (N, N, N)
    assert np.abs(got - want).max() < 2e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def setup():
    jp, p = params_pair(**bench_kwargs(N))
    return jp, JaxCosmology(jp), p, Cosmology(p)


@pytest.mark.parametrize("name", MESHES)
def test_build_kdensity_is_the_single_device_field(setup, name):
    jp, jcosmo, p, cosmo = setup
    decomp, jdecomp = _decomps(name)
    grid = Grid(N, p.BoxSize_htrue)
    got = decomp.gather(driver.build_kdensity(decomp, grid, cosmo,
                                              p.RandomSeed), kspace=True)
    Nh = N // 2 + 1
    assert np.all(got[:, :, Nh:] == 0)
    single = ic.generate_kdensity(grid, cosmo, p.RandomSeed, "cpu").numpy()
    np.testing.assert_array_equal(got[:, :, :Nh].view(np.uint32),
                                  single.view(np.uint32))
    want = np.asarray(jax_build_kdensity(
        jdecomp, JGrid(N=N, BoxSize=jp.BoxSize_htrue), jcosmo,
        jp.RandomSeed))[:, :, :Nh]
    np.testing.assert_array_equal(got[:, :, :Nh] == 0, want == 0)
    assert np.abs(got[:, :, :Nh] - want).max() <= 1e-5 * np.abs(want).max()


# (y0, ny, z0, nz) windows of the [N, N, Nhp] layout, the last two reaching
# into the padding beyond Nh = 17
WINDOWS = [(0, N, 0, N // 2 + 1), (8, 8, 0, 6), (16, 16, 12, 6),
           (4, 4, 15, 5)]


@pytest.mark.parametrize("window", WINDOWS)
def test_shard_twins_are_the_full_grid_on_their_window(setup, window):
    _, _, p, cosmo = setup
    y0, ny, z0, nz = window
    Nh = N // 2 + 1
    nzv = max(0, min(nz, Nh - z0))
    args = ic.kdensity_args(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed)
    tabs = (torch.from_numpy(args[0]), torch.from_numpy(args[1]))
    full = ic.kdensity_plain(N, *tabs, *args[2:], False, False)
    shard = ic.kdensity_shard(N, *tabs, *args[2:], False, False, *window)

    def same(got, want):
        assert torch.equal(torch.view_as_real(got[..., :nzv]),
                           torch.view_as_real(want))
        assert torch.all(got[..., nzv:] == 0)

    sl = (slice(None), slice(y0, y0 + ny), slice(z0, z0 + nzv))
    same(shard, full[sl])
    gtab, glo, gdx = _growth_table()
    gtab = torch.from_numpy(gtab)
    for got, want in (
            (derivatives.hessian_kspace_shard(shard, 1.5, N, y0, z0),
             derivatives.hessian_kspace_plain(full, 1.5, N)),
            (derivatives.gradient_kspace_shard(shard, 0.7, N, y0, z0),
             derivatives.gradient_kspace_plain(full, 0.7, N)),
            (derivatives.gradient_kspace_tab_shard(shard, gtab, glo, gdx, N,
                                                   y0, z0),
             derivatives.gradient_kspace_tab_plain(full, gtab, glo, gdx,
                                                   N))):
        same(got, want[(slice(None),) + sl])


def _single_device_products(F, sets, Flast):
    """The single-device hand-off (fmax.run_fmax's): one sort, the rows of
    every set gathered into one buffer, unpacked."""
    keys = sorted(sets[0])
    idx = compact.needed_order(F, Flast)
    count = idx.numel()
    sizes = [compact.packed_size(count, len(keys), s == 0)
             for s in range(len(sets))]
    buf = torch.empty(sum(sizes))
    off = 0
    for s, vel in enumerate(sets):
        compact.gather_rows(idx, [vel[k] for k in keys],
                            buf[off:off + sizes[s]], F=F if s == 0 else None)
        off += sizes[s]
    return fmax.unpack_products(buf.numpy(), N, count, keys, len(sets))


@pytest.mark.parametrize("nsets", [1, 3])
@pytest.mark.parametrize("name", ["slab8", "pencil42", "vol222"])
def test_sharded_handoff_equals_the_single_device_products(name, nsets):
    """Given one Fmax and one set of displacement stacks, the sharded
    hand-off gives the single-device SparseProducts exactly: the same
    cells in the (-F, ascending cell) order, with many ties in F."""
    decomp, _ = _decomps(name)
    rng = np.random.default_rng(11)
    F = np.round(rng.uniform(-1.0, 3.0, (N, N, N)), 2).astype(np.float32)
    sets = [{k: torch.from_numpy(rng.standard_normal((3, N, N, N)).astype(
        np.float32)) for k in ("v1", "v2")} for _ in range(nsets)]
    Ft = torch.from_numpy(F)
    want = _single_device_products(Ft, sets, 1.0)
    got = driver.sharded_products(
        decomp, decomp.scatter(Ft), 1.0,
        [{k: decomp.scatter(v) for k, v in vel.items()} for vel in sets])
    assert len(want.ci) > 1000
    np.testing.assert_array_equal(got.ci, want.ci)
    np.testing.assert_array_equal(got.F, want.F)
    for g, w in zip(got.segments or [got.vel], want.segments or [want.vel]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert (got.segments is None) == (nsets == 1)
    hist = driver.pdf_hist(decomp, decomp.scatter(Ft))
    np.testing.assert_array_equal(hist, compact.pdf_hist(Ft).numpy())


@pytest.mark.parametrize("ncell", [N ** 3, 2 ** 34])
def test_merge_order_is_the_sweep_order(ncell):
    """Descending F, ties by ascending cell: the 64-bit key (grids up to
    2048^3) and the lexsort beyond give np.lexsort's order."""
    rng = np.random.default_rng(5)
    ci = rng.permutation(N ** 3)[:5000].astype(np.int64) * (ncell // N ** 3)
    F = np.round(rng.uniform(1.0, 4.0, 5000), 1).astype(np.float32)
    np.testing.assert_array_equal(driver.merge_order(F, ci, ncell).numpy(),
                                  np.lexsort((ci, -F)))


def test_demo_step_is_the_same_physics_on_every_mesh():
    F8, R8, d8 = driver.demo_step(pfft.make_pencil_mesh(8, devices=CPU8),
                                  N=N)
    dec = pfft.make_decomp(pfft.make_pencil_mesh(8, devices=CPU8), N)
    F, disp = dec.gather(F8), dec.gather(d8)
    assert F.shape == (N, N, N) and disp.shape == (3, N, N, N)
    assert np.isfinite(F).all()
    Fs, _, ds = driver.demo_step(pfft.make_mesh(8, devices=CPU8), N=N)
    slab = pfft.make_decomp(pfft.make_mesh(8, devices=CPU8), N)
    assert np.allclose(F, slab.gather(Fs), atol=1e-3)
    assert np.allclose(disp, slab.gather(ds), atol=1e-3)


def test_planner_peaks_are_per_device(setup):
    """The per-device fields of a mesh over n devices: the dense engine's
    are 1/n of one device's; of the out-of-core engine's a device holds
    its shard's x-block (a quarter of the grid at 32^3 over 4 shards) and
    kz window (at most 5 of the 17 planes), sorts that x-block and adds
    the hand-off's arrays; the host estimate does not change."""
    _, _, p, cosmo = setup
    one = planner.plan(p, "cpu", cosmo)
    four = planner.plan(p, "cpu", cosmo, n_chips=4)
    assert four["n_chips"] == 4
    assert four["dense"]["peak"] == pytest.approx(one["dense"]["peak"] / 4)
    po, p4 = one["ooc"]["phases"], four["ooc"]["phases"]
    for name in ("fmax", "real_sources"):
        assert p4["sources"][name] == pytest.approx(po["sources"][name] / 4)
    assert p4["v-streams"]["rows_of_one_field"] == pytest.approx(
        po["v-streams"]["rows_of_one_field"] / 4)
    for name in ("source_spectra", "displacement_stack"):
        assert p4["v-streams"][name] == pytest.approx(
            po["v-streams"][name] * 5 / 17)
    assert p4["needed sort"]["needed_sort"] == pytest.approx(
        po["needed sort"]["needed_sort"] / 4)
    assert "merged_positions" in p4["v-streams"]
    assert one["ooc"]["peak"] / 4 < four["ooc"]["peak"] < one["ooc"]["peak"]
    assert four["host"]["phases"]["fmax"] == one["host"]["phases"]["fmax"]
    assert "per device of 4" in planner.format_memory_map(four)
    assert not planner.ooc_selected(p, "cpu", cosmo, n_chips=4)
