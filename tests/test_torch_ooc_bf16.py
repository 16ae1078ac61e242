"""The port's out-of-core engine with 16-bit stacks and spectra
(ooc_dtype "bfloat16" and "float16") against the JAX package's, on the CPU.

The rounding itself is XLA's and PyTorch's round to nearest even: K18's and
K19's plain versions (ops/storage.py) give the JAX engine's stored arrays
bit for bit, on Gaussian values spread over every float32 exponent, with
signed zeros, infinities and float32 subnormals.

The JAX reference runs through tests/torch_jax16.py (XLA's CPU backend has
no bfloat16 dot with a float32 result, so the engine's einsums widen their
16-bit operands first, exactly).  The port's engine rounds its stacks and spectra where the JAX engine does, but
its inverse z transform is cuFFT's float32 irfft where the JAX engine
rounds its DFT bases to the storage type too; so the two 16-bit runs differ
by more than the float32 runs do, and are held to the bounds measured at
32^3: against JAX's run of the same storage type, median |dF| <= 2e-3,
|dF| > 0.01 on at most 1 % of cells and F >= Flast on other sides on at
most 0.1 %; against JAX's float32 run, a median |dF| and a share of
|dF| > 0.01 no larger than JAX's own 16-bit run shows there.

Over shards of the CPU the 16-bit engine equals one device bit for bit (one
x-slab width, as tests/test_torch_ooc_mesh.py explains), and end to end its
halo counts stay within the JAX package's tolerance of the float32 run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinocchio_tpu.fmax_ooc as jfmax_ooc
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu_torch import fmax_ooc, planner
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.ops import storage
from pinocchio_tpu_torch.parallel import pfft
from pinocchio_tpu_torch.run import check_supported, run_pipeline
from torch_jax16 import jax_run_fmax_ooc
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
Nh = N // 2 + 1
DTYPES = ("bfloat16", "float16")
JDTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


def _bits(a):
    """The raw bits of a 16-bit numpy or torch array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16))


def _values(rng, shape):
    """Complex64 values over every float32 exponent, with the edge cases
    of the rounding (signed zeros, infinities, float32 subnormals, the
    float16 overflow threshold) in the first cells."""
    x = rng.standard_normal(shape + (2,)).astype(np.float32)
    x *= (np.float32(10.0) ** rng.integers(-40, 38, x.shape)).astype(
        np.float32)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 65504.0,
                     65519.99, 65520.0, 6e-8, 3e-8, 1.0 + 2 ** -8],
                    np.float32)
    flat = x.reshape(-1)
    flat[:edge.size] = edge
    return flat.view(np.complex64).reshape(shape)


@pytest.fixture(scope="module")
def cosmo32():
    return Cosmology(Params(**bench_kwargs(N)))


@pytest.fixture(scope="module")
def jax_engine():
    """dtype -> a JAX OocEngine at 32^3 storing in it (made on first
    use)."""
    cache = {}

    def get(dt):
        if dt not in cache:
            jp, _ = params_pair(**bench_kwargs(N), ooc_dtype=dt)
            cache[dt] = jfmax_ooc.OocEngine(jp, JaxCosmology(jp),
                                            verbose=False)
        return cache[dt]
    return get


@pytest.fixture(scope="module")
def jax_runs():
    """name -> the JAX package's run_fmax_ooc at 32^3 with ooc_dtype
    float32, bfloat16 or float16 (made on first use)."""
    cache = {}

    def get(dt):
        if dt not in cache:
            jp, _ = params_pair(**bench_kwargs(N), ooc_dtype=dt)
            cache[dt] = jax_run_fmax_ooc(jp)
        return cache[dt]
    return get


@pytest.fixture(scope="module")
def port_runs():
    cache = {}

    def get(dt):
        if dt not in cache:
            p = Params(**bench_kwargs(N), ooc_dtype=dt)
            cache[dt] = fmax_ooc.run_fmax_ooc(p, Cosmology(p), "cpu")
            cache[dt].pending_fetch.join()
        return cache[dt]
    return get


@pytest.mark.parametrize("dt", DTYPES)
def test_store_is_jax_store_uc(dt, jax_engine):
    """K18's plain version (transposing) writes the JAX engine's
    _store_uc arrays bit for bit: a kz batch [B, N, N] into planes
    kz0..kz0+B-1 of the (re, im) stack, [x, kz, y] there and
    [x, y, kz, 2] here."""
    jeng = jax_engine(dt)
    rng = np.random.default_rng(1)
    kz0, B = 3, 5
    w = _values(rng, (B, N, N))
    out = [jeng.zeros_half(), jeng.zeros_half()]
    jeng._store_uc(out, 0, jnp.asarray(w), kz0)
    stack = torch.zeros((1, N, N, Nh, 2), dtype=storage.DTYPES[dt])
    storage.store_kz(torch.from_numpy(w)[None], stack, kz0)
    for part in (0, 1):
        want = _bits(out[part]).transpose(0, 2, 1)        # [x, y, kz]
        np.testing.assert_array_equal(_bits(stack[0, ..., part]), want)


@pytest.mark.parametrize("dt", DTYPES)
def test_spectrum_rounding_and_widening_are_jax_bits(dt, jax_engine):
    """The spectra: K18's plain version (straight, a z-rfft slab's kz
    window) rounds as rfftz_batch's astype does, and K19's (transposing, a
    kz batch) widens as _read_spec does, bit for bit; a stack's x-slab
    widens exactly."""
    jeng = jax_engine(dt)
    rng = np.random.default_rng(2)
    r = _values(rng, (4, N, Nh))                          # [Bx, N(y), kz]
    k0, W = 2, 9
    dst = torch.zeros((4, N, W, 2), dtype=storage.DTYPES[dt])
    storage.store_rows(torch.from_numpy(r), dst, k0)
    jr = jnp.asarray(r[..., k0:k0 + W])
    want = jnp.stack([jnp.real(jr), jnp.imag(jr)], -1).astype(JDTYPES[dt])
    np.testing.assert_array_equal(_bits(dst), _bits(want))

    # every 16-bit pattern is as likely, but for the infinities (JAX's
    # re + 1j * im takes them to NaN) and the bfloat16 subnormals (XLA's
    # CPU arithmetic flushes float32 subnormals to zero)
    spec = torch.from_numpy(rng.integers(0, 2 ** 16, (N, N, Nh, 2),
                                         dtype=np.uint16).view(np.int16))
    spec = spec.view(storage.DTYPES[dt])
    x = spec.float()
    spec = torch.where(torch.isfinite(x) & ((x == 0) | (
        x.abs() >= torch.finfo(torch.float32).tiny)), spec, 0)
    jspec = jax.lax.bitcast_convert_type(
        jnp.asarray(_bits(spec).transpose(3, 0, 2, 1)), JDTYPES[dt])
    kz0, B = 4, 6
    got = storage.load_kz(spec[None], kz0, B)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jeng._read_spec(
        jspec, kz0, B)))
    slab = storage.load_rows(spec[None], 8, 4)[0]
    np.testing.assert_array_equal(
        torch.view_as_real(slab).view(torch.int32).numpy(),
        spec[8:12].float().view(torch.int32).numpy())


# the kz window of the middle shard of three at 256^3 (43 planes) with its
# kz schedule, a batch at plane 5 (not a multiple of 4) and the one-plane
# batch of a schedule's end, at a small (x, y)
WINDOW = 43
WINDOW_BATCHES = ((0, 16), (16, 16), (32, 11), (5, 16), (WINDOW - 1, 1))


def _jax_pairs(x, dt):
    """The bits of the JAX package's astype of complex64 x as (re, im)
    pairs [..., 2] of the 16-bit type dt."""
    jx = jnp.asarray(x)
    return _bits(jnp.stack([jnp.real(jx), jnp.imag(jx)], -1).astype(
        JDTYPES[dt]))


@pytest.mark.parametrize("dt", DTYPES)
def test_stores_at_odd_windows_are_jax_astype(dt):
    """K18's plain versions at the forms whose kernels take other paths:
    the batches of a 43-plane kz window (16, 16, 11 planes), a batch at
    plane 5 and a one-plane batch into a [2, 8, 8, 43, 2] stack, and
    z-rfft rows whole and from column 43 into 43 planes, bit for bit the
    JAX package's astype of the same numpy values."""
    rng = np.random.default_rng(7)
    n = 8
    stack = torch.zeros((2, n, n, WINDOW, 2), dtype=storage.DTYPES[dt])
    want = np.zeros(stack.shape, np.uint16)
    for a, B in WINDOW_BATCHES:
        batch = _values(rng, (2, B, n, n))
        storage.store_kz_plain(torch.from_numpy(batch), stack, a)
        want[:, :, :, a:a + B] = _jax_pairs(batch, dt).transpose(0, 2, 3, 1,
                                                                 4)
        np.testing.assert_array_equal(_bits(stack), want)
    r = _values(rng, (3, n, 3 * WINDOW))
    for col0, W in ((0, 3 * WINDOW), (WINDOW, WINDOW)):
        dst = torch.zeros((3, n, W, 2), dtype=storage.DTYPES[dt])
        storage.store_rows_plain(torch.from_numpy(r), dst, col0)
        np.testing.assert_array_equal(
            _bits(dst), _jax_pairs(r[..., col0:col0 + W], dt))


@pytest.mark.parametrize("dt", DTYPES)
def test_loads_at_odd_windows_are_jax_astype(dt):
    """K19's plain versions at the same windows of a stack of 16-bit
    patterns (all but NaNs and subnormals, which XLA's CPU flushes), and
    an x-slab of it, bit for bit the JAX package's astype to float32 of
    the same pairs (compared part by part: JAX's re + 1j * im would take
    the infinities to NaN)."""
    rng = np.random.default_rng(8)
    n = 8
    raw = rng.integers(0, 2 ** 16, (2, n, n, WINDOW, 2), dtype=np.uint16)
    stack = torch.from_numpy(raw.view(np.int16)).view(storage.DTYPES[dt])
    x = stack.float()
    stack = torch.where(~torch.isnan(x) & ((x == 0) | torch.isinf(x) | (
        x.abs() >= torch.finfo(torch.float32).tiny)), stack, 0)
    jstack = jax.lax.bitcast_convert_type(jnp.asarray(_bits(stack)),
                                          JDTYPES[dt]).astype(jnp.float32)

    def same(got, want):
        np.testing.assert_array_equal(
            torch.view_as_real(got).numpy().view(np.int32),
            np.asarray(want).view(np.int32))

    for a, B in WINDOW_BATCHES:
        same(storage.load_kz_plain(stack, a, B),
             jnp.transpose(jstack[:, :, :, a:a + B], (0, 3, 1, 2, 4)))
    same(storage.load_rows_plain(stack, 2, 3), jstack[:, 2:5])


def test_store_and_load_refuse_other_types():
    """The wrappers take complex64 on one side and (re, im) pairs of
    bfloat16 or float16 on the other."""
    w = torch.zeros((1, 2, 4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        storage.store_kz(w, torch.zeros((1, 4, 4, 3, 2)), 0)
    with pytest.raises(ValueError, match="planes"):
        storage.store_kz(w, torch.zeros((1, 4, 4, 1, 2),
                                        dtype=torch.bfloat16), 0)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        storage.load_kz(torch.zeros((1, 4, 4, 3, 2), dtype=torch.float64),
                        0, 1)


def _dF(a, b):
    return np.abs(np.asarray(a) - np.asarray(b))


@pytest.mark.parametrize("dt", DTYPES)
def test_run_fmax_ooc_16bit_matches_jax(dt, jax_runs, port_runs):
    """Fmax of the port's 16-bit run against JAX's run of the same storage
    type and against JAX's float32 run, each storage type to the bounds
    of bfloat16 (module docstring), the needed cells F >= Flast, and rows
    of finite values in the sweep's order."""
    p = Params(**bench_kwargs(N), ooc_dtype=dt)
    got = port_runs(dt)
    F = got.products.Fmax.numpy()
    F16, F32, Fb16 = (np.asarray(jax_runs(d).products.Fmax)
                      for d in (dt, "float32", "bfloat16"))
    d16, d32, jd = _dF(F, F16), _dF(F, F32), _dF(Fb16, F32)
    # the statistics, printed under pytest -s (PERF.md cites them)
    for what, d in (("port against JAX's run of its type", d16),
                    ("port against JAX's float32", d32),
                    ("JAX's bfloat16 against its float32", jd)):
        print(f"{dt}: {what}: median |dF| {np.median(d):.3e}, above 0.01 "
              f"{100 * (d > 0.01).mean():.3f} %")
    assert np.median(d16) <= 2e-3
    assert (d16 > 0.01).mean() <= 0.01
    flips = ((F >= p.Flast) != (F16 >= p.Flast)).mean()
    print(f"{dt}: F >= Flast on other sides of JAX's run: "
          f"{100 * flips:.4f} %")
    assert flips <= 1e-3
    assert np.median(d32) <= np.median(jd)
    assert (d32 > 0.01).mean() <= (jd > 0.01).mean()
    sp = got.host_products
    np.testing.assert_array_equal(sp.F, F.reshape(-1)[sp.ci])
    assert np.all(sp.F >= p.Flast) and np.all(np.diff(sp.F) <= 0)
    assert all(np.all(np.isfinite(v)) for v in sp.vel.values())
    np.testing.assert_allclose(got.smoothing.true_variance,
                               jax_runs(dt).smoothing.true_variance,
                               rtol=1e-3)


def test_float32_storage_is_unchanged(port_runs, cosmo32):
    """ooc_dtype "float32" and None are one engine: complex64 stacks."""
    a = port_runs(None)
    b = port_runs("float32")
    np.testing.assert_array_equal(a.products.Fmax.numpy(),
                                  b.products.Fmax.numpy())
    for k in a.host_products.vel:
        np.testing.assert_array_equal(a.host_products.vel[k],
                                      b.host_products.vel[k])
    eng = fmax_ooc.OocEngine(Params(**bench_kwargs(N)), cosmo32, "cpu")
    assert eng.stack(2).dtype == torch.complex64
    assert eng.spec().shape == (N, N, Nh)


@pytest.mark.parametrize("dt", DTYPES)
def test_engine_stores_16_bits(dt, cosmo32):
    """The 16-bit engine's stacks and spectra are (re, im) pairs of the
    storage type, and a spectrum's kz batch reaches K10 as complex64."""
    p = Params(**bench_kwargs(N), ooc_dtype=dt)
    check_supported(dataclasses.replace(p, ooc="on"))
    eng = fmax_ooc.OocEngine(p, cosmo32, "cpu")
    st = eng.stack(3)
    assert st.dtype == storage.DTYPES[dt] and st.shape == (3, N, N, Nh, 2)
    spec = eng.spec()
    spec.zero_()
    assert eng.spec_batch(spec, 2, 4).dtype == torch.complex64
    assert eng.spec(complex64=True).dtype == torch.complex64


def test_shards_equal_one_device_bit_for_bit():
    """bfloat16 storage over 3 CPU shards (kz windows 6 / 6 / 5, uneven
    x-blocks) at one x-slab width: Fmax, variances, FmaxPDF, the needed
    cells, F and every row equal the single-device run's."""
    p = Params(**bench_kwargs(N), ooc_dtype="bfloat16", ooc_z_batch=4)
    cosmo = Cosmology(p)
    one = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu")
    three = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu", mesh=pfft.make_mesh(
        3, devices=["cpu"] * 3))
    one.pending_fetch.join()
    three.pending_fetch.join()
    np.testing.assert_array_equal(three.products.gather()[0],
                                  one.products.Fmax.numpy())
    np.testing.assert_array_equal(three.smoothing.true_variance,
                                  one.smoothing.true_variance)
    np.testing.assert_array_equal(three.pdf_hist, one.pdf_hist)
    a, b = three.host_products, one.host_products
    np.testing.assert_array_equal(a.ci, b.ci)
    np.testing.assert_array_equal(a.F, b.F)
    for k in b.vel:
        np.testing.assert_array_equal(a.vel[k], b.vel[k])


def test_pipeline_16bit_halo_counts_and_dump(tmp_path):
    """run_pipeline at 32^3 with bfloat16 storage: halo counts per output
    within max(10, 6 sqrt(n) + 5 % n) of the float32 run's (the JAX
    package's tolerance, tests/test_ooc.py); its product dump holds float32
    rows, and a restart from it gives the same catalogs."""
    kw = bench_kwargs(N, ooc="on")
    f32 = run_pipeline(Params(**kw), outdir=str(tmp_path), device="cpu",
                       verbose=False, write_outputs=False)
    out = str(tmp_path)
    bf = run_pipeline(Params(**kw, ooc_dtype="bfloat16", DumpProducts=True),
                      outdir=out, device="cpu", verbose=False)
    assert bf["plan"]["engine"] == "out-of-core"
    for a, b in zip(bf["frag"].catalogs, f32["frag"].catalogs):
        n, n32 = len(a.name), len(b.name)
        assert n > 0 and a.z == b.z
        assert abs(n - n32) <= max(10, 6 * np.sqrt(n32) + 0.05 * n32)
    again = run_pipeline(Params(**kw, ReadProductsFromDumps=True),
                         outdir=out, device="cpu", verbose=False,
                         write_outputs=False)
    assert again["fmax"].host_products.vel["v1"].dtype == np.float32
    for a, b in zip(again["frag"].catalogs, bf["frag"].catalogs):
        np.testing.assert_array_equal(a.name, b.name)
        np.testing.assert_array_equal(a.mass, b.mass)


def test_planner_counts_16_bit_storage():
    """The planner's out-of-core map at 1024^3: the stacks and spectra at
    half the float32 bytes, the kz batches complex64 with one widened
    batch where a spectrum is read; the needed sort stays the peak (51.0
    GiB against 57.0); the per-device map of 4 shards follows; the engine
    choice follows the dtype on a card between the two peaks."""
    kw = bench_kwargs(1024, ooc="on")
    maps = {dt: planner.device_peak(Params(**kw, ooc_dtype=dt), True,
                                    frac=0.64)
            for dt in (None, "bfloat16", "float16")}
    f32, b16, h16 = (maps[k]["phases"] for k in maps)
    assert b16 == h16
    half = lambda ph, a: b16[ph][a] * 2 == f32[ph][a]      # noqa: E731
    assert half("cycle", "hessian_stack") and half("sources",
                                                   "hessian_stack")
    assert half("needed sort", "source_spectra")
    assert half("v-streams", "displacement_stack")
    assert half("v-streams", "source_spectra")
    plane = 8.0 * 1024 * 1024 * 16
    assert b16["v-streams"]["kz_batch"] == f32["v-streams"]["kz_batch"] + \
        plane
    assert b16["cycle"]["kz_batch"] == f32["cycle"]["kz_batch"]
    assert maps[None]["phase"] == maps["bfloat16"]["phase"] == "needed sort"
    assert 50.5 < maps["bfloat16"]["peak"] / planner.GiB < 51.5
    assert 56.5 < maps[None]["peak"] / planner.GiB < 57.5
    mesh = {dt: planner.device_peak(Params(**kw, ooc_dtype=dt), True,
                                    frac=0.64, shards=4, n_chips=4)
            for dt in (None, "bfloat16")}
    assert (mesh["bfloat16"]["phases"]["cycle"]["hessian_stack"] * 2
            == mesh[None]["phases"]["cycle"]["hessian_stack"])
    assert mesh["bfloat16"]["peak"] < mesh[None]["peak"]
    cosmo = Cosmology(Params(**kw))
    card = 54.0 * planner.GiB
    fits = {dt: planner.plan(Params(**kw, ooc_dtype=dt), "cuda", cosmo,
                             limit=card)["fits_device"]
            for dt in (None, "bfloat16")}
    assert fits == {None: False, "bfloat16": True}

