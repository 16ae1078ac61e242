"""The port's out-of-core engine (fmax_ooc.py) against the JAX package's and
against the port's dense engine, on the CPU.

The engine's realization is the per-kz-plane key fold of the JAX package's
ic.kdensity_plane_fn.  The port reproduces its keys and its threefry draws
bit for bit (the same zeros, the same Hermitian kz=0 plane); the mode values
agree to float32 rounding of the transcendentals: XLA's CPU backend inlines
its own float32 log and calls its own vector sin, cos and pow, and
PyTorch's CPU versions are other approximations (its float32 sqrt is not
even correctly rounded, where XLA's is), so no twin built on PyTorch's
operators can equal them bit for bit.  Measured 3e-7 of max|delta|; held at
1e-5, the tolerance of K1.  On the card K9 equals its plain twin
exactly (tests/test_torch_cuda.py, chip_smoke.py).

K10's plain twin is held to the JAX engine's own factors times the same
delta at float32 round-off, and the port's half-transform stack to the JAX
engine's (matmul DFTs there, cuFFT-style FFTs here) at 1e-5 of the maximum.

run_fmax_ooc at 32^3 is held to JAX's run_fmax_ooc (float32 storage) with
the tolerances of the JAX package's tests/test_ooc.py: |dF| > 0.01 on fewer
than 0.1 % of cells, median |dF| < 1e-4 (measured 0.08 % and 1.4e-6), grid
variances within 1e-4 (measured 1.2e-7), the needed set equal up to
max(2, 0.1 %) borderline cells (measured 1), the displacement rows of the
common cells within rtol = atol = 3e-3 (measured 1.6e-5).  Against the
port's dense engine on the delta assembled from the same planes the engine
agrees exactly on the CPU (measured), held to the same tolerances.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu import ic as jic
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fmax_ooc import OocEngine as JaxOocEngine
from pinocchio_tpu.fmax_ooc import run_fmax_ooc as jax_run_fmax_ooc
from pinocchio_tpu.grids import Grid as JGrid
from pinocchio_tpu_torch import fmax, fmax_ooc, ic
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fragment.driver import run_fragmentation
from pinocchio_tpu_torch.grids import Grid
from pinocchio_tpu_torch.ops import derivatives
from pinocchio_tpu_torch.run import check_supported, run_pipeline
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
Nh = N // 2 + 1


@pytest.fixture(scope="module")
def setup():
    jp, p = params_pair(**bench_kwargs(N), ooc_dtype="float32")
    return jp, JaxCosmology(jp), p, Cosmology(p)


@pytest.fixture(scope="module")
def gen(setup):
    _, _, p, cosmo = setup
    return ic.PlaneGenerator(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed,
                             "cpu")


@pytest.fixture(scope="module")
def jax_plane(setup):
    jp, jc, _, _ = setup
    return jax.jit(jic.kdensity_plane_fn(JGrid(N=N, BoxSize=jp.BoxSize_htrue),
                                         jc, jp.RandomSeed))


@pytest.fixture(scope="module")
def runs(setup):
    jp, jc, p, cosmo = setup
    jres = jax_run_fmax_ooc(dataclasses.replace(
        jp, sparse_transfer=False, transfer_f16=False), jc, verbose=False,
        overlap=False)
    ooc = fmax_ooc.run_fmax_ooc(p, cosmo, "cpu")
    kd = fmax_ooc.OocEngine(p, cosmo, "cpu").planes.assemble()
    dense = fmax.run_fmax(p, cosmo, "cpu", kdensity=kd)
    return jres, ooc, dense


@pytest.mark.parametrize("kz", [0, 1, N // 2 - 1, N // 2])
def test_plane_keys_and_draws_are_jax_bits(setup, kz):
    """fold_in then split, and the plane's uniform draws, bit for bit."""
    _, _, p, _ = setup
    key = jax.random.fold_in(jax.random.PRNGKey(p.RandomSeed), kz)
    jkp, jka = jax.random.split(key)
    keys = ic.plane_keys(p.RandomSeed, Nh)[kz]
    assert tuple(int(v) for v in keys[:2]) == tuple(np.asarray(jkp).tolist())
    assert tuple(int(v) for v in keys[2:]) == tuple(np.asarray(jka).tolist())
    cnt = torch.arange(N * N)
    for jk, k, lo, hi in ((jkp, keys[:2], 0.0, 2.0 * np.pi),
                          (jka, keys[2:], 1.1754944e-38, 1.0)):
        want = np.asarray(jax.random.uniform(jk, (N, N), jnp.float32, lo, hi))
        got = ic.uniform(tuple(int(v) for v in k), cnt, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.ravel().view(np.uint32))


@pytest.mark.parametrize("kz", [0, 1, N // 2 - 1, N // 2])
def test_kdensity_planes_match_jax(gen, jax_plane, kz):
    want = np.asarray(jax_plane(jnp.int32(kz)))
    got = gen(kz, 1)[0].numpy()
    assert got.dtype == np.complex64 and got.shape == (N, N)
    np.testing.assert_array_equal(got == 0, want == 0)
    if kz == N // 2:                  # the Nyquist plane is empty
        np.testing.assert_array_equal(got, want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if kz == 0:                       # Hermitian, exactly
        idx = (-np.arange(N)) % N
        np.testing.assert_array_equal(got[np.ix_(idx, idx)], np.conj(got))


def test_plane_batches_give_one_field(gen):
    """Any batching of the planes gives the same field."""
    whole = gen(0, Nh)
    parts = torch.cat([gen(kz0, B)
                       for kz0, B in fmax_ooc.kz_schedule(Nh, 7)])
    assert torch.equal(torch.view_as_real(whole), torch.view_as_real(parts))


def test_kz_schedule():
    for n, tgt in ((257, 16), (17, 7), (513, 16), (8, 16)):
        sched = fmax_ooc.kz_schedule(n, tgt)
        cover = sorted(kz for kz0, B in sched for kz in range(kz0, kz0 + B))
        assert cover == list(range(n))
        assert len(sched) <= -(-n // min(tgt, n)) + 1


def _jax_k(jeng, kz0, B):
    kxp, kyp = jeng._kxy()
    kzs = kz0 + jnp.arange(B, dtype=jnp.int32)
    kzv = ((2.0 * jnp.pi / N) * kzs.astype(jnp.float32)).reshape(B, 1, 1)
    k2 = kxp * kxp + kyp * kyp + kzv * kzv
    inv = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
    return kxp, kyp, kzv, inv


@pytest.mark.parametrize("mode", ["hessian", "gradient", "pair",
                                  "gradient_tab"])
def test_ooc_factors_match_jax(setup, gen, mode):
    """K10's and K14's plain twins against the JAX engine's factors
    (fmax_ooc.py _facs_hessian, and the expressions of build_first_batch,
    with a constant and with a tabulated growth, and build_pair_batch)
    times the same delta batch."""
    jp, jc, _, _ = setup
    jeng = JaxOocEngine(jp, jc, verbose=False)
    kz0, B = 3, 7
    d = gen(kz0, B).numpy()
    dj = jnp.asarray(d)
    kxp, kyp, kzv, inv = _jax_k(jeng, kz0, B)
    kv = (kxp, kyp, kzv)
    if mode == "hessian":
        want = [dj * f for f in jeng._facs_hessian(kxp, kyp, kzv,
                                                   jnp.float32(1.7))]
        got = derivatives.ooc_hessian(torch.from_numpy(d), kz0, 1.7, N)
    elif mode == "gradient":
        base = dj * (1j * (inv * jnp.float32(0.8)))
        want = [base * kc for kc in kv]
        got = derivatives.ooc_gradient(torch.from_numpy(d), kz0, 0.8, N)
    elif mode == "gradient_tab":
        gtab = (0.6 + 0.3 * np.sin(np.arange(512) / 40.0)).astype(np.float32)
        glo, gdx = np.float32(-3.0), np.float32(0.01)
        k2 = kxp * kxp + kyp * kyp + kzv * kzv
        logk = 0.5 * jnp.log10(jnp.maximum(k2, 1e-12))
        t = jnp.clip((logk - glo) / gdx, 0.0, gtab.shape[0] - 1.001)
        it = t.astype(jnp.int32)
        wt = t - it.astype(jnp.float32)
        jt = jnp.asarray(gtab)
        g = jt[it] * (1.0 - wt) + jt[it + 1] * wt
        base = dj * (1j * (inv * g))
        want = [base * kc for kc in kv]
        got = derivatives.ooc_gradient_tab(torch.from_numpy(d), kz0,
                                           torch.from_numpy(gtab), float(glo),
                                           float(gdx), N)
    else:
        d2 = np.conj(d[:, ::-1]).copy()
        want, got = [], []
        for a, b in derivatives.SECOND_DERIV_PAIRS:
            fac = jnp.broadcast_to(kv[a] * kv[b] * inv, (B, N, N))
            want += [dj * fac, jnp.asarray(d2) * fac]
            got.append(derivatives.ooc_pair(torch.from_numpy(d),
                                            torch.from_numpy(d2), kz0, a, b,
                                            N))
        got = torch.cat(got)
    want = np.stack([np.broadcast_to(np.asarray(w), (B, N, N)) for w in want])
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_hessian_stack_matches_jax(setup):
    """The half-transform stack of one radius against the JAX engine's
    (re, im) arrays [x, kz, y]; the imaginary parts of the kz=0 and kz=N/2
    planes, which the port zeroes and the z transform discards, are left
    out."""
    jp, jc, p, cosmo = setup
    jeng = JaxOocEngine(jp, jc, verbose=False)
    us = jeng.build_hessian(jeng.zeros_stack(6), jnp.float32(1.5))
    eng = fmax_ooc.OocEngine(p, cosmo, "cpu")
    stack = eng.build(eng.stack(6), lambda kz0, B: derivatives.ooc_hessian(
        eng.planes(kz0, B), kz0, 1.5, N)).numpy()
    for c in range(6):
        re = np.asarray(us[2 * c]).transpose(0, 2, 1)
        im = np.asarray(us[2 * c + 1]).transpose(0, 2, 1)
        scale = np.abs(re).max()
        assert np.abs(stack[c].real - re).max() <= 1e-5 * scale
        assert (np.abs(stack[c].imag[..., 1:N // 2] - im[..., 1:N // 2]).max()
                <= 1e-5 * scale)


def test_run_fmax_ooc_matches_jax(runs, setup):
    jres, ooc, _ = runs
    jp = setup[0]
    d = np.abs(ooc.products.Fmax.numpy() - np.asarray(jres.products.Fmax))
    assert (d > 0.01).mean() < 1e-3
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(ooc.smoothing.true_variance,
                               jres.smoothing.true_variance, rtol=1e-4)
    sp, jsp = ooc.host_products, jres.host_products
    assert sp.sorted_by == "F" and jsp.sorted_by == "ci"
    assert len(np.setxor1d(sp.ci, jsp.ci)) <= max(2, 1e-3 * len(jsp.ci))
    _, io, ij = np.intersect1d(sp.ci, jsp.ci, return_indices=True)
    assert sorted(sp.vel) == ["v1", "v2", "v31", "v32"]
    for k in sp.vel:
        np.testing.assert_allclose(sp.vel[k][io], np.asarray(jsp.vel[k])[ij],
                                   rtol=3e-3, atol=3e-3)
    assert int(np.sum(ooc.pdf_hist)) == N ** 3
    assert np.all(sp.F >= jp.Flast)


def test_ooc_matches_dense_on_the_plane_field(runs, setup):
    _, ooc, dense = runs
    p = setup[2]
    d = np.abs(ooc.products.Fmax.numpy() - dense.products.Fmax.numpy())
    assert (d > 0.01).mean() < 1e-3
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(ooc.smoothing.true_variance,
                               dense.smoothing.true_variance, rtol=1e-4)
    sp, dp = ooc.host_products, dense.host_products
    assert len(np.setxor1d(sp.ci, dp.ci)) <= max(2, 1e-3 * len(dp.ci))
    _, io, idn = np.intersect1d(sp.ci, dp.ci, return_indices=True)
    for k in sp.vel:
        np.testing.assert_allclose(sp.vel[k][io], dp.vel[k][idn],
                                   rtol=3e-3, atol=3e-3)
    # the same sweep order: descending F, ties by ascending cell
    F = ooc.products.Fmax.numpy().ravel()
    want = np.flatnonzero(F >= p.Flast)
    np.testing.assert_array_equal(sp.ci, want[np.lexsort((want, -F[want]))])
    np.testing.assert_array_equal(ooc.pdf_hist, dense.pdf_hist)


def test_ooc_fragmentation_matches_dense(runs, setup):
    _, ooc, dense = runs
    p, cosmo = setup[2], setup[3]
    fo = run_fragmentation(p, cosmo, ooc, verbose=False)
    fd = run_fragmentation(p, cosmo, dense, verbose=False)
    for a, b in zip(fd.catalogs, fo.catalogs):
        assert a.z == b.z
        assert abs(len(a.name) - len(b.name)) <= max(2, 0.01 * len(a.name))


def test_ooc_batches_do_not_change_the_result(runs, setup):
    """Other kz batches (a remainder batch of 3) and x-slabs give the same
    products: every plane and every slab is computed on its own."""
    _, ooc, _ = runs
    p, cosmo = setup[2], setup[3]
    other = fmax_ooc.run_fmax_ooc(
        dataclasses.replace(p, ooc_kz_batch=7, ooc_z_batch=8), cosmo, "cpu")
    np.testing.assert_array_equal(other.products.Fmax.numpy(),
                                  ooc.products.Fmax.numpy())
    np.testing.assert_array_equal(other.host_products.ci,
                                  ooc.host_products.ci)
    for k, v in ooc.host_products.vel.items():
        np.testing.assert_allclose(other.host_products.vel[k], v, rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_ooc_against_dense(tmp_path):
    """run_pipeline at 48^3 with ooc='on' (the planner's choice, the
    outputs written) against the dense run: halo counts per output within
    the JAX package's tolerance for two realizations of one cosmology
    (tests/test_ooc.py: max(10, 6 sqrt(n) + 5 % n))."""
    from pinocchio_tpu_torch.config import Params
    kw = bench_kwargs(48)
    res = run_pipeline(Params(**kw, ooc="on"), outdir=str(tmp_path),
                       device="cpu", verbose=False)
    std = run_pipeline(Params(**kw, ooc="off"), outdir=str(tmp_path),
                       device="cpu", verbose=False, write_outputs=False)
    assert res["plan"]["engine"] == "out-of-core"
    assert std["plan"]["engine"] == "dense"
    assert res["fmax"].products.Rmax is None
    for a, b in zip(res["frag"].catalogs, std["frag"].catalogs):
        n, n_std = len(a.name), len(b.name)
        assert n > 0
        assert abs(n - n_std) <= max(10, 6 * np.sqrt(n_std) + 0.05 * n_std)
    files = set(os.listdir(tmp_path))
    for name in ("FmaxPDF", "histories"):
        assert f"pinocchio.run.{name}.out" in files


@pytest.mark.parametrize("overrides,item", [
    (dict(ooc_dtype="bfloat16"), "item 11"),
    (dict(WriteTimelessSnapshot=True), "item 13"),
])
def test_unsupported_ooc_raises(overrides, item):
    from pinocchio_tpu_torch.config import Params
    p = Params(**bench_kwargs(16), ooc="on", **overrides)
    with pytest.raises(NotImplementedError, match=item):
        check_supported(p)
    with pytest.raises(NotImplementedError):
        fmax_ooc.run_fmax_ooc(p, None, "cpu")
