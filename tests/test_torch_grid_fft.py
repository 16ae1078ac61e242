"""The dense engine's 3-D transforms (grids.rfft3, irfft3, irfft3_).

On the CPU: every plan of grids.plan_geometry, executed by a numpy
emulation of cuFFT's advanced data layout (each batch's
elements gathered from base + call * step + batch * dist + the embedded
index * stride, transformed unnormalized, scattered the same way), reads
and writes every element of its tensors exactly once and, chained as the
card chains them, gives torch.fft's two-step transform; and K2, K5 and
K8's plain twins with their ``scale`` 1/N^3, followed by the
unnormalized two-step inverse, give the bits of the inverse normalized
after each transform (PyTorch's cuFFT path) at a power-of-two N (a
power-of-two factor commutes with every rounding).

On a card (marked ``cuda``, skipped without one; this file imports no
JAX), the port's plans against torch.fft's two-step transforms at N = 64,
128 and 512 for 1, 3 and 6 components (the inverse on a spectrum kz
outermost and on a contiguous one), within 1e-5 of the largest value: the
port's z transforms read or write z at stride N^2 where PyTorch's run
contiguous, so cuFFT may pick another kernel for them and the two round
differently, by a few float32 units at most (about 1e-7 of the largest
value a pass over three radix passes; at 512^3 the two agree bit for bit);
the non-consuming routes leave their input as it was; the device peak of
a 512^3 six-component inverse is the output and the plans' work area over
its spectrum; each transform counts one in grids.FFT_COUNTS["direct"];
K2, K5 and K8 with their scale equal their plain twins bit for bit; and a
dense run_fmax makes every transform on the plans; and K2, K5 and K8 run
under the kernel names by which the benchmark's roofline operations
(benchmark/roofline/kspace_*.json) find them.

    python -m pytest --noconftest -m cuda tests/test_torch_grid_fft.py -q
"""

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch import grids
from pinocchio_tpu_torch.grids import irfft3, irfft3_, irfft_z, rfft3
from pinocchio_tpu_torch.ops import derivatives

def _offsets(g, inp: bool, logical):
    """[calls, batch, *logical] element offsets of a plan's input or
    output (cuFFT's advanced layout)."""
    emb = g["inembed" if inp else "onembed"]
    stride = g["istride" if inp else "ostride"]
    dist = g["idist" if inp else "odist"]
    step = g["step_in" if inp else "step_out"]
    idx = np.indices(logical).reshape(len(logical), -1)
    flat = np.zeros(idx.shape[1], np.int64)
    for d in range(len(logical)):
        flat = flat * emb[d] + idx[d]
    base = (np.arange(g["calls"])[:, None] * step
            + np.arange(g["batch"])[None, :] * dist)
    return (base[..., None] + flat * stride).reshape(
        (g["calls"], g["batch"]) + tuple(logical))


def _emulate(kind, g, src, dst, direction=0):
    """Run plan g of ``kind`` ("c2c", "c2r", "r2c") on flat numpy arrays,
    as cuFFT does: unnormalized, dst written in place."""
    n = tuple(g["n"])
    half = n[:-1] + (n[-1] // 2 + 1,)
    ilog = half if kind == "c2r" else n
    olog = half if kind == "r2c" else n
    x = src[_offsets(g, True, ilog)]
    axes = tuple(range(2, 2 + len(n)))
    size = float(np.prod(n))
    if kind == "c2c":
        y = (np.fft.fftn(x, axes=axes) if direction == grids.FORWARD
             else np.fft.ifftn(x, axes=axes) * size)
    elif kind == "c2r":
        y = np.fft.irfftn(x, s=n, axes=axes) * size
    else:
        y = np.fft.rfftn(x, axes=axes)
    dst[_offsets(g, False, olog)] = y


def _kz_first(spec):
    """A [c, N, N, Nh] spectrum as the flat array of [c, Nh, N, N]."""
    return np.ascontiguousarray(spec.transpose(0, 3, 1, 2)).reshape(-1)


@pytest.mark.parametrize("N,c", [(8, 1), (8, 3), (6, 6), (16, 2)])
def test_each_plan_covers_its_tensors_once(N, c):
    g = grids.plan_geometry(N, c)
    Nh = N // 2 + 1
    spec, real = c * N * N * Nh, c * N ** 3
    for kind, gg in (("c2c", g["c2c"]), ("c2r", g["z"]),
                     ("r2c", grids.mirrored(g["z"]))):
        n = tuple(gg["n"])
        half = n[:-1] + (n[-1] // 2 + 1,)
        ilog = half if kind == "c2r" else n
        olog = half if kind == "r2c" else n
        sizes = dict(c2c=(spec, spec), c2r=(spec, real), r2c=(real, spec))
        for inp, logical, total in ((True, ilog, sizes[kind][0]),
                                    (False, olog, sizes[kind][1])):
            off = _offsets(gg, inp, logical).reshape(-1)
            assert np.array_equal(np.sort(off), np.arange(total)), (kind, inp)
    # the c2c and the z transform of one spectrum's 2-D planes
    assert g["c2c"]["n"] == (N, N) and g["z"]["n"] == (N,)


@pytest.mark.parametrize("N,c", [(8, 1), (8, 3), (16, 2), (6, 6)])
def test_the_plans_chained_give_the_two_step_transforms(N, c):
    rng = np.random.default_rng(N * 10 + c)
    Nh = N // 2 + 1
    g = grids.plan_geometry(N, c)
    spec = (rng.standard_normal((c, N, N, Nh))
            + 1j * rng.standard_normal((c, N, N, Nh)))
    # the inverse: c2c in place, the real planes' imaginary parts zeroed,
    # then the c2r; unnormalized, so 1/N^3 is taken here
    buf = _kz_first(spec)
    _emulate("c2c", g["c2c"], buf, buf, grids.INVERSE)
    view = buf.reshape((c, Nh, N, N))
    for pl in (view[:, 0], view[:, N // 2]):
        pl.imag = 0.0
    out = np.zeros(c * N ** 3)
    _emulate("c2r", g["z"], buf, out)
    want = irfft_z(torch.fft.ifft2(torch.from_numpy(spec), dim=(-3, -2)),
                   N).numpy()
    np.testing.assert_allclose(out.reshape(c, N, N, N) / N ** 3, want,
                               rtol=0, atol=1e-12 * np.abs(want).max())
    # the forward: r2c over z, then the c2c in place
    x = rng.standard_normal((c, N, N, N))
    got = np.zeros(c * N * N * Nh, complex)
    _emulate("r2c", grids.mirrored(g["z"]), x.reshape(-1).copy(), got)
    _emulate("c2c", g["c2c"], got, got, grids.FORWARD)
    want = torch.fft.fft2(torch.fft.rfft(torch.from_numpy(x), dim=-1),
                          dim=(-3, -2)).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_one_plan_serves_every_component_count(monkeypatch):
    made = []
    monkeypatch.setattr(grids, "_make_plan",
                        lambda ctype, g: made.append((ctype, g)) or
                        (len(made), 0))
    monkeypatch.setattr(grids, "PLANS", grids._Plans())
    for c in (1, 3, 6):
        g = grids.plan_geometry(16, c)
        assert grids.PLANS.get(0, grids.CUFFT_C2C, g["c2c"]) == (1, 0)
        assert grids.PLANS.get(0, grids.CUFFT_C2R, g["z"]) == (2, 0)
    # another card, type or size makes a plan of its own
    g = grids.plan_geometry(16, 1)
    assert grids.PLANS.get(1, grids.CUFFT_C2C, g["c2c"]) == (3, 0)
    assert grids.PLANS.get(0, grids.CUFFT_R2C, grids.mirrored(g["z"])) == (
        4, 0)
    assert grids.PLANS.get(0, grids.CUFFT_C2C,
                           grids.plan_geometry(32, 1)["c2c"]) == (5, 0)
    assert len(made) == 5


def _spectrum(N, seed=0):
    rng = np.random.default_rng(seed)
    Nh = N // 2 + 1
    k = (rng.standard_normal((N, N, Nh))
         + 1j * rng.standard_normal((N, N, Nh))).astype(np.complex64)
    return torch.from_numpy(k)


def _unnormalized(k, N, after=False):
    """The two-step inverse without its 1/N^3 (norm "forward" leaves the
    inverse unscaled), or with ``after`` the way PyTorch's cuFFT path
    normalizes: the unscaled 2-D transform times 1/N^2, the unscaled c2r
    times 1/N, each a multiply of its own (the CPU's own normalization
    happens inside its FFT library, in another order)."""
    u = torch.fft.ifft2(k, dim=(-3, -2), norm="forward")
    if after:
        u = torch.view_as_complex(torch.view_as_real(u) * (1.0 / N ** 2))
    grids._zero_real_planes(u, N)
    real = torch.fft.irfft(u, n=N, dim=-1, norm="forward")
    return real * (1.0 / N) if after else real


def _multipliers(N):
    gtab = torch.linspace(0.5, 1.5, 64, dtype=torch.float32)
    return {
        "K2 R=0": lambda k, s: derivatives.hessian_kspace(k, 0.0, N, s),
        "K2 R=1.5": lambda k, s: derivatives.hessian_kspace(k, 1.5, N, s),
        "K5": lambda k, s: derivatives.gradient_kspace(k, 0.73, N, s),
        "K8": lambda k, s: derivatives.gradient_kspace_tab(
            k, gtab, -2.5, 0.05, N, s)}


@pytest.mark.parametrize("N", [16, 32])
@pytest.mark.parametrize("name", ["K2 R=0", "K2 R=1.5", "K5", "K8"])
def test_the_folded_scale_gives_the_normalized_bits(N, name):
    """The plain twin with scale 1/N^3, then the unnormalized inverse,
    equals the unscaled twin, then the inverse normalized after each
    transform as PyTorch's cuFFT path does it, bit for bit; the scaled twin
    is the unscaled one's values times 1/N^3 exactly."""
    k = _spectrum(N)
    mult = _multipliers(N)[name]
    scale = 1.0 / N ** 3
    scaled, plain = mult(k, scale), mult(k, 1.0)
    assert torch.equal(torch.view_as_real(scaled),
                       torch.view_as_real(plain) * scale)
    assert torch.equal(_unnormalized(scaled, N),
                       _unnormalized(plain, N, after=True))


def test_scale_one_is_the_identity_signed_zeros_included():
    k = _spectrum(8)
    k[0, 0, 1] = complex(-0.0, -0.0)
    pairs = ((derivatives.hessian_kspace(k, 1.5, 8, 1.0),
              derivatives.hessian_kspace_shard_plain(k, 1.5, 8, 0, 0)),
             (derivatives.gradient_kspace(k, 0.73, 8, 1.0),
              derivatives.gradient_kspace_shard_plain(k, 0.73, 8, 0, 0)))
    for got, want in pairs + ((derivatives._scaled(k.clone(), 1.0), k),):
        assert torch.equal(torch.view_as_real(got).view(torch.int32),
                           torch.view_as_real(want).view(torch.int32))


def test_the_cpu_route_is_torch_fft_and_counted():
    N = 8
    k = _spectrum(N, 3)
    x = torch.randn((2, N, N, N), generator=torch.Generator().manual_seed(1))
    before = dict(grids.FFT_COUNTS)
    assert grids.irfft3_scale(k, N) == 1.0
    want = irfft_z(torch.fft.ifft2(k, dim=(-3, -2)), N)
    kept = k.clone()
    assert torch.equal(irfft3(k, N), want)
    assert torch.equal(k, kept)                       # left as it was
    assert torch.equal(irfft3_(k.clone(), N), want)
    spec = rfft3(x)
    assert torch.equal(spec, torch.fft.fft2(torch.fft.rfft(x, dim=-1),
                                            dim=(-3, -2)))
    assert spec.is_contiguous()
    assert grids.FFT_COUNTS == dict(direct=before["direct"],
                                    torch=before["torch"] + 3)


# ------------------------------------------------------------------
# on the card
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's cuFFT plans")
    return torch.device("cuda", 0)


def _card_spectrum(dev, c, N, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((c, N, N, N // 2 + 1), dtype=torch.complex64,
                       device=dev, generator=gen)


def _close(got, want):
    got, want = (torch.view_as_real(t) if t.is_complex() else t
                 for t in (got, want))
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 128, 512])
@pytest.mark.parametrize("c", [1, 3, 6])
def test_inverse_matches_torch_fft(dev, N, c):
    spec = _card_spectrum(dev, c, N, N + c)
    want = irfft_z(torch.fft.ifft2(spec, dim=(-3, -2)), N)
    scaled = torch.view_as_complex(torch.view_as_real(spec).mul(
        grids.irfft3_scale(spec, N)))
    # kz outermost, as K2, K5 and K8 write it (transformed where it lies),
    # and contiguous (copied into that layout first)
    kz_first = scaled.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    for k in (kz_first, scaled):
        got = irfft3_(k if c > 1 else k[0], N)
        _close(got.view(want.shape), want)
        del got
    del kz_first, scaled
    kept = spec.clone()
    _close(irfft3(spec, N), want)                   # the caller keeps spec
    assert torch.equal(torch.view_as_real(spec), torch.view_as_real(kept))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 128, 512])
@pytest.mark.parametrize("c", [1, 3, 6])
def test_forward_matches_torch_fft(dev, N, c):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7 * N + c)
    x = torch.randn((c, N, N, N), dtype=torch.float32, device=dev,
                    generator=gen)
    kept = x.clone()
    want = torch.fft.fft2(torch.fft.rfft(x, dim=-1), dim=(-3, -2))
    got = rfft3(x if c > 1 else x[0])
    assert got.is_contiguous()
    _close(got.view(want.shape), want)
    assert torch.equal(x, kept)


@pytest.mark.cuda
def test_the_inverse_peak_is_output_and_work_area(dev):
    N, c = 512, 6
    # kz outermost, as K2 writes it: no copy into that layout
    spec = _card_spectrum(dev, c, N, 1).permute(0, 3, 1, 2).contiguous()
    spec = spec.permute(0, 2, 3, 1)
    g = grids.plan_geometry(N, c)
    work = max(grids.PLANS.get(0, grids.CUFFT_C2C, g["c2c"])[1],
               grids.PLANS.get(0, grids.CUFFT_C2R, g["z"])[1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = irfft3_(spec, N)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    # the caching allocator rounds a block up to 512 bytes
    assert peak <= 4 * c * N ** 3 + -(-work // 512) * 512, (peak, work)
    del out, spec


@pytest.mark.cuda
def test_each_transform_counts_once(dev):
    N = 64
    spec = _card_spectrum(dev, 3, N, 2)
    before = dict(grids.FFT_COUNTS)
    real = irfft3(spec, N)
    irfft3_(spec, N)
    rfft3(real)
    rfft3(real[0])
    assert grids.FFT_COUNTS == dict(direct=before["direct"] + 4,
                                    torch=before["torch"])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [50, 64])
def test_the_scaled_multipliers_are_their_twins_bits(dev, N):
    # the plain twins on the card: its expf and log10f are the kernels'
    k = _spectrum(N, 5).to(dev)
    gtab = torch.linspace(0.5, 1.5, 64, dtype=torch.float32, device=dev)
    for scale in (1.0, 1.0 / N ** 3):
        pairs = (
            (derivatives.hessian_kspace(k, 1.5, N, scale),
             derivatives.hessian_kspace_plain(k, 1.5, N, scale)),
            (derivatives.gradient_kspace(k, 0.73, N, scale),
             derivatives.gradient_kspace_plain(k, 0.73, N, scale)),
            (derivatives.gradient_kspace_tab(k, gtab, -2.5, 0.05, N, scale),
             derivatives.gradient_kspace_tab_plain(k, gtab, -2.5, 0.05, N,
                                                   scale)))
        for got, want in pairs:
            assert torch.equal(torch.view_as_real(got).view(torch.int32),
                               torch.view_as_real(want).view(torch.int32))


@pytest.mark.cuda
def test_a_dense_run_makes_every_transform_on_the_plans(dev):
    from pinocchio_tpu_torch.config import Params
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fmax import run_fmax
    p = Params(GridSize=64, BoxSize=64.0, output_z=[0.0], norad=True,
               plc_enabled=False)
    res = run_fmax(p, Cosmology(p), dev)
    res.pending_fetch.join()
    # every radius's Hessian, phi2's, three sources forward, four fields
    assert res.timings["fft_direct"] == res.smoothing.n + 1 + 3 + 4
    assert res.timings["fft_torch"] == 0


@pytest.mark.cuda
def test_the_rooflines_find_k2_k5_and_k8(dev):
    """Each of K2, K5 and K8 runs under a kernel name that its roofline
    operation's patterns match, and that no other operation's do."""
    import json
    import re
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile
    root = Path(__file__).resolve().parents[1] / "benchmark" / "roofline"
    pats = {f.stem: [re.compile(p) for p in json.loads(f.read_text())[
        "kernels"]] for f in root.glob("*.json")}
    N = 64
    k = _spectrum(N, 5).to(dev)
    mult = _multipliers(N)
    gtab = torch.linspace(0.5, 1.5, 64, dtype=torch.float32, device=dev)
    runs = {"kspace_hessian": lambda: mult["K2 R=1.5"](k, 1.0 / N ** 3),
            "kspace_gradient": lambda: mult["K5"](k, 1.0 / N ** 3),
            "kspace_gradient_tab": lambda: derivatives.gradient_kspace_tab(
                k, gtab, -2.5, 0.05, N, 1.0 / N ** 3)}
    for op, run in runs.items():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        found = {o for o, ps in pats.items()
                 if any(p.search(n) for p in ps for n in names)}
        assert found == {op}, (op, found, names)
