"""The hand-written kernels on a CUDA device against their plain PyTorch
versions, at sizes whose last block is ragged.

The kernels have no CPU mode, so the tests marked ``cuda`` skip without a
card.  This file imports no JAX: on a GPU machine it runs without the JAX
package's test configuration,

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

N = 50 leaves every kernel's last block partly empty (50 * 50 * 26 modes
is not a multiple of the 256-thread CUDA blocks).  Tolerances are
chip_smoke.py's: K1 within 1e-5 of max|delta| with identical draws, K2/K5
within 1e-6 of the maximum, K3 |dF| <= 1e-4 max(1, |F|) on 99.99 % of
cells with Rmax equal on 99.9 %; K4 (the sources, the six pairs and one
pair) is bit for bit its plain version, also on odd cell counts and
copies 4 bytes off the 16-byte grid.  On the Hessians that reach K3's rare
branches (tests/torch_hessians.py) F and Rmax must be exactly equal, and
K3 through its bulk-copy ring and with direct loads gives the same bits.  K7
(the three table lookups) is exactly equal to its plain version on those
batches and on cells far beyond the table, and within the K3 criteria on
Gaussian Hessians; K8 (tabulated growth), K6a (the row rank and the row
scatter, on some, every and no needed cell) and K6b (the FmaxPDF
histogram) are exactly equal.  The out-of-core engine's kernels:
K9 (kz planes), K10 (the three factor modes in their rows and kz-fastest
forms, on contiguous planes and a spectrum's window, bit for bit, on the
kz schedule's first and last batch and one over two kz tiles), K11 (K3 on
a slab, no Rmax) and K12 (the slab row scatter) are exactly equal to their
plain versions; K4's one-pair accumulation, pair by pair, gives the
six-pair pass's bits.  K13 (K7 on a slab, no Rmax; three lookups) is
exactly equal to its plain version and to K7 on the rare-branch batches and
on Gaussian Hessians; K14 (the gradient mode with a growth table, in its
contiguous and kz-fastest forms, on the first, a middle and the last batch
of the kz schedule at N = 50, 256 and 512, the last one plane) is exactly
equal to its plain version and to K8's values at the same modes, and
refuses any other layout.  The shard kernels K1s, K2s, K5s and K8s
on a mesh shard's window are exactly equal to their plain versions and to
the full-grid kernels on that window; the fmax phase over a 2x2 pencil
mesh of the one card launches the mesh's kernels and holds the
single-device run's results, and the out-of-core engine over 3 shards of
the card equals the single-device engine exactly; the hand-off's products
read through its views before the join equal a joined run's bit for bit
on both engines, and its copies land their source's values when the
source is freed and its memory reused before they run; the dense one's
bytes to the host at 256^3 are the sort's int64 cell indices, F, the
tables and the counts, its cell indices the needed cells of its Fmax in
(-F, cell) order, and its entry returns before the last table lands.  The exchange's kernels
K15 (count, with boxes and with request maps), K16 (pack) and K17 (sphere
paint, from its plan) are
exactly equal to their plain versions on the (1, 1) shard of a 2x2 pencil
layout, with 16 hosts, wrapped boxes, a box wider than the grid, a host
with no box, and spheres across the shard's edge and the periodic wrap;
K15 also with 1, 2, 16 and 33 hosts on one row, ragged row counts, every
cell of the shard and cells off the 16-byte grid, boxes from x0 = N - 1,
a host of 40 boxes (two words of masks) and 50 hosts over the 512^3 shard
(the boxes tested in turn);
K16 also with 1, 3 and 33 hosts, rows that are members of every host, 4
and 8 row channels;
K17 also on adversarial spheres (2r = N, 2r > N, r >= N, fractional and
negative radii, spheres outside the shard) on that shard, a slab and an
odd window.
K18 and K19 (the out-of-core engine's 16-bit stores and loads) equal their
plain versions bit for bit in bfloat16 and float16 at N = 50 and 64, in
every form and alignment the kernels distinguish.
K1 is also held bit for bit (an int32 view of both parts, so a signed
zero equals only itself) at 32^3, 48^3 and 96^3 with and without FixedIC
and PairedIC; K1s on windows with odd y0 and ny and with padded planes;
K9 on batches from kz = 0, across kz = N/2 and up to Nh, from a generator
and from the public wrapper; the kernels' phase, sincosf and dead-mode
signs on every phase the generator can draw; K6b on adversarial F (one bin
for every cell, NaN, +-inf, -0.0, 1e30, the bin edges, 20.9-21.0, lengths
4k + 1..3, views off the 16-byte grid).
"""

import functools

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch import fmax, fmax_ooc, handoff, ic, kernels
from pinocchio_tpu_torch.grids import Grid, rfft3
from pinocchio_tpu_torch.ops import collapse, compact, derivatives, lpt
from pinocchio_tpu_torch.ops import exchange as xops
from pinocchio_tpu_torch.ops import storage, tabulated
from torch_hessians import SPECIAL, special_hessians
from torch_hist_cases import adversarial_F

torch.set_num_threads(2)

N = 50


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup():
    p = Params(GridSize=N, BoxSize=float(N), output_z=[0.0], norad=True,
               plc_enabled=False)
    return p, Cosmology(p)


def _hessians(dev, seed=0):
    rng = np.random.default_rng(seed)
    sd = rng.standard_normal((6, N, N, N)) * np.array(
        [1.0, 1.0, 1.0, 0.5, 0.5, 0.5])[:, None, None, None]
    return torch.from_numpy(sd.astype(np.float32)).to(dev)


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fixed,paired", [(False, False), (True, False),
                                          (False, True)])
def test_ic_kdensity(dev, setup, fixed, paired):
    p, cosmo = setup
    grid = Grid(N, p.BoxSize_htrue)
    logk, logpk = (torch.from_numpy(t).to(dev)
                   for t in ic.pk_table(cosmo, grid))
    kp, ka = ic.split(ic.prng_key(p.RandomSeed))
    args = (N, logk, logpk, kp, ka, float(np.float32(-0.9)),
            float(np.float32(N ** 1.5)), fixed, paired)
    got = _launched("ic_kdensity", lambda: ic.kdensity(*args))
    want = ic.kdensity_plain(*args)
    assert got.shape == (N, N, N // 2 + 1) and got.dtype == torch.complex64
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _same_bits(a, b):
    """The same float32 bits (complex64 part by part), so a signed zero
    equals only itself (torch.equal takes -0.0 for +0.0)."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@functools.lru_cache(maxsize=None)
def _ic_host_args(n):
    """K1's host inputs at n^3 (kdensity_args of the bench shape)."""
    p = Params(GridSize=n, BoxSize=float(n), output_z=[0.0], norad=True,
               plc_enabled=False)
    return ic.kdensity_args(Grid(n, p.BoxSize_htrue), Cosmology(p),
                            p.RandomSeed)


def _ic_args(n, dev):
    """K1's inputs at n^3: the P(k) tables on dev, the keys, log10 kf and
    the amplitude factor."""
    args = _ic_host_args(n)
    return (tuple(torch.from_numpy(t).to(dev) for t in args[:2])
            + tuple(args[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 48, 96])
@pytest.mark.parametrize("fixed,paired", [(False, False), (True, False),
                                          (False, True)])
def test_ic_kdensity_bit_for_bit(dev, n, fixed, paired):
    """K1 bit for bit its plain version, the signed zeros of the dead modes
    included; Nh = 17, 25, 49 is odd, so rows of kz straddle warps."""
    args = (n,) + _ic_args(n, dev) + (fixed, paired)
    got = _launched("ic_kdensity", lambda: ic.kdensity(*args))
    want = ic.kdensity_plain(*args)
    assert _same_bits(got, want)
    assert int((want == 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("window,paired", [
    ((1, 7, 20, 10), False), ((1, 7, 20, 10), True), ((0, N, 0, 26), False),
    ((49, 1, 25, 3), False), ((13, 31, 0, 33), True), ((25, 25, 13, 13),
                                                       False)])
def test_kdensity_shard_bit_for_bit(dev, window, paired):
    """K1s bit for bit its plain version on windows with odd y0 and ny and
    with padded planes iz >= Nh (written as +0)."""
    args = (N,) + _ic_args(N, dev) + (False, paired) + window
    got = _launched("ic_kdensity_shard", lambda: ic.kdensity_shard(*args))
    assert _same_bits(got, ic.kdensity_shard_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("fixed,paired", [(False, False), (True, False),
                                          (False, True)])
def test_kdensity_planes_bit_for_bit(dev, setup, fixed, paired):
    """K9 bit for bit its plain version, from the generator (its P(k)
    table built on the first batch and kept) and from the public wrapper
    (the table built in each call): batches that start at kz = 0, cross
    kz = N/2, end at Nh, and the whole half grid."""
    p, cosmo = setup
    gen = ic.PlaneGenerator(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed,
                            dev, fixed=fixed, paired=paired)
    Nh = N // 2 + 1
    for kz0, B in ((0, 5), (20, 6), (10, 16), (0, Nh)):
        args = (N, gen.logk, gen.logpk, gen.keys, kz0, B, gen.logkf,
                gen.fac, fixed, paired)
        want = ic.kdensity_planes_plain(*args)
        assert _same_bits(_launched("ic_kdensity_planes",
                                    lambda: gen(kz0, B)), want)
        assert _same_bits(_launched("ic_kdensity_planes",
                                    lambda: ic.kdensity_planes(*args)), want)


@pytest.mark.cuda
def test_ic_phase_proof(dev):
    """Every phase the generator can draw: the kernel's phase, sincosf and
    dead-mode signs equal the plain version's phase, sin and cos."""
    assert ic.phase_check(dev) == (0, 0, 0)


@pytest.mark.cuda
def test_pdf_hist_adversarial(dev):
    """K6b equal to its plain version on adversarial F
    (tests/torch_hist_cases.py): one bin for every cell, NaN, +-inf, -0.0,
    1e30, every bin edge and its neighbours, 20.9 to 21.0, lengths
    4k + 1..3, views 1-3 elements past a 16-byte boundary."""
    for name, F in adversarial_F(dev).items():
        got = _launched("pdf_hist", lambda: compact.pdf_hist(F))
        assert torch.equal(got, compact.pdf_hist_plain(F)), name
        assert int(got.sum()) == F.numel(), name


@pytest.mark.cuda
@pytest.mark.parametrize("R", [2.5, 0.0])
def test_kspace_hessian(dev, R):
    delta = rfft3(_hessians(dev)[0])
    got = _launched("kspace_hessian",
                    lambda: derivatives.hessian_kspace(delta, R, N))
    want = derivatives.hessian_kspace_plain(delta, R, N)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.cuda
def test_kspace_gradient(dev):
    src = rfft3(_hessians(dev)[1])
    got = _launched("kspace_gradient",
                    lambda: derivatives.gradient_kspace(src, 0.7, N))
    want = derivatives.gradient_kspace_plain(src, 0.7, N)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.cuda
def test_collapse_update(dev, setup):
    p, cosmo = setup
    pack = fmax.inverse_growth_packs(cosmo, fmax.Smoothing.build(p, cosmo))[0]
    sd = _hessians(dev)
    rng = np.random.default_rng(1)
    F0 = torch.from_numpy(rng.uniform(-10.0, 4.0, (N, N, N))
                          .astype(np.float32)).to(dev)
    R0 = torch.from_numpy(rng.integers(-1, 5, (N, N, N))
                          .astype(np.int32)).to(dev)
    Fk, Rk = F0.clone(), R0.clone()
    mk = _launched("collapse_update",
                   lambda: collapse.collapse_update(sd, Fk, Rk, 7, pack))
    Fp, Rp = F0.clone(), R0.clone()
    mp = collapse.collapse_update_plain(sd, Fp, Rp, 7, pack)
    ok = (Fk - Fp).abs() <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)
    assert ok.double().mean() >= 0.9999
    assert (Rk == Rp).double().mean() >= 0.999
    assert abs(mk[1].item() / mp[1].item() - 1.0) <= 1e-5
    assert abs(mk[0].item() - mp[0].item()) <= 1e-6
    # a second call reuses the cached reduction scratch and returns a
    # tensor of its own; a stack off the 16-byte grid gives the same
    F2, R2 = F0.clone(), R0.clone()
    m2 = collapse.collapse_update(sd, F2, R2, 7, pack)
    assert torch.equal(F2, Fk) and torch.equal(R2, Rk)
    assert torch.equal(m2, mk) and m2.data_ptr() != mk.data_ptr()
    F3, R3 = F0.clone(), R0.clone()
    m3 = collapse.collapse_update(_misaligned(sd), F3, R3, 7, pack)
    assert torch.equal(F3, Fk) and torch.equal(R3, Rk)
    assert torch.equal(m3, mk)


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary, which the collapse kernels load directly."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
def test_collapse_update_ring_and_direct_loads(dev, setup):
    """On a grid where every block streams 16 tiles or more, K3 takes the
    bulk-copy ring; the same stack off the 16-byte grid takes direct
    loads.  Both give the same F, Rmax and means bit for bit, and meet the
    K3 criteria against the plain version."""
    p, cosmo = setup
    pack = fmax.inverse_growth_packs(cosmo, fmax.Smoothing.build(p, cosmo))[0]
    per_sm = min(collapse.kernel_info(None, True)[3],
                 collapse.kernel_info(None, False)[3])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 512-cell tiles, 16 a block on the resident grid
    sd = _hessians(dev).reshape(6, -1).repeat(
        1, -(-16 * per_sm * sms * 512 // N ** 3))
    n = sd.shape[1]
    assert -(-n // 512) >= 16 * min(per_sm * sms, -(-n // 512))
    rng = np.random.default_rng(2)
    F0 = torch.from_numpy(rng.uniform(-10.0, 4.0, n)
                          .astype(np.float32)).to(dev)
    R0 = torch.from_numpy(rng.integers(-1, 5, n).astype(np.int32)).to(dev)
    Fk, Rk = F0.clone(), R0.clone()
    mk = _launched("collapse_update",
                   lambda: collapse.collapse_update(sd, Fk, Rk, 7, pack))
    Fd, Rd = F0.clone(), R0.clone()
    md = collapse.collapse_update(_misaligned(sd), Fd, Rd, 7, pack)
    assert torch.equal(Fd, Fk) and torch.equal(Rd, Rk)
    assert torch.equal(md, mk)
    Fp, Rp = F0.clone(), R0.clone()
    mp = collapse.collapse_update_plain(sd, Fp, Rp, 7, pack)
    ok = (Fk - Fp).abs() <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)
    assert ok.double().mean() >= 0.9999
    assert (Rk == Rp).double().mean() >= 0.999
    assert abs(mk[1].item() / mp[1].item() - 1.0) <= 1e-5


def _mismatch(got, want):
    bad = got != want
    return (f"{int(bad.sum())} of {bad.numel()} cells differ, max |diff| "
            f"{(got.double() - want.double()).abs().max().item():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", SPECIAL)
def test_collapse_update_special_cells(dev, setup, batch):
    """The kernel's branches for the select lattice of the JAX function,
    on the Hessians that reach them: the isotropic (q == 0), degenerate,
    near-isotropic (the fail branch) and vanishing batches.  F, the fail
    branch and Rmax equal the plain version's exactly."""
    _, cosmo = setup
    pack = collapse.make_inverse_growth_fit(cosmo)
    sd = torch.from_numpy(special_hessians(np.random.default_rng(5))[batch]
                          .astype(np.float32)).to(dev)
    m = sd.shape[1]
    # below every F (F >= -10): each cell takes this radius' F
    Fk = torch.full((m,), -20.0, device=dev)
    Rk = torch.full((m,), -1, dtype=torch.int32, device=dev)
    Fp, Rp = Fk.clone(), Rk.clone()
    _launched("collapse_update",
              lambda: collapse.collapse_update(sd, Fk, Rk, 5, pack))
    collapse.collapse_update_plain(sd, Fp, Rp, 5, pack)
    assert torch.equal(Fk, Fp), _mismatch(Fk, Fp)
    assert torch.equal(Fk == -10.0, collapse.eigenvalues_descending(sd)[3])
    # running max from states that tie with the fail and never-collapse
    # values (-10 and 0): strict, so a tie keeps Rmax
    rng = np.random.default_rng(6)
    F0 = torch.from_numpy(rng.choice([-10.0, 0.0, 1.0, 3.0], m)
                          .astype(np.float32)).to(dev)
    R0 = torch.from_numpy(rng.integers(-1, 5, m).astype(np.int32)).to(dev)
    Fk, Rk, Fp, Rp = F0.clone(), R0.clone(), F0.clone(), R0.clone()
    collapse.collapse_update(sd, Fk, Rk, 7, pack)
    collapse.collapse_update_plain(sd, Fp, Rp, 7, pack)
    assert torch.equal(Fk, Fp), _mismatch(Fk, Fp)
    assert torch.equal(Rk, Rp), _mismatch(Rk, Rp)


@pytest.mark.cuda
def test_collapse_update_tie_keeps_earlier_radius(dev, setup):
    p, cosmo = setup
    pack = collapse.make_inverse_growth_fit(cosmo)
    sd = _hessians(dev, seed=2)
    Fmax = torch.full((N, N, N), -10.0, device=dev)
    Rmax = torch.full((N, N, N), -1, dtype=torch.int32, device=dev)
    collapse.collapse_update(sd, Fmax, Rmax, 3, pack)
    F1, R1 = Fmax.clone(), Rmax.clone()
    assert bool((R1 == 3).any())
    collapse.collapse_update(sd, Fmax, Rmax, 9, pack)
    assert torch.equal(Fmax, F1) and torch.equal(Rmax, R1)


@pytest.mark.cuda
def test_lpt_passes(dev):
    sd = _hessians(dev)
    got = _launched("lpt_sources_pointwise",
                    lambda: lpt.sources_pointwise(sd))
    want = lpt.sources_pointwise_plain(sd)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    phi2 = _hessians(dev, seed=3)
    want = lpt.src32_accumulate_plain(phi2, sd, want[2])
    got = _launched("lpt_src32_accumulate",
                    lambda: lpt.src32_accumulate(phi2, sd, got[2].clone()))
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4099, 16 * 50 * 50])
@pytest.mark.parametrize("shift", [0, 4])
def test_lpt_forms_bit_for_bit(dev, n, shift):
    """Every K4 form bit for bit its plain version on n cells a component
    (odd counts put a stack's components at different offsets from the
    16-byte grid; 16 x 50^2 is the fold's slab at N = 50), with every
    tensor a copy 0 or 4 bytes past a 16-byte boundary: the sources, the
    six pairs, and one pair with each weight and a weight that is not a
    power of two."""
    gen = torch.Generator(device=dev).manual_seed(n + shift)
    sd = _shifted(torch.randn((6, n), generator=gen, device=dev) * 10, shift)
    phi2 = _shifted(torch.randn((6, n), generator=gen, device=dev), shift)
    got = _launched("lpt_sources_pointwise",
                    lambda: lpt.sources_pointwise(sd))
    want = lpt.sources_pointwise_plain(sd)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    src = _shifted(want[2], shift)
    _launched("lpt_src32_accumulate",
              lambda: lpt.src32_accumulate(phi2, sd, src))
    assert _same_bits(src, lpt.src32_accumulate_plain(phi2, sd, want[2]))
    for c, w in ((0, 1.0), (4, 2.0), (5, 0.3)):
        p1, s1 = _shifted(phi2[c:c + 1], shift), _shifted(sd[c:c + 1], shift)
        acc = _shifted(want[2], shift)
        _launched("lpt_src32_accumulate", lambda: lpt.src32_accumulate(
            p1, s1, acc, weights=(w,)))
        assert _same_bits(acc, lpt.src32_accumulate_plain(p1, s1, want[2],
                                                          (w,)))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev, setup):
    _, cosmo = setup
    pack = collapse.make_inverse_growth_fit(cosmo)
    sd = _hessians(dev)
    Fmax = torch.zeros((N, N, N), device=dev)
    Rmax = torch.zeros((N, N, N), dtype=torch.int32, device=dev)
    delta = rfft3(sd[0])
    with pytest.raises(ValueError, match="contiguous"):
        derivatives.hessian_kspace(delta.transpose(0, 1), 1.0, N)
    with pytest.raises(ValueError, match="complex64"):
        derivatives.gradient_kspace(delta.to(torch.complex128), 1.0, N)
    with pytest.raises(ValueError, match="one CUDA device"):
        collapse.collapse_update(sd, Fmax.cpu(), Rmax, 0, pack)
    with pytest.raises(ValueError, match="Rmax i32"):
        collapse.collapse_update(sd, Fmax, Rmax.long(), 0, pack)
    with pytest.raises(ValueError, match="float32"):
        lpt.sources_pointwise(sd.double())


@pytest.fixture(scope="module")
def tables(setup):
    """The port's classic CT tables of two radii, on the card."""
    p, cosmo = setup
    sm = fmax.Smoothing.build(p, cosmo)
    keep = [sm.n // 2, sm.n - 1]
    sm.radii, sm.variance = sm.radii[keep], sm.variance[keep]
    ct = tabulated.build_ct_tables_all(cosmo, sm)
    return ct["ampl"], fmax.load_jax_state(
        {k: ct[k] for k in ("tables", "tables2", "dv", "idx_map")},
        torch.device("cuda", 0))


def _table_pair(tables, interp, sd, F0, R0, ism=0, rstep=3):
    """K7 and its plain version from the same state; returns both."""
    ampl, t = tables
    args = (t["tables"][ism], t["tables2"][ism], t["dv"], t["idx_map"],
            float(ampl[ism]), interp)
    Fk, Rk, Fp, Rp = F0.clone(), R0.clone(), F0.clone(), R0.clone()
    mk = _launched(f"collapse_update_table_{interp}",
                   lambda: collapse.collapse_update_table(sd, Fk, Rk, rstep,
                                                          *args))
    mp = collapse.collapse_update_table_plain(sd, Fp, Rp, rstep, *args)
    return (Fk, Rk, mk), (Fp, Rp, mp)


@pytest.mark.cuda
@pytest.mark.parametrize("interp", tabulated.INTERP)
def test_collapse_update_table(dev, tables, interp):
    sd = _hessians(dev)
    rng = np.random.default_rng(1)
    F0 = torch.from_numpy(rng.uniform(-10.0, 4.0, (N, N, N))
                          .astype(np.float32)).to(dev)
    R0 = torch.from_numpy(rng.integers(-1, 5, (N, N, N))
                          .astype(np.int32)).to(dev)
    (Fk, Rk, mk), (Fp, Rp, mp) = _table_pair(tables, interp, sd, F0, R0)
    ok = (Fk - Fp).abs() <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)
    assert ok.all()
    assert (Fk == Fp).double().mean() >= 0.9999
    assert (Rk == Rp).double().mean() >= 0.9999
    assert abs(mk[1].item() / mp[1].item() - 1.0) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("interp", tabulated.INTERP)
def test_collapse_update_table_special_and_far_cells(dev, tables, interp):
    """Exactly equal on the rare-branch batches and on Hessians far
    beyond the table in delta, x and y (every index clamped, the edge
    patches of the bicubic variant, extrapolation)."""
    rng = np.random.default_rng(8)
    special = special_hessians(rng)
    far = rng.standard_normal((6, 4096)) * np.array(
        [30.0, 30.0, 30.0, 20.0, 20.0, 20.0])[:, None]
    edge = rng.standard_normal((6, 4096)) * np.array(
        [3.0, 3.0, 3.0, 0.2, 0.2, 0.2])[:, None]
    batches = [special[k] for k in SPECIAL] + [far, edge]
    sd = torch.from_numpy(np.concatenate(batches, axis=1)
                          .astype(np.float32)).to(dev)
    m = sd.shape[1]
    for F0 in (torch.full((m,), -20.0, device=dev), torch.from_numpy(
            rng.choice([-10.0, 0.0, 1.0, 3.0], m).astype(np.float32))
            .to(dev)):
        R0 = torch.full((m,), -1, dtype=torch.int32, device=dev)
        for ism in (0, 1):
            (Fk, Rk, _), (Fp, Rp, _) = _table_pair(tables, interp, sd, F0,
                                                   R0, ism=ism)
            assert torch.equal(Fk, Fp), _mismatch(Fk, Fp)
            assert torch.equal(Rk, Rp), _mismatch(Rk, Rp)


@pytest.mark.cuda
def test_kspace_gradient_tab(dev):
    # f(R) gravity: the growth tables vary with k
    p = Params(GridSize=N, BoxSize=float(N), output_z=[0.0], norad=True,
               plc_enabled=False, mod_grav_fr=True, fr0=1e-5,
               scale_dependent=True)
    src = rfft3(_hessians(dev)[1])
    gtabs, glo, gdx = fmax.growth_k_tables(Cosmology(p), 0.5, N, dev)
    for order in range(4):
        got = _launched("kspace_gradient_tab",
                        lambda: derivatives.gradient_kspace_tab(
                            src, gtabs[order], glo, gdx, N))
        want = derivatives.gradient_kspace_tab_plain(src, gtabs[order], glo,
                                                     gdx, N)
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))


@pytest.mark.cuda
@pytest.mark.parametrize("flast", [1.0, -np.inf, np.nan],
                         ids=["some", "every", "none"])
def test_gather_rows_and_pdf_hist(dev, flast):
    """K6a (the rank kernel, then the scatter by quads, or by cells on a
    ragged grid) exactly equal to its plain version: with and without F,
    1, 4 and 8 stacks, a rank built by the wrapper or passed in, some,
    every or no cell needed; K6b's counts exactly."""
    rng = np.random.default_rng(9)
    F = torch.from_numpy(rng.choice(
        np.arange(-10.0, 30.0, 0.1, dtype=np.float32), (N, N, N))).to(dev)
    F.view(-1)[:4] = torch.tensor([0.0, 20.95, 1e6, float("inf")])
    stacks = [_hessians(dev, seed=s)[:3].contiguous() for s in range(8)]
    idx = compact.needed_order(F, flast)
    count = idx.numel()
    # F >= nan holds for no cell
    assert (0 < count < N ** 3 if flast == 1.0
            else count == (N ** 3 if flast < 0 else 0))
    rank = _launched("needed_rank", lambda: compact.needed_rank(idx, N ** 3))
    assert torch.equal(rank, compact.needed_rank_plain(idx, N ** 3))
    for with_F in (True, False):
        for ns in (1, 4, 8):
            size = compact.packed_size(count, ns, with_F)
            got = torch.full((size,), float("nan"), device=dev)
            again = torch.full((size,), float("nan"), device=dev)
            want = torch.empty(size, device=dev)
            Fa = F if with_F else None
            _launched("gather_rows", lambda: compact.gather_rows(
                idx, stacks[:ns], got, F=Fa))
            _launched("gather_rows", lambda: compact.gather_rows(
                idx, stacks[:ns], again, F=Fa, rank=rank))
            compact.gather_rows_plain(idx, stacks[:ns], want, F=Fa)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert torch.equal(again.view(torch.int32),
                               want.view(torch.int32))
    # a grid of 7^3 cells takes the scatter by cells
    small = F[:7, :7, :7].contiguous()
    sidx = compact.needed_order(small, flast)
    sst = [s[:, :7, :7, :7].contiguous() for s in stacks[:2]]
    size = compact.packed_size(sidx.numel(), 2, True)
    got, want = torch.empty(size, device=dev), torch.empty(size, device=dev)
    compact.gather_rows(sidx, sst, got, F=small)
    compact.gather_rows_plain(sidx, sst, want, F=small)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    got = _launched("pdf_hist", lambda: compact.pdf_hist(F))
    assert torch.equal(got, compact.pdf_hist_plain(F))
    assert int(got.sum()) == N ** 3


@pytest.mark.cuda
def test_kdensity_planes(dev, setup):
    """K9 is identical to its plain version, on a full batch, the remainder
    batch and the kz=0 plane with its Hermitian mirror."""
    p, cosmo = setup
    gen = ic.PlaneGenerator(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed,
                            dev)
    for kz0, B in ((0, 16), (16, 10)):
        got = _launched("ic_kdensity_planes", lambda: gen(kz0, B))
        want = ic.kdensity_planes_plain(N, gen.logk, gen.logpk, gen.keys,
                                        kz0, B, gen.logkf, gen.fac, False,
                                        False)
        assert got.shape == (B, N, N) and got.dtype == torch.complex64
        assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["hessian", "gradient", "pair"])
def test_ooc_factors(dev, mode):
    """K10 in its forms, bit for bit its plain version: on a resident
    spectrum's window (the kz-fastest form) and on a contiguous copy of its
    planes (the rows form); the pair mode on (planes, window) and (planes,
    planes); the Hessian mode, which only reads K9's planes, on planes (a
    window raises).  At N = 50 the tiles of 64 iy are partly outside; the
    batches are the kz schedule's first (16 planes) and last (10, not a
    multiple of 16, up to kz = N/2) and planes 3..22 (20, over two kz
    tiles, the second partial).  A layout that no form takes raises."""
    spec = rfft3(_hessians(dev)[0])
    sched = fmax_ooc.kz_schedule(N // 2 + 1, fmax_ooc.KZ_BATCH)
    assert sched[-1] == (16, 10)
    name = f"ooc_factors_{mode}"
    for kz0, B in (sched[0], sched[-1], (3, 20)):
        view = spec[:, :, kz0:kz0 + B].permute(2, 0, 1)
        planes = view.contiguous()
        if mode == "hessian":
            fns = [lambda f, s, R=R: f(s, kz0, R, N) for R in (1.7, 0.0)]
            kern, plain = (derivatives.ooc_hessian,
                           derivatives.ooc_hessian_plain)
        elif mode == "gradient":
            fns = [lambda f, s: f(s, kz0, 0.8, N)]
            kern, plain = (derivatives.ooc_gradient,
                           derivatives.ooc_gradient_plain)
        else:
            fns = [lambda f, s, a=a, b=b: f(planes, s, kz0, a, b, N)
                   for a, b in derivatives.SECOND_DERIV_PAIRS]
            kern, plain = derivatives.ooc_pair, derivatives.ooc_pair_plain
        for fn in fns:
            for src in (planes,) if mode == "hessian" else (planes, view):
                got = _launched(name, lambda: fn(kern, src))
                want = fn(plain, src)
                assert got.is_contiguous()
                assert _same_bits(got, want)
    bad = planes.transpose(1, 2)
    with pytest.raises(ValueError, match="its iy axis" if mode == "hessian"
                       else "iy or its kz axis"):
        fns[0](kern, bad)
    if mode == "hessian":
        with pytest.raises(ValueError, match="its iy axis"):
            fns[0](kern, view)
    if mode == "pair":
        with pytest.raises(ValueError, match="first source batch"):
            kern(view, view, kz0, 0, 1, N)


@pytest.mark.cuda
def test_collapse_update_slab(dev, setup):
    """K11 on one x-slab is K3 without Rmax: the same F cell for cell."""
    p, cosmo = setup
    pack = fmax.inverse_growth_packs(cosmo, fmax.Smoothing.build(p, cosmo))[0]
    sd = _hessians(dev)[:, 10:20].contiguous()
    rng = np.random.default_rng(1)
    F0 = torch.from_numpy(rng.uniform(-10.0, 4.0, (10, N, N))
                          .astype(np.float32)).to(dev)
    Fk, Fp, F3 = F0.clone(), F0.clone(), F0.clone()
    mk = _launched("collapse_update_slab",
                   lambda: collapse.collapse_update_slab(sd, Fk, pack))
    mp = collapse.collapse_update_slab_plain(sd, Fp, pack)
    R3 = torch.zeros_like(F0, dtype=torch.int32)
    collapse.collapse_update(sd, F3, R3, 1, pack)
    assert torch.equal(Fk, F3)
    ok = (Fk - Fp).abs() <= 1e-4 * torch.clamp(Fp.abs(), min=1.0)
    assert ok.double().mean() >= 0.9999
    assert abs(mk[1].item() / mp[1].item() - 1.0) <= 1e-5
    # a second call on the cached scratch gives the same statistics, and a
    # slab off the 16-byte grid the same F
    F2 = F0.clone()
    assert torch.equal(collapse.collapse_update_slab(sd, F2, pack), mk)
    assert torch.equal(F2, Fk)
    F2 = F0.clone()
    assert torch.equal(collapse.collapse_update_slab(_misaligned(sd), F2,
                                                     pack), mk)
    assert torch.equal(F2, Fk)


@pytest.mark.cuda
def test_vrows_slab(dev):
    """K12 writes every needed cell of a slab to its row, exactly."""
    rng = np.random.default_rng(4)
    F = torch.from_numpy(rng.uniform(-2.0, 3.0, (N, N, N))
                         .astype(np.float32)).to(dev)
    idx = compact.needed_order(F, 1.0)
    rank = compact.needed_rank(idx, N ** 3)
    v = _hessians(dev, seed=5)[:3].contiguous()
    got = torch.zeros((idx.numel(), 3), device=dev)
    want = torch.zeros((idx.numel(), 3), device=dev)
    for x0 in range(0, N, 10):
        sl = slice(x0 * N * N, (x0 + 10) * N * N)
        comps = v[:, x0:x0 + 10].reshape(3, -1).contiguous()
        _launched("vrows_slab",
                  lambda: compact.vrows_slab(rank[sl], comps, got))
        compact.vrows_slab_plain(rank[sl], comps, want)
    assert torch.equal(got, want)
    assert torch.equal(got, v.reshape(3, -1)[:, idx].T)


@pytest.mark.cuda
@pytest.mark.parametrize("shifts", [(4, 4, 0), (8, 8, 0), (4, 0, 0),
                                    (0, 0, 4)],
                         ids=["rank-comps-4", "rank-comps-8", "rank-4",
                              "rows-4"])
def test_vrows_slab_off_the_grid(dev, shifts):
    """K12 on slab views off the 16-byte grid, exactly its plain version:
    rank and the components at one offset (the head and tail cells beside
    the quads), rank alone (one cell a thread), and a rows buffer off the
    8-byte grid (a row's floats stored one by one)."""
    rng = np.random.default_rng(6)
    F = torch.from_numpy(rng.uniform(-2.0, 3.0, (N, N, N))
                         .astype(np.float32)).to(dev)
    idx = compact.needed_order(F, 1.0)
    rank = compact.needed_rank(idx, N ** 3)
    v = _hessians(dev, seed=7)[:3].contiguous()
    sr, sc, so = shifts
    got = torch.zeros((idx.numel(), 3), device=dev)
    if so:
        got = _shifted(got, so)
    want = torch.zeros((idx.numel(), 3), device=dev)
    for x0 in (0, 20, N - 10):
        sl = slice(x0 * N * N, (x0 + 10) * N * N)
        r = _shifted(rank[sl], sr) if sr else rank[sl]
        comps = v[:, x0:x0 + 10].reshape(3, -1).contiguous()
        if sc:
            comps = _shifted(comps, sc)
        _launched("vrows_slab", lambda: compact.vrows_slab(r, comps, got))
        compact.vrows_slab_plain(r, comps, want)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_vrows_slab_several_quads_a_thread(dev, shift):
    """K12 on slabs of 600,000 cells, two thirds of a field's cells needed
    in a random order (the out-of-core path's share): more quads than its
    grid has threads, so each thread walks several; exactly its plain
    version, aligned and with rank and components 4 bytes off the 16-byte
    grid."""
    cells, n = 2_000_000, 600_000
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    need = torch.randperm(cells, generator=gen, device=dev)[:2 * cells // 3]
    rank = compact.needed_rank(need, cells)
    comps = torch.randn((3, cells), generator=gen, device=dev)
    got = torch.zeros((need.numel(), 3), device=dev)
    want = torch.zeros_like(got)
    for x0 in (0, 700_000, cells - n):
        r = rank[x0:x0 + n]
        c = comps[:, x0:x0 + n].contiguous()
        if shift:
            r, c = _shifted(r, shift), _shifted(c, shift)
        _launched("vrows_slab", lambda: compact.vrows_slab(r, c, got))
        compact.vrows_slab_plain(r, c, want)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_src32_accumulate_one_pair(dev):
    """K4's accumulation of one component pair (the out-of-core fold) on a
    ragged slab: the six pairs one at a time give the six-component pass's
    result bit for bit."""
    sd, phi2 = _hessians(dev, seed=2), _hessians(dev, seed=3)
    src = _hessians(dev, seed=4)[0]
    want = lpt.src32_accumulate_plain(phi2, sd, src)
    acc = src.clone()
    for c, w in enumerate(lpt.PHI2_WEIGHTS):
        _launched("lpt_src32_accumulate", lambda: lpt.src32_accumulate(
            phi2[c:c + 1], sd[c:c + 1], acc, weights=(w,)))
    assert _same_bits(acc, want)


@pytest.mark.cuda
@pytest.mark.parametrize("interp", tabulated.INTERP)
def test_collapse_update_slab_table(dev, tables, interp):
    """K13 on a ragged slab is K7 without Rmax, exactly, and its plain
    version, on Gaussian Hessians and on the rare-branch batches."""
    ampl, t = tables
    args = (t["tables"][0], t["tables2"][0], t["dv"], t["idx_map"],
            float(ampl[0]), interp)
    special = special_hessians(np.random.default_rng(8))
    rare = torch.from_numpy(np.concatenate([special[k] for k in SPECIAL],
                                           axis=1).astype(np.float32)).to(dev)
    rng = np.random.default_rng(1)
    for sd in (_hessians(dev)[:, 10:20].contiguous(), rare):
        shape = sd.shape[1:]
        F0 = torch.from_numpy(rng.uniform(-10.0, 4.0, shape)
                              .astype(np.float32)).to(dev)
        Fk, Fp, F7 = F0.clone(), F0.clone(), F0.clone()
        mk = _launched(f"collapse_update_slab_table_{interp}",
                       lambda: collapse.collapse_update_slab_table(sd, Fk,
                                                                   *args))
        mp = collapse.collapse_update_slab_table_plain(sd, Fp, *args)
        R7 = torch.zeros_like(F0, dtype=torch.int32)
        collapse.collapse_update_table(sd, F7, R7, 1, *args)
        assert torch.equal(Fk, F7), _mismatch(Fk, F7)
        assert torch.equal(Fk, Fp), _mismatch(Fk, Fp)
        assert abs(mk[1].item() / mp[1].item() - 1.0) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 256, 512])
def test_ooc_factors_gradient_tab(dev, n):
    """K14 in its forms: on a contiguous plane batch (the contiguous form)
    and on a resident spectrum's strided batch (the kz-fastest form), for
    the first, a middle and the last batch of the kz schedule (at 256 and
    512 the one-plane batch kz = N/2): exactly its plain version, and K8's
    values at those modes."""
    p = Params(GridSize=n, BoxSize=float(n), output_z=[0.0], norad=True,
               plc_enabled=False, mod_grav_fr=True, fr0=1e-5,
               scale_dependent=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    spec = rfft3(torch.randn((n, n, n), generator=gen, device=dev))
    gtabs, glo, gdx = fmax.growth_k_tables(Cosmology(p), 0.5, n, dev)
    table = derivatives.GrowthTable(gtabs[2], glo, gdx)
    dense = derivatives.gradient_kspace_tab(spec, gtabs[2], glo, gdx, n)
    sched = fmax_ooc.kz_schedule(n // 2 + 1, fmax_ooc.KZ_BATCH)
    assert n == N or sched[-1] == (n // 2, 1)
    for kz0, B in (sched[0], sched[len(sched) // 2], sched[-1]):
        view = spec[:, :, kz0:kz0 + B].permute(2, 0, 1)
        for src in (view.contiguous(), view):
            got = _launched("ooc_factors_gradient_tab",
                            lambda: derivatives.ooc_gradient_tab(
                                src, kz0, table, n))
            want = derivatives.ooc_gradient_tab_plain(src, kz0, table, n)
            assert torch.equal(torch.view_as_real(got),
                               torch.view_as_real(want))
            k8 = dense[..., kz0:kz0 + B].permute(0, 3, 1, 2)
            assert torch.equal(torch.view_as_real(got),
                               torch.view_as_real(k8))
    with pytest.raises(ValueError, match="iy or its kz axis"):
        derivatives.ooc_gradient_tab(
            spec[:, :, :4].permute(2, 0, 1).contiguous().transpose(1, 2), 0,
            table, n)


# (y0, ny, z0, nz) windows of an [N, N, Nhp] mesh layout: the whole grid, a
# 2x2 pencil shard, and a ragged shard reaching into kz padding beyond Nh
SHARD_WINDOWS = [(0, N, 0, N // 2 + 1), (25, 25, 13, 13), (10, 5, 20, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("window", SHARD_WINDOWS)
def test_shard_kernels(dev, setup, window):
    """K1s, K2s (two radii), K5s and K8s on a shard's window: exactly
    their plain versions, and exactly the full-grid kernels' values on the
    window, zero on the padded planes."""
    p, cosmo = setup
    y0, ny, z0, nz = window
    nzv = max(0, min(nz, N // 2 + 1 - z0))
    args = ic.kdensity_args(Grid(N, p.BoxSize_htrue), cosmo, p.RandomSeed)
    tabs = tuple(torch.from_numpy(t).to(dev) for t in args[:2])
    full = ic.kdensity(N, *tabs, *args[2:], False, False)
    shard = _launched("ic_kdensity_shard", lambda: ic.kdensity_shard(
        N, *tabs, *args[2:], False, False, *window))
    sl = (slice(None), slice(y0, y0 + ny), slice(z0, z0 + nzv))

    def exact(got, plain, dense):
        for want in (plain, dense):
            assert torch.equal(torch.view_as_real(got[..., :nzv]),
                               torch.view_as_real(want[..., :nzv]
                                                  if want is plain
                                                  else want))
        assert torch.all(got[..., nzv:] == 0)

    exact(shard, ic.kdensity_shard_plain(N, *tabs, *args[2:], False, False,
                                         *window), full[sl])
    gp = Params(GridSize=N, BoxSize=float(N), output_z=[0.0], norad=True,
                plc_enabled=False, mod_grav_fr=True, fr0=1e-5,
                scale_dependent=True)
    gtabs, glo, gdx = fmax.growth_k_tables(Cosmology(gp), 0.5, N, dev)
    cases = [("kspace_hessian_shard",
              lambda f, *a: f(shard, R, N, y0, z0),
              derivatives.hessian_kspace_shard,
              derivatives.hessian_kspace_shard_plain,
              lambda: derivatives.hessian_kspace(full, R, N))
             for R in (2.5, 0.0)]
    cases += [("kspace_gradient_shard",
               lambda f, *a: f(shard, 0.7, N, y0, z0),
               derivatives.gradient_kspace_shard,
               derivatives.gradient_kspace_shard_plain,
               lambda: derivatives.gradient_kspace(full, 0.7, N)),
              ("kspace_gradient_tab_shard",
               lambda f, *a: f(shard, gtabs[1], glo, gdx, N, y0, z0),
               derivatives.gradient_kspace_tab_shard,
               derivatives.gradient_kspace_tab_shard_plain,
               lambda: derivatives.gradient_kspace_tab(full, gtabs[1], glo,
                                                       gdx, N))]
    for name, call, kern, plain, dense in cases:
        got = _launched(name, lambda: call(kern))
        exact(got, call(plain), dense()[(slice(None),) + sl])


@pytest.mark.cuda
@pytest.mark.parametrize("window", SHARD_WINDOWS[1:] + [(7, 13, 9, 19)])
@pytest.mark.parametrize("shift", [0, 8])
def test_shard_kernels_bit_for_bit(dev, window, shift):
    """K2s (two radii), K5s and K8s (its table as a tensor and as a
    GrowthTable) on ragged shards, odd ny and nz among them, reaching into
    the padded planes: bit for bit their plain versions on an int32 view
    (signed zeros count, some source modes are -0.0); shift 8 puts the
    shard 8 bytes off the 16-byte grid (the kernel's 8-byte accesses)."""
    y0, ny, z0, nz = window
    rng = np.random.default_rng(ny * nz + shift)
    z = (rng.standard_normal((N, ny, nz))
         + 1j * rng.standard_normal((N, ny, nz))).astype(np.complex64)
    z.real[::7, ::3, ::2] = -0.0
    src = torch.from_numpy(z).to(dev)
    if shift:
        src = _shifted(src, shift)
    gp = Params(GridSize=N, BoxSize=float(N), output_z=[0.0], norad=True,
                plc_enabled=False, mod_grav_fr=True, fr0=1e-5,
                scale_dependent=True)
    gtabs, glo, gdx = fmax.growth_k_tables(Cosmology(gp), 0.5, N, dev)
    table = derivatives.GrowthTable(gtabs[1], glo, gdx)
    cases = [("kspace_hessian_shard", derivatives.hessian_kspace_shard,
              derivatives.hessian_kspace_shard_plain, (R,), (R,))
             for R in (2.5, 0.0)]
    cases += [("kspace_gradient_shard", derivatives.gradient_kspace_shard,
               derivatives.gradient_kspace_shard_plain, (0.7,), (0.7,))]
    cases += [("kspace_gradient_tab_shard",
               derivatives.gradient_kspace_tab_shard,
               derivatives.gradient_kspace_tab_shard_plain, t,
               (gtabs[1], glo, gdx))
              for t in ((gtabs[1], glo, gdx), (table, glo, gdx))]
    for name, kern, plain, args, plain_args in cases:
        got = _launched(name, lambda: kern(src, *args, N, y0, z0))
        assert _same_bits(got, plain(src, *plain_args, N, y0, z0)), name


@pytest.mark.cuda
def test_mesh_on_one_card(dev, setup):
    """The fmax phase over a 2x2 pencil mesh of one card: delta bit-equal
    to the single-device field, the mesh's launch set; against the
    single-device run, displacements within 1e-4 of the maximum and at
    most 1e-3 N^3 cells with |dF| > 0.1 (chip_smoke.py's mesh criteria;
    the CPU shows 25 such cells of 50^3)."""
    from pinocchio_tpu_torch.parallel import driver, pfft
    p, cosmo = setup
    ref = fmax.run_fmax(p, cosmo, dev, keep_dense_products=True)
    kernels.reset_launches()
    mesh = pfft.make_pencil_mesh(4, devices=[dev] * 4)
    r = driver.run_fmax_distributed(p, cosmo, mesh,
                                    keep_dense_products=True)
    torch.cuda.synchronize()
    launched = {k for k, v in kernels.LAUNCHES.items() if v}
    want = {"ic_kdensity_shard", "kspace_hessian_shard",
            "kspace_gradient_shard", "collapse_update",
            "lpt_sources_pointwise", "lpt_src32_accumulate", "needed_rank",
            "gather_rows", "pdf_hist"}
    assert launched == want, (launched - want, want - launched)
    dec = pfft.make_decomp(mesh, N)
    delta = driver.build_kdensity(dec, Grid(N, p.BoxSize_htrue), cosmo,
                                  p.RandomSeed)
    single = ic.generate_kdensity(Grid(N, p.BoxSize_htrue), cosmo,
                                  p.RandomSeed, dev).cpu().numpy()
    got = dec.gather(delta, kspace=True)[:, :, :N // 2 + 1]
    np.testing.assert_array_equal(got.view(np.uint32),
                                  single.view(np.uint32))
    F_ref = ref.products.Fmax.cpu().numpy()
    nflip = int((np.abs(r.dense.Fmax - F_ref) > 0.1).sum())
    assert nflip <= 1e-3 * N ** 3, nflip
    for k, a in ref.dense.vel.items():
        assert np.abs(r.dense.vel[k] - a).max() < 1e-4 * np.abs(a).max()


@pytest.mark.cuda
def test_ooc_mesh_on_one_card(dev, setup):
    """The out-of-core engine over 3 shards of one card (kz windows of 9,
    9 and 8 planes, x-blocks of 20, 20 and 10): the out-of-core launch set
    and, against the single-device engine, Fmax, the variances, the
    FmaxPDF counts, the needed cells, their F and the rows exactly equal
    (each plane's ifft2 in another batch, each x-slab's irfft of the same
    planes)."""
    from pinocchio_tpu_torch import fmax_ooc
    from pinocchio_tpu_torch.parallel import pfft
    p, cosmo = setup
    one = fmax_ooc.run_fmax_ooc(p, cosmo, dev)
    one.pending_fetch.join()
    kernels.reset_launches()
    res = fmax_ooc.run_fmax_ooc(p, cosmo, dev,
                                mesh=pfft.make_mesh(devices=[dev] * 3))
    res.pending_fetch.join()
    torch.cuda.synchronize()
    launched = {k for k, v in kernels.LAUNCHES.items() if v}
    want = {"ic_kdensity_planes", "ooc_factors_hessian",
            "collapse_update_slab", "lpt_sources_pointwise",
            "ooc_factors_pair", "lpt_src32_accumulate", "pdf_hist",
            "ooc_factors_gradient", "needed_rank", "vrows_slab"}
    assert launched == want, (launched - want, want - launched)
    np.testing.assert_array_equal(res.products.gather()[0],
                                  one.products.Fmax.cpu().numpy())
    np.testing.assert_array_equal(res.smoothing.true_variance,
                                  one.smoothing.true_variance)
    np.testing.assert_array_equal(res.pdf_hist, one.pdf_hist)
    a, b = res.host_products, one.host_products
    np.testing.assert_array_equal(a.ci, b.ci)
    np.testing.assert_array_equal(a.F, b.F)
    for k in b.vel:
        np.testing.assert_array_equal(a.vel[k], b.vel[k])


@pytest.mark.cuda
def test_copies_land_after_their_source_is_freed_and_reused(dev):
    """The hand-off's copies (handoff.CopyStream) held back on the copy
    stream behind a sleep: their source tensor is freed and a tensor of the
    same size is allocated and overwritten before they run; they still
    land the source's values, because each copy marks its source as used
    by the copy stream (record_stream)."""
    n = 1 << 24
    src = torch.arange(n, dtype=torch.float32, device=dev)
    want = src.cpu().numpy()
    host = handoff.host_empty((n,), torch.float32, dev)
    copier = handoff.CopyStream(dev)
    copier.after()
    with torch.cuda.stream(copier.stream):
        torch.cuda._sleep(200_000_000)
    b = handoff.chunk_bounds(n)
    copies = [copier.copy(host[b[i]:b[i + 1]], src[b[i]:b[i + 1]])
              for i in range(handoff.N_CHUNKS)]
    ptr = src.data_ptr()
    del src
    other = torch.empty(n, dtype=torch.float32, device=dev)
    other.fill_(-1.0)
    assert not copies[-1].event.query(), "the copies ran before the reuse"
    for c in copies:
        c.wait()
    np.testing.assert_array_equal(host.numpy(), want)
    assert other.data_ptr() != ptr
    torch.cuda.synchronize()
    assert bool((other == -1.0).all())


@pytest.mark.cuda
def test_overlapped_handoff_on_the_card(dev, setup):
    """The dense and out-of-core engines' hand-off on the card: the
    products read through the views before the join against a run joined
    before it is read, bit for bit, and the same catalogs, the copies
    landing on the copy stream behind events."""
    from pinocchio_tpu_torch import fmax_ooc
    from pinocchio_tpu_torch.fragment.driver import run_fragmentation
    p, cosmo = setup
    for run in (fmax.run_fmax, fmax_ooc.run_fmax_ooc):
        a = run(p, cosmo, dev)
        a.pending_fetch.join()
        fa = run_fragmentation(p, cosmo, a, verbose=False)
        b = run(p, cosmo, dev)
        fb = run_fragmentation(p, cosmo, b, verbose=False)
        sa, sb = a.host_products, b.host_products
        np.testing.assert_array_equal(sa.ci, sb.ci)
        np.testing.assert_array_equal(sa.F, sb.F)
        for k in sa.vel:
            np.testing.assert_array_equal(sa.vel[k], sb.vel[k])
        b.pending_fetch.join()
        np.testing.assert_array_equal(a.pdf_hist, b.pdf_hist)
        np.testing.assert_array_equal(fa.counters, fb.counters)
        for x, y in zip(fa.catalogs, fb.catalogs):
            np.testing.assert_array_equal(np.sort(x.name), np.sort(y.name))


@pytest.mark.cuda
def test_dense_handoff_lands_int64_cell_indices(dev):
    """A 256^3 f(R) realization (four displacement sets) on the dense
    engine, after a warm one: the overlapped hand-off's bytes to the host
    are the sort's int64 cell indices, F, every table's rows and the
    FmaxPDF counts, 8 + 4 + 12 x keys x sets bytes a row and 8 a bin;
    its cell indices are the needed cells of its Fmax in (-F, cell) order
    and F their values; the entry returns before the last table has
    landed."""
    import gc
    from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
    from pinocchio_tpu_torch.scaledep import set_scaledep_gm
    p = Params(GridSize=256, BoxSize=256.0, output_z=[2.0, 1.0, 0.5, 0.0],
               norad=True, plc_enabled=False, mod_grav_fr=True, fr0=1e-5,
               scale_dependent=True, recompute_displacements=True,
               MaxMemPerParticle=400)
    cosmo = Cosmology(p)
    gm = set_scaledep_gm(p, cosmo, fmax.Smoothing.build(p, cosmo),
                         largest_halo_mass(p, cosmo), verbose=False)
    fmax.run_fmax(p, cosmo, dev, scaledep_gm=gm).pending_fetch.join()
    gc.collect()
    before = handoff.host_totals()["d2h_bytes_total"]
    res = fmax.run_fmax(p, cosmo, dev, scaledep_gm=gm)
    times = res.pending_fetch.join()
    sp = res.host_products
    c, nkeys, nsets = sp.ci.size, len(sp.vel), len(sp.segments)
    assert (c, nkeys, nsets) == (len(sp.F), 4, 4)
    assert sp.ci.dtype == np.int64 and not sp.ci.flags.owndata
    assert (times["d2h_bytes_total"] - before
            == 8 * c + 4 * c + 12 * c * nkeys * nsets
            + 8 * compact.PDF_BINS)
    assert res.timings["handoff_return"] < times["handoff_last"]
    F = res.products.Fmax.cpu().numpy().ravel()
    want = np.flatnonzero(F >= p.Flast)
    np.testing.assert_array_equal(sp.ci, want[np.lexsort((want, -F[want]))])
    np.testing.assert_array_equal(sp.F, F[sp.ci])


def _host_arrays(res):
    """Every host array of a realization's products, in page-locked
    memory: the FmaxPDF counts, the cell indices, F and each set's rows."""
    sp = res.host_products
    sets = sp.segments if sp.segments is not None else [sp.vel]
    return [res.pdf_hist, sp.ci, sp.F] + [
        s.buffer(k) if hasattr(s, "buffer") else s[k]
        for s in sets for k in s.keys()]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "ooc"])
def test_pinned_pool_across_realizations(dev, engine):
    """Three 64^3 realizations, seeds 1, 2, 3, the first's products kept
    and the second's dropped: the third's page-locked buffers all come
    from the pool (on the out-of-core engine also the lpt_rows thread's),
    the first's products keep their bits through the third, and the
    third's equal its seed's run into fresh memory after
    release_pinned()."""
    import dataclasses
    import gc
    p = Params(GridSize=64, BoxSize=64.0, output_z=[2.0, 1.0, 0.5, 0.0],
               norad=True, plc_enabled=False,
               ooc="on" if engine == "ooc" else "off")
    cosmo = Cosmology(p)
    run = fmax_ooc.run_fmax_ooc if engine == "ooc" else fmax.run_fmax

    def realize(seed):
        res = run(dataclasses.replace(p, RandomSeed=seed), cosmo, dev)
        res.pending_fetch.join()
        return res

    gc.collect()
    handoff.release_pinned()
    res = realize(1)
    first = _host_arrays(res)
    want = [_bits(a).copy() for a in first]
    del res
    res = realize(2)
    del res
    gc.collect()
    before = handoff.host_totals()
    res = realize(3)
    after = handoff.host_totals()
    third = [_bits(a).copy() for a in _host_arrays(res)]
    del res
    gc.collect()
    assert after["pinned_alloc_calls_total"] == before[
        "pinned_alloc_calls_total"]
    assert after["pinned_reuse_calls_total"] > before[
        "pinned_reuse_calls_total"]
    for a, w in zip(first, want):
        np.testing.assert_array_equal(_bits(a), w)
    del first
    gc.collect()
    handoff.release_pinned()
    before = handoff.host_totals()
    res = realize(3)
    assert handoff.host_totals()["pinned_reuse_calls_total"] == before[
        "pinned_reuse_calls_total"]
    fresh = _host_arrays(res)
    assert len(fresh) == len(third)
    for a, w in zip(fresh, third):
        np.testing.assert_array_equal(_bits(a), w)


@pytest.mark.parametrize("name,fn", [
    ("ic_kdensity_shard", lambda t: ic.kdensity_shard(
        4, t, t, (0, 0), (0, 0), 0.0, 1.0, False, False, 0, 2, 0, 3)),
    ("kspace_hessian_shard", lambda t: derivatives.hessian_kspace_shard(
        t, 0.0, 4, 0, 0)),
    ("kspace_gradient_shard", lambda t: derivatives.gradient_kspace_shard(
        t, 1.0, 4, 0, 0)),
    ("kspace_gradient_tab_shard",
     lambda t: derivatives.gradient_kspace_tab_shard(t, t, 0.0, 1.0, 4, 0,
                                                     0)),
    ("ic_kdensity_planes", lambda t: ic.kdensity_planes(
        4, t, t, t, 0, 1, 0.0, 1.0, False, False)),
    ("ooc_factors_hessian", lambda t: derivatives.ooc_hessian(t, 0, 0.0, 4)),
    ("ooc_factors_gradient", lambda t: derivatives.ooc_gradient(
        t, 0, 1.0, 4)),
    ("ooc_factors_pair", lambda t: derivatives.ooc_pair(t, t, 0, 0, 1, 4)),
    ("collapse_update_slab", lambda t: collapse.collapse_update_slab(
        t, t, [])),
    ("vrows_slab", lambda t: compact.vrows_slab(t, t, t)),
    ("collapse_update_slab_table_bilinear",
     lambda t: collapse.collapse_update_slab_table(t, t, t, t, t, t, 1.0,
                                                   "bilinear")),
    ("ooc_factors_gradient_tab", lambda t: derivatives.ooc_gradient_tab(
        t, 0, derivatives.GrowthTable(t, 0.0, 1.0), 4)),
    ("kspace_hessian", lambda t: derivatives.hessian_kspace(t, 0.0, 4)),
    ("collapse_update", lambda t: collapse.collapse_update(t, t, t, 0, [])),
    ("lpt_sources_pointwise", lambda t: lpt.sources_pointwise(t)),
    ("collapse_update_table_bicubic", lambda t: collapse.collapse_update_table(
        t, t, t, 0, t, t, t, t, 1.0, "bicubic")),
    ("kspace_gradient_tab", lambda t: derivatives.gradient_kspace_tab(
        t, t, 0.0, 1.0, 4)),
    ("gather_rows", lambda t: compact.gather_rows(t, [t], t)),
    ("needed_rank", lambda t: compact.needed_rank(t, 4)),
    ("pdf_hist", lambda t: compact.pdf_hist(t)),
    ("exchange_count", lambda t: xops.count(t, (0, 1, 0, 1, 0, 1), 4, t, t,
                                            1)),
    ("exchange_pack", lambda t: xops.pack(t, t, 0, t, t, t, t, t, t, 1, t)),
    ("exchange_paint", lambda t: xops.paint(
        xops.PaintSpheres(np.zeros((1, 4), np.float32),
                          np.zeros(1, np.int32), 4).plan((0, 1, 0, 1, 0, 1)),
        t, t, t, t, 1)),
    ("storage_store", lambda t: storage.store_kz(
        _meta((1, 2, 4, 4), torch.complex64), _meta((1, 4, 4, 3, 2)), 0)),
    ("storage_store", lambda t: storage.store_rows(
        _meta((4, 5), torch.complex64), _meta((4, 3, 2)), 1)),
    ("storage_load", lambda t: storage.load_kz(_meta((1, 4, 4, 3, 2)), 0,
                                               2)),
    ("storage_load", lambda t: storage.load_rows(_meta((2, 4, 3, 2)), 0,
                                                 4)),
])
def test_wrappers_refuse_other_devices(name, fn):
    """A wrapper takes the plain version only for a CPU tensor: any other
    device that is not CUDA raises, whether or not a card is present."""
    with pytest.raises(ValueError, match=f"{name}: unsupported device"):
        fn(torch.empty(6, 4, 4, 4, device="meta"))


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _shifted(t, nbytes):
    """A contiguous copy of t whose data starts nbytes past a 16-byte
    boundary."""
    step = t.element_size()
    buf = torch.empty(t.numel() + 16 // step, dtype=t.dtype, device=t.device)
    out = buf[nbytes // step:nbytes // step + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_storage_kernels(dev, dtype, n):
    """K18 and K19 exactly their plain versions at n = 50 and 64 (ragged
    tiles of 128 cells), on Gaussian values over some 25 binary orders of
    magnitude (float16 overflows on some, as the plain version does), in
    every form the engine takes and at every alignment: kz batches of 10,
    16 and 16 planes into a stack at planes 3, 4 and 5 (runs 12, 0 and 4
    bytes into the 16-byte grid), of one plane at its last, and of 16
    planes from a batch 8 bytes off the grid; a 43-plane window (a 3-shard
    kz window at 256^3) filled and read by its schedule 16, 16, 11; z-rfft
    rows whole, from column 2 into 20 planes and from the middle shard's
    window, into destinations on and 4 bytes off the grid; an x-slab of the
    stack (also 4 bytes off the grid) and of the window widened, the same
    slab gathered from three kz pieces (the mesh's concatenation) and 4
    bytes off the grid; a
    spectrum's kz batches of 9 planes at 5, 16 at 4 and 5, and 1 at its
    last widened."""
    from pinocchio_tpu_torch.fmax_ooc import split
    gen = torch.Generator(device=dev).manual_seed(3)
    nh = n // 2 + 1

    def values(shape):
        x = torch.randn(shape + (2,), device=dev, generator=gen)
        x *= torch.exp(4.0 * torch.randn(shape + (2,), device=dev,
                                         generator=gen))
        return torch.view_as_complex(x)

    def bits(t):
        return (torch.view_as_real(t) if t.is_complex() else t).view(
            torch.int16)

    def stored(batch, stack, k):
        want = stack.clone()
        _launched("storage_store", lambda: storage.store_kz(batch, stack, k))
        storage.store_kz_plain(batch, want, k)
        assert torch.equal(bits(stack), bits(want))

    def loaded(stack, k, B):
        got = _launched("storage_load", lambda: storage.load_kz(stack, k, B))
        assert torch.equal(bits(got), bits(storage.load_kz_plain(stack, k,
                                                                 B)))

    def widened(src, x0, Bx, want=None):
        got = _launched("storage_load", lambda: storage.load_rows(src, x0,
                                                                  Bx))
        if want is None:
            want = storage.load_rows_plain(src, x0, Bx)
        assert torch.equal(bits(got), bits(want))
        return got

    stack = torch.zeros((3, n, n, nh, 2), dtype=dtype, device=dev)
    for B, k in ((10, 3), (16, 4), (16, 5), (1, nh - 1)):
        stored(values((3, B, n, n)), stack, k)
    stored(_shifted(values((3, 16, n, n)), 8), stack, 7)
    window = torch.zeros((2, n, n, 43, 2), dtype=dtype, device=dev)
    for k, B in ((0, 16), (16, 16), (32, 11)):
        stored(values((2, B, n, n)), window, k)
        loaded(window[1:2], k, B)
    widened(window, 3, 2)

    r = values((5, n, nh))
    k0, nkz = split(nh, 3)[1]
    for W, col0, off in ((nh, 0, 0), (nh, 0, 4), (20, 2, 0), (20, 2, 4),
                         (nkz, k0, 4)):
        dst = _shifted(torch.zeros((5, n, W, 2), dtype=dtype, device=dev),
                       off)
        want = dst.clone()
        _launched("storage_store", lambda: storage.store_rows(r, dst, col0))
        storage.store_rows_plain(r, want, col0)
        assert torch.equal(bits(dst), bits(want))

    a = widened(stack, 7, 5)
    pieces = torch.cat([stack[:, 7:12, :, z0:z1] for z0, z1 in
                        ((0, 9), (9, 18), (18, nh))], dim=-2)
    widened(pieces, 0, 5, a)
    widened(_shifted(pieces, 4), 0, 5, a)
    widened(_shifted(stack, 4), 7, 5, a)
    for k, B in ((5, 9), (4, 16), (5, 16), (nh - 1, 1)):
        loaded(stack[1:2], k, B)


def exchange_case(N, nhosts, seed=0):
    """Inputs of K15-K17 on the (1, 1) shard of a 2x2 pencil layout at N:
    a sorted random third of the shard's cells as its needed rows; per
    host one to three boxes, some wrapped across the grid's edge, one
    wider than the grid, the last host none; spheres centred anywhere (so
    some cross the shard's edge and the periodic wrap), one of radius N/2
    and one of radius 0."""
    rng = np.random.default_rng(seed)
    h2 = N // 2
    block = (h2, h2, h2, h2, 0, N)
    ncell = h2 * h2 * N
    cells = np.sort(rng.choice(ncell, ncell // 3, replace=False))

    def boxes(turn0):
        out = []
        for h in range(nhosts):
            host = []
            for _ in range(0 if h == nhosts - 1 else rng.integers(1, 4)):
                lo = (3, 2) if turn0 else (N // 2, 3)
                host.append(tuple(
                    (int(rng.integers(0, N)),
                     int(rng.integers(N // lo[0], N // lo[1] + N // 2)))
                    for _ in range(3)))
            out.append(tuple(host))
        out[0] = out[0] + (((N - 3, N + 5), (0, N), (N - 2, 6)),)
        return tuple(out)
    sph = np.column_stack([rng.integers(0, N, (40, 3)),
                           rng.integers(1, N // 6 + 2, 40)]).astype(
                               np.float32)
    sph[0] = (N - 1, N - 1, 1, 7)
    sph[1] = (h2, h2, N - 2, N // 2)
    sph[2] = (3, 3, 3, 0)
    owner = rng.integers(0, nhosts, len(sph)).astype(np.int32)
    return dict(block=block, cells=cells, pad=boxes(False), t0=boxes(True),
                spheres=sph, owner=owner)


def _tables(case, dev):
    from pinocchio_tpu_torch.parallel.exchange import region_tables
    return (*region_tables(case["pad"], dev), *region_tables(case["t0"], dev))


@pytest.mark.cuda
@pytest.mark.parametrize("nhosts", [3, 16, 40])
def test_exchange_count(dev, nhosts):
    case = exchange_case(N, nhosts)
    pb, po, tb, to = _tables(case, dev)
    cells = torch.from_numpy(case["cells"]).to(dev)
    got = xops.count(cells, case["block"], N, pb, po, nhosts)
    want = xops.count_plain(cells, case["block"], N, pb, po, nhosts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 0 and int(got[1][:, -1].sum()) == 0
    hmap = xops.paint(xops.PaintSpheres(case["spheres"], case["owner"],
                                        N).plan(case["block"]), pb, po, tb,
                      to, nhosts)
    got = xops.count(cells, case["block"], N, pb, po, nhosts, hmap=hmap)
    want = xops.count_plain(cells, case["block"], N, pb, po, nhosts,
                            hmap=hmap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nhosts", [1, 2, 16, 33])
@pytest.mark.parametrize("n", [1, 2 * 256 + 3, 5 * 1024 + 7, None])
def test_exchange_count_edge_cases(dev, nhosts, n):
    """K15 exactly its plain version on the (1, 1) shard of a 2x2 pencil
    at N: one row, counts not a multiple of 4 or 256 (the last run of 256
    rows and the last block ragged) and every cell of the shard; the cells
    8 bytes off the 16-byte grid too; boxes with x0 = N - 1 and L >= N, a
    host with no box (the last, unless H = 1); with boxes and with request
    maps (H = 33: two bitmask words)."""
    h2 = N // 2
    block = (h2, h2, h2, h2, 0, N)
    ncell = h2 * h2 * N
    rng = np.random.default_rng(nhosts)
    cells = np.arange(ncell) if n is None else np.sort(
        rng.choice(ncell, n, replace=False))
    rows, off = [], [0]
    for h in range(nhosts):
        if h < nhosts - 1 or nhosts == 1:
            rows.append([N - 1, N + 3, int(rng.integers(0, N)), N // 3,
                         int(rng.integers(0, N)), N])
            rows.append([int(rng.integers(0, N)), N // 2, N - 1, 2, 0, N])
        off.append(len(rows))
    boxes = torch.tensor(rows, dtype=torch.int32, device=dev)
    box_off = torch.tensor(off, dtype=torch.int32, device=dev)
    hmap = torch.from_numpy(rng.random((nhosts, h2, h2, N)) < 0.4).to(
        torch.uint8).to(dev)
    c = torch.from_numpy(cells).to(dev)
    for cc in (c, _shifted(c, 8)):
        for m in (None, hmap):
            got = _launched("exchange_count", lambda: xops.count(
                cc, block, N, boxes, box_off, nhosts, hmap=m))
            want = xops.count_plain(cc, block, N, boxes, box_off, nhosts,
                                    hmap=m)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            assert int(got[1].sum()) > 0 or len(cells) < 4


@pytest.mark.cuda
@pytest.mark.parametrize("n,nhosts,nbox", [(N, 3, 40), (512, 50, 2)])
def test_exchange_count_mask_chunks_and_box_loop(dev, n, nhosts, nbox):
    """K15 exactly its plain version where a host has more than 32 boxes
    (its masks take two words) and where the masks' tables outgrow shared
    memory (50 hosts over the 512^3 shard: (H + nb / 32)(2 + 1024) ints
    above COUNT_TABLE_INTS), so the boxes are tested in turn; some thousand
    random needed rows of the (1, 1) shard of a 2x2 pencil, boxes wrapped
    and wider than the grid, the last host none."""
    h2 = n // 2
    block = (h2, h2, h2, h2, 0, n)
    rng = np.random.default_rng(n)
    cells = np.sort(rng.choice(h2 * h2 * n, 3001, replace=False))
    rows, off = [], [0]
    for h in range(nhosts):
        for _ in range(nbox if h < nhosts - 1 else 0):
            rows.append([int(v) for v in (
                rng.integers(0, n), rng.integers(1, n + 5),
                rng.integers(0, n), rng.integers(1, n + 5),
                rng.integers(0, n), rng.integers(1, n + 5))])
        off.append(len(rows))
    nb = len(rows)
    masks = nhosts + 1 + (nhosts + nb // 32) * (2 + 2 * n)
    assert (masks > xops.COUNT_TABLE_INTS) == (nhosts == 50)
    boxes = torch.tensor(rows, dtype=torch.int32, device=dev)
    box_off = torch.tensor(off, dtype=torch.int32, device=dev)
    c = torch.from_numpy(cells).to(dev)
    got = _launched("exchange_count", lambda: xops.count(
        c, block, n, boxes, box_off, nhosts))
    want = xops.count_plain(c, block, n, boxes, box_off, nhosts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nhosts,every", [(1, False), (3, False),
                                          (16, False), (33, False),
                                          (3, True), (33, True)])
def test_exchange_pack(dev, nhosts, every):
    """K16 equals its plain version exactly, every slot of out written,
    with 4 row channels (all held in registers) and 8: 1, 3, 16 and 33
    hosts (a second bitmask word), 1-3 destinations a host, a host with no
    member and, with every, rows that are members of every host."""
    case = exchange_case(N, nhosts, seed=1)
    if every:
        case["pad"] = tuple((((0, N), (0, N), (0, N)),)
                            for _ in range(nhosts))
    pb, po, _, _ = _tables(case, dev)
    cells = torch.from_numpy(case["cells"]).to(dev)
    bits, counts = xops.count(cells, case["block"], N, pb, po, nhosts)
    n = len(cells)
    tot = counts.sum(0).tolist()
    if every:
        assert tot == [n] * nhosts
    elif nhosts > 1:
        assert tot[-1] == 0 and sum(tot) > 0
    rng = np.random.default_rng(2)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    nd = [1 + h % 3 for h in range(nhosts)]
    devs, q = [], 0
    for h in range(nhosts):
        devs.append(list(range(q, q + nd[h])) + [0] * (3 - nd[h]))
        q += nd[h]
    seg_n = np.array([max(0, -(-(tot[h] - j) // nd[h])) for h in
                      range(nhosts) for j in range(nd[h])], np.int64)
    for nch in (4, 8):
        buf = torch.from_numpy(rng.standard_normal(n * (2 + 3 * nch))
                               .astype(np.float32)).to(dev)
        rowf = 2 + 3 * nch
        seg_base = np.concatenate([[0], np.cumsum(seg_n * rowf)[:-1]])
        args = (perm, buf, n, bits,
                torch.cumsum(counts, 0, dtype=torch.int64) - counts,
                torch.tensor(nd, dtype=torch.int32, device=dev),
                torch.tensor(devs, dtype=torch.int32, device=dev),
                torch.from_numpy(seg_base).to(dev),
                torch.from_numpy(seg_n).to(dev), nch)
        total = int(seg_n.sum()) * rowf
        want = xops.pack_plain(*args, torch.zeros(total, device=dev))
        got = _launched("exchange_pack", lambda: xops.pack(
            *args, torch.full((total,), np.nan, device=dev)))
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_exchange_pack_past_2_31_floats(dev):
    """K16's 64-bit float offsets: a shard of 16 row channels (4 in
    registers, 12 read in the store loop) whose buf and segment reach past
    2^31 floats, every row a member of one host with two destinations;
    every float of buf a distinct bit pattern, so out must equal the plain
    version's bit for bit."""
    nch = 16
    rowf = 2 + 3 * nch
    n = -(-2 ** 31 // rowf) + 1000               # offsets past 2^31 - 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    perm = torch.randperm(n, generator=gen, device=dev)
    buf = torch.arange(-2 ** 31, n * rowf - 2 ** 31, dtype=torch.int32,
                       device=dev).view(torch.float32)
    bits = torch.ones((n, 1), dtype=torch.int32, device=dev)
    nblocks = -(-n // xops.THREADS)
    block_off = (torch.arange(nblocks, dtype=torch.int64, device=dev)
                 * xops.THREADS)[:, None]
    seg_n = np.array([-(-n // 2), n // 2], np.int64)
    args = (perm, buf, n, bits, block_off,
            torch.tensor([2], dtype=torch.int32, device=dev),
            torch.tensor([[0, 1]], dtype=torch.int32, device=dev),
            torch.tensor([0, seg_n[0] * rowf], dtype=torch.int64,
                         device=dev),
            torch.from_numpy(seg_n).to(dev), nch)
    got = _launched("exchange_pack", lambda: xops.pack(
        *args, torch.full((n * rowf,), -1, dtype=torch.int32,
                          device=dev).view(torch.float32)))
    want = xops.pack_plain(*args, torch.zeros(n * rowf, device=dev))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# K17's adversarial spheres at N = 50 (cx, cy, cz, r): 2r = N, 2r > N, r >= N
# (several wraps), fractional radii (truncated), r in (0, 1), centres on the
# grid's edge, and spheres wholly outside the (1, 1) shard
PAINT_SPHERES = np.array([
    [10, 30, 20, 25], [40, 5, 48, 26], [0, 0, 0, 50], [49, 49, 49, 123],
    [7, 31, 3, 4.99], [26, 27, 0, 1.5], [30, 30, 30, 0.7], [0, 49, 25, 9],
    [2, 2, 25, 10], [5, 10, 40, 4], [25, 25, 25, 1], [33, 44, 12, -3]],
    np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("adversarial", [False, True])
def test_exchange_paint(dev, adversarial):
    """K17 from its plan equals the plain cube walk exactly: the spheres of
    exchange_case, and the adversarial ones (with the shard's own
    block, a slab and a pencil block), each host's boxes as there."""
    nhosts = 5
    case = exchange_case(N, nhosts, seed=3)
    pb, po, tb, to = _tables(case, dev)
    if not adversarial:
        cases = [(case["spheres"], case["owner"], case["block"])]
    else:
        owner = np.arange(len(PAINT_SPHERES), dtype=np.int32) % (nhosts - 1)
        cases = [(PAINT_SPHERES, owner, blk) for blk in (
            case["block"], (10, 7, 0, N, 0, N), (0, N, 3, 17, 41, 9))]
    for sph, owner, block in cases:
        plan = xops.PaintSpheres(sph, owner, N).plan(block)
        got = _launched("exchange_paint", lambda: xops.paint(
            plan, pb, po, tb, to, nhosts))
        assert torch.equal(got, xops.paint_plain(plan, pb, po, tb, to,
                                                 nhosts))
        assert int(got.sum()) > 0
