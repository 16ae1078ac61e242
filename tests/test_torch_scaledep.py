"""Scale-dependent growth and RECOMPUTE_DISPLACEMENTS in the PyTorch port
against the JAX package (f(R) gravity, fR0 = 1e-5, the massive-neutrino
and modified-gravity feature set).

Tolerances:
- growth_k_tables, inverse_growth_packs and the sweep's weight tables
  (growth_tables with k_dens, growth_tables_2d, the segment weights):
  identical.
- first_derivatives_tab on JAX's delta(k) and growth tables: within 1e-5
  of the stack's maximum (float32 FFT round-off, as test_torch_derivatives).
- The displacement sets of a RECOMPUTE run: every set within 1e-5 of the
  maximum of the single-set run's rows scaled by the growth ratio (the
  growth enters as one float32 multiply in k-space), and the rows of each
  set equal to the dense fields at the needed cells.
- End to end at 64^3: halo counts per output within max(5, 0.5 %), over
  97 % of the final halos identical in name and mass, mass-function bins
  of more than 100 halos within 3 % (test_torch_pipeline.py's family).
"""

import numpy as np
import pytest
import torch

from pinocchio_tpu import fmax as jfmax
from pinocchio_tpu import ic as jic
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.fragment import driver as jdriver
from pinocchio_tpu.grids import Grid as JGrid
from pinocchio_tpu.ops import derivatives as jder
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu.scaledep import set_scaledep_gm as jax_set_scaledep_gm
from pinocchio_tpu_torch import fmax
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.fragment import driver
from pinocchio_tpu_torch.grids import Grid
from pinocchio_tpu_torch.ic import generate_kdensity
from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
from pinocchio_tpu_torch.ops import derivatives
from pinocchio_tpu_torch.run import run_pipeline
from pinocchio_tpu_torch.scaledep import set_scaledep_gm
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 32
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)


def _params(n=N, **kw):
    return params_pair(**bench_kwargs(n, **kw))[1]


@pytest.fixture(scope="module")
def fr():
    """The port's f(R) Params, Cosmology, ladder and per-radius growth."""
    p = _params(**FR)
    cosmo = Cosmology(p)
    assert cosmo.scale_dep
    sm = fmax.Smoothing.build(p, cosmo)
    gm = set_scaledep_gm(p, cosmo, sm, largest_halo_mass(p, cosmo),
                         verbose=False)
    return p, cosmo, sm, gm


@pytest.fixture(scope="module")
def jfr():
    """The JAX package's own, from the same keyword arguments."""
    p = params_pair(**bench_kwargs(N, **FR))[0]
    cosmo = JaxCosmology(p)
    sm = jfmax.Smoothing.build(p, cosmo)
    from pinocchio_tpu.io.catalogs import largest_halo_mass as jlargest
    gm = jax_set_scaledep_gm(p, cosmo, sm, jlargest(p, cosmo), verbose=False)
    return p, cosmo, sm, gm


@pytest.mark.parametrize("z", [2.0, 0.0])
def test_growth_k_tables_identical(fr, jfr, z):
    _, cosmo, _, _ = fr
    gtabs, glo, gdx = fmax.growth_k_tables(cosmo, z, N, "cpu")
    jt, jlo, jdx = jfmax.growth_k_tables(jfr[1], z, N)
    np.testing.assert_array_equal(gtabs.numpy(), np.asarray(jt))
    assert glo == float(jlo) and gdx == float(jdx)


def test_first_derivatives_tab_matches_jax(jfr):
    p, cosmo, _, _ = jfr
    jk = jic.generate_kdensity(JGrid(N=N, BoxSize=p.BoxSize_htrue), cosmo,
                               p.RandomSeed)
    jt, jlo, jdx = jfmax.growth_k_tables(cosmo, 0.5, N)
    state = fmax.load_jax_state(dict(kdensity=np.asarray(jk),
                                     gtabs=np.asarray(jt), glo=jlo,
                                     gdx=jdx), "cpu")
    for order in (0, 1, 3):
        want = np.asarray(jder.first_derivatives_tab(jk, jt[order], jlo,
                                                     jdx, N))
        got = derivatives.first_derivatives_tab(
            state["kdensity"], state["gtabs"][order], float(state["glo"]),
            float(state["gdx"]), N).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_inverse_growth_packs_identical(fr, jfr):
    _, cosmo, sm, gm = fr
    _, jcosmo, jsm, jgm = jfr
    np.testing.assert_array_equal(
        fmax.inverse_growth_packs(cosmo, sm, gm),
        jfmax.inverse_growth_packs(jcosmo, jsm, jgm))


def test_sweep_weight_tables_identical(fr, jfr):
    p, cosmo, _, gm = fr
    jp, jcosmo, _, jgm = jfr
    k_dens = gm.k_GM_dens[-1]
    assert k_dens == jgm.k_GM_dens[-1]
    lo, dlog, tabs = driver.growth_tables(p, cosmo, k_dens=k_dens)
    jlo, jdlog, jtabs = jdriver.growth_tables(jp, jcosmo, k_dens=k_dens)
    assert (lo, dlog) == (jlo, jdlog)
    for k in ("w1", "w2", "w31", "w32", "dv1", "dv2", "dv31", "dv32", "D1"):
        np.testing.assert_array_equal(tabs[k], jtabs[k])
    want = jdriver.growth_tables_2d(jp, jcosmo)
    got = driver.growth_tables_2d(p, cosmo)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for gm_, jgm_ in ((gm, jgm), (None, None)):
        want = jdriver._segment_weight_tables(jp, jcosmo, jgm_)
        got = driver._segment_weight_tables(p, cosmo, gm_)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_sweep_D1_uses_the_density_scale(fr):
    """The sweep's D(z) table is taken at the smoothed density's effective
    scale when growth is scale-dependent (growth_tables' k_dens), not at
    the Nyquist wavenumber."""
    p, cosmo, _, gm = fr
    k_dens = gm.k_GM_dens[-1]
    lo, dlog, tabs = driver.growth_tables(p, cosmo, k_dens=k_dens)
    _, _, nyq = driver.growth_tables(p, cosmo)
    z = 10.0 ** (lo + dlog * np.arange(len(tabs["D1"]))) - 1.0
    np.testing.assert_allclose(tabs["D1"], cosmo.GrowingMode(z, k_dens),
                               rtol=1e-12)
    assert np.abs(tabs["D1"] / nyq["D1"] - 1.0).max() > 1e-4
    np.testing.assert_array_equal(tabs["w1"], nyq["w1"])


@pytest.fixture(scope="module")
def port_run(fr, tmp_path_factory):
    p, _, _, _ = fr
    return run_pipeline(p, outdir=str(tmp_path_factory.mktemp("fr")),
                        device="cpu", verbose=False, write_outputs=False)


def test_fragmentation_gets_the_density_scale(fr, port_run, monkeypatch):
    p, cosmo, _, gm = fr
    seen = []
    real = driver.growth_tables

    def spy(*a, **k):
        seen.append(k.get("k_dens"))
        return real(*a, **k)

    monkeypatch.setattr(driver, "growth_tables", spy)
    driver.run_fragmentation(p, cosmo, port_run["fmax"], scaledep_gm=gm,
                             verbose=False)
    assert seen == [gm.k_GM_dens[-1]]


def test_segments_are_the_dense_fields_at_the_needed_cells(fr, port_run):
    p, cosmo, _, _ = fr
    sp = port_run["fmax"].host_products
    assert len(sp.segments) == len(p.output_z)
    assert sp.segments[0] is sp.vel
    kdensity = generate_kdensity(Grid(N, p.BoxSize_htrue), cosmo,
                                 p.RandomSeed, "cpu")
    sd = derivatives.second_derivatives(kdensity, 0.0, N)
    sources = fmax.displacement_sources(kdensity, sd, N, p.lpt_order)
    for s, z in enumerate(p.output_z):
        fields = fmax.displacement_fields(
            sources, fmax.growth_k_tables(cosmo, z, N, "cpu"), N, True)
        for k, v in fields.items():
            np.testing.assert_array_equal(
                sp.segments[s][k], v.reshape(3, -1)[:, sp.ci].T.numpy())


def test_recompute_stores_displacements_at_the_first_output():
    """With RECOMPUTE_DISPLACEMENTS the stored set is at output_z[0] and
    set s at output_z[s]; without it the one set is at the last output."""
    base = _params(16)
    p = _params(16, recompute_displacements=True)
    cosmo = Cosmology(base)
    one = fmax.run_fmax(base, cosmo, "cpu").host_products
    sets = fmax.run_fmax(p, cosmo, "cpu").host_products
    np.testing.assert_array_equal(one.ci, sets.ci)
    assert one.segments is None and sets.segments[0] is sets.vel
    grow = dict(v1=cosmo.GrowingMode, v2=cosmo.GrowingMode_2LPT,
                v31=cosmo.GrowingMode_3LPT_1, v32=cosmo.GrowingMode_3LPT_2)
    for s, z in enumerate(p.output_z):
        for k, g in grow.items():
            want = one.vel[k] * (float(g(z)) / float(g(p.zlast)))
            got = sets.segments[s][k]
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
                (s, k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jp, p = params_pair(**bench_kwargs(64, **FR))
    jax_res = jax_run_pipeline(jp, outdir=str(tmp_path_factory.mktemp("j")),
                               verbose=False, write_outputs=False)
    port_res = run_pipeline(p, outdir=str(tmp_path_factory.mktemp("t")),
                            device="cpu", verbose=False, write_outputs=False)
    return p, jax_res, port_res


def test_scaledep_recompute_pipeline_matches_jax(runs):
    p, jax_res, port_res = runs
    assert port_res["fmax"].host_products.segments is not None
    mh = p.MinHaloMass
    for s, m in zip(jax_res["frag"].catalogs, port_res["frag"].catalogs):
        assert s.z == m.z
        ns, nm = int((s.mass >= mh).sum()), int((m.mass >= mh).sum())
        assert ns > 0
        assert abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)
    s, m = jax_res["frag"].catalogs[-1], port_res["frag"].catalogs[-1]
    by_name = dict(zip(s.name.tolist(), s.mass.tolist()))
    same = sum(1 for nm, ms in zip(m.name.tolist(), m.mass.tolist())
               if by_name.get(nm) == ms)
    assert same / len(s.name) > 0.97
    bins = np.arange(1, 5, 0.2)
    hs, _ = np.histogram(np.log10(s.mass), bins=bins)
    hm, _ = np.histogram(np.log10(m.mass), bins=bins)
    big = hs > 100
    assert big.any()
    assert np.abs(hm[big] / hs[big] - 1.0).max() < 0.03
