"""TABULATED_CT / ELL_SNG in the PyTorch port against the JAX package.

Tolerances:
- delta_sampling, spline_d2, the aux map and the CT table file: identical.
- The three lookups, on JAX's tables and the same eigenvalues: within
  1e-5 max(1, |F|) of JAX on every cell inside the table (measured
  <= 4e-7).  At the edges and beyond, the lookups extrapolate and the
  float32 formula cancels: XLA fuses multiply-adds where the port rounds
  each product, and extrapolation amplifies that (up to 2e-4 relative a
  few bins out, far more further out).  There the K3 rule of
  test_torch_collapse.py applies: the 1e-5 tolerance on 99.9 % of the
  cells that float32 resolves (a float64 evaluation of the same formulas,
  JAX and the port on inputs moved by an ulp all within a quarter of it),
  and the port within four times that rounding spread plus the tolerance
  of float64 on 99.8 % of all cells.
- collapse_update_table on the Hessian batches of torch_hessians.py:
  test_torch_collapse.py's _held rule with the K3 tolerance 1e-4.
- fmax_loop_tab on JAX's delta(k) and tables: Fmax within
  1e-4 max(1, |F|) on 99.99 % of the resolved cells, Rmax equal on 99.9 %,
  the grid variance within 1e-5 (test_torch_pipeline.py's rule).
- The port's classic table build: within 1e-4 max(1, |F|) of JAX's on the
  nodes that float32 resolves (float32 ell_classic cancels at large |a1|).
- SNG: the port's entries on 20 nodes equal the shared solver's.
- End to end at 64^3 (ct_interp bicubic): halo counts per output within
  max(5, 0.5 %), over 97 % of the final halos identical in name and mass,
  mass-function bins of more than 100 halos within 3 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu import fmax as jfmax
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.ops import collapse as jcol
from pinocchio_tpu.ops import derivatives as jder
from pinocchio_tpu.ops import tabulated as jtab
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu_torch import fmax
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.ops import collapse, tabulated
from pinocchio_tpu_torch.run import run_pipeline
from test_torch_collapse import _held, _hessians, _perturbed
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

TOL = 1e-5
VARIANTS = ("trilinear", "bilinear", "bicubic")


def _params(n=32, **kw):
    """(the JAX package's Params, the port's) of one configuration."""
    return params_pair(**bench_kwargs(n, **kw))


@pytest.fixture(scope="module")
def jsetup():
    """The JAX package's Params, Cosmology and ladder."""
    jp = _params()[0]
    jcosmo = JaxCosmology(jp)
    return jp, jcosmo, jfmax.Smoothing.build(jp, jcosmo)


@pytest.fixture(scope="module")
def setup(jsetup):
    """The port's Params, Cosmology and ladder, and the JAX package's
    tables."""
    jp, jcosmo, jsm = jsetup
    p = _params()[1]
    cosmo = Cosmology(p)
    sm = fmax.Smoothing.build(p, cosmo)
    return p, cosmo, sm, jtab.build_ct_tables_all(jcosmo, jsm)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_F(ct, ism, interp, ls, dtype=torch.float32):
    """The port's plain lookup on JAX's tables of radius ism."""
    return tabulated.interp_F(
        interp, _t(ct["tables"][ism]).to(dtype),
        _t(ct["tables2"][ism]).to(dtype), _t(ct["dv"]).to(dtype),
        _t(ct["idx_map"]), torch.tensor(ct["ampl"][ism]),
        *[_t(x).to(dtype) for x in ls]).numpy()


def _jax_F(ct, ism, interp, ls):
    fn = jax.jit(jtab.interp_F, static_argnums=0)
    return np.asarray(fn(interp, jnp.asarray(ct["tables"][ism]),
                         jnp.asarray(ct["tables2"][ism]),
                         jnp.asarray(ct["dv"]), jnp.asarray(ct["idx_map"]),
                         jnp.float32(ct["ampl"][ism]),
                         *[jnp.asarray(x) for x in ls]))


def _eigen(d, x, y, ampl):
    """float32 eigenvalue triples of normalized (delta, x, y)."""
    return [((d + 2 * x + y) / 3 * ampl).astype(np.float32),
            ((d - x + y) / 3 * ampl).astype(np.float32),
            ((d - x - 2 * y) / 3 * ampl).astype(np.float32)]


def test_delta_grid_splines_and_aux_map_identical(setup):
    _, _, _, ct = setup
    dv = tabulated.delta_sampling()
    np.testing.assert_array_equal(dv, jtab.delta_sampling())
    np.testing.assert_array_equal(tabulated.aux_index_map(dv),
                                  ct["idx_map"])
    np.testing.assert_array_equal(tabulated.spline_d2(ct["tables"], dv),
                                  ct["tables2"])


def test_ct_table_file_round_trip(setup, jsetup, tmp_path):
    p, _, sm, ct = setup
    jp, _, jsm = jsetup
    mine, theirs = tmp_path / "port.ct", tmp_path / "jax.ct"
    tabulated.write_ct_table_file(mine, p, sm, ct["tables"])
    jtab.write_ct_table_file(theirs, jp, jsm, ct["tables"])
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(
        tabulated.read_ct_table_file(theirs, p, sm), ct["tables"])
    np.testing.assert_array_equal(
        jtab.read_ct_table_file(mine, jp, jsm),
        tabulated.read_ct_table_file(mine, p, sm))
    with pytest.raises(ValueError, match="header mismatch"):
        tabulated.read_ct_table_file(mine, _params(16)[1], sm)


@pytest.mark.parametrize("interp", VARIANTS)
def test_lookups_match_jax(setup, interp):
    _, _, sm, ct = setup
    rng = np.random.default_rng(7)
    n = 40000
    dv = ct["dv"]
    for ism in (0, sm.n // 2, sm.n - 1):
        ampl = ct["ampl"][ism]
        # the table and its surroundings (to half a bin of delta and a few
        # bins of x and y beyond the edges), then far beyond
        for lo_d, hi_d, lo_x, hi_x, min_resolved in (
                (dv[0] - 0.5, dv[-1] + 0.5, -0.3, 3.8, 0.9),
                (-12.0, 14.0, -1.5, 6.0, 0.4)):
            d = rng.uniform(lo_d, hi_d, n)
            x = rng.uniform(lo_x, hi_x, n)
            y = rng.uniform(lo_x, hi_x, n)
            ls = _eigen(d, x, y, ampl)
            got = _port_F(ct, ism, interp, ls)
            want = _jax_F(ct, ism, interp, ls)
            inside = ((d >= dv[0]) & (d <= dv[-1]) & (x >= 0) & (y >= 0)
                      & (x <= 3.4) & (y <= 3.4))
            err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
            assert err[inside].max() <= TOL, (ism, err[inside].max())
            ref = _port_F(ct, ism, interp, ls, torch.float64)
            noisy = _perturbed(lambda *c: _port_F(ct, ism, interp, c), ls,
                               copies=4)
            tol = TOL * np.maximum(1.0, np.abs(ref))
            noise = np.max([np.abs(v - ref) for v in noisy]
                           + [np.abs(want - ref)], axis=0)
            resolved = noise <= 0.25 * tol
            assert resolved.mean() >= min_resolved
            assert np.mean((np.abs(got - want) <= tol)[resolved]) >= 0.999
            assert np.mean(np.abs(got - ref) <= 4 * noise + tol) >= 0.998


@pytest.mark.parametrize("interp", VARIANTS)
def test_collapse_update_table_matches_jax(setup, interp):
    _, _, sm, ct = setup
    d, n_generic = _hessians()
    n = d.shape[1]
    ism = sm.n // 2
    args = [ct["tables"][ism], ct["tables2"][ism], ct["dv"], ct["idx_map"]]
    rng = np.random.default_rng(4)
    F0 = rng.uniform(-10.0, 4.0, n).astype(np.float32)
    R0 = rng.integers(-1, 5, n).astype(np.int32)
    jF, jR, jm, jv = jcol.collapse_update_table(
        jnp.asarray(d.reshape(6, 1, 1, n)), jnp.asarray(F0.reshape(1, 1, n)),
        jnp.asarray(R0.reshape(1, 1, n)), 7, jnp.asarray(args[0]),
        jnp.asarray(args[2]), jnp.asarray(args[3]),
        jnp.float32(ct["ampl"][ism]), ct_tab2=jnp.asarray(args[1]),
        interp=interp)
    jF, jR = np.asarray(jF).ravel(), np.asarray(jR).ravel()
    Ft, Rt = torch.from_numpy(F0.copy()), torch.from_numpy(R0.copy())
    means = collapse.collapse_update_table(
        torch.from_numpy(d), Ft, Rt, 7, *[_t(a) for a in args],
        ct["ampl"][ism], interp)

    def F_of(dd, dtype=torch.float32):
        l1, l2, l3, fail = collapse.eigenvalues_descending(dd)
        F = tabulated.interp_F(
            interp, *[_t(a).to(dtype) if a.dtype == np.float32 else _t(a)
                      for a in args], torch.tensor(ct["ampl"][ism]),
            l1, l2, l3)
        return torch.where(fail, -10.0, F).numpy()

    F64 = F_of(torch.from_numpy(d).double(), torch.float64)
    noisy = [np.maximum(F0, x) for x in _perturbed(
        lambda *c: F_of(torch.stack(c)), list(d), copies=4)]
    # the near-isotropic batch: rounding alone decides its fail branch
    # (test_torch_collapse.py holds it separately)
    keep = np.ones(n, bool)
    keep[n_generic + 512:n_generic + 768] = False
    _held(Ft.numpy()[keep], jF[keep], np.maximum(F0, F64)[keep],
          [x[keep] for x in noisy], 0.95)
    agree = np.abs(Ft.numpy() - jF) <= 1e-6
    assert np.mean(Rt.numpy()[agree] == jR[agree]) >= 0.9999
    assert abs(means[0].item() - float(jm)) <= 1e-5 * max(1.0, abs(float(jm)))
    assert abs(means[1].item() / float(jv) - 1.0) <= 1e-5


@pytest.fixture(scope="module")
def jax_delta(jsetup):
    from pinocchio_tpu import ic as jic
    from pinocchio_tpu.grids import Grid as JGrid
    p, cosmo, _ = jsetup
    return jic.generate_kdensity(JGrid(N=p.GridSize, BoxSize=p.BoxSize_htrue),
                                 cosmo, p.RandomSeed)


@pytest.mark.parametrize("interp", VARIANTS)
def test_fmax_loop_tab_matches_jax(setup, jax_delta, interp):
    p, _, sm, ct = setup
    N = p.GridSize
    radii_grid = (sm.radii / (p.BoxSize_htrue / N)).astype(np.float32)
    jF, jR, _, jvar, _ = jfmax.fmax_loop_tab(
        jax_delta, jnp.asarray(radii_grid), jnp.asarray(ct["tables"]),
        jnp.asarray(ct["dv"]), jnp.asarray(ct["idx_map"]),
        jnp.asarray(ct["ampl"]), N, sm.n,
        ct_tabs2=jnp.asarray(ct["tables2"]), interp=interp)
    jF, jR = np.asarray(jF), np.asarray(jR)
    state = fmax.load_jax_state(dict(kdensity=np.asarray(jax_delta), **ct),
                                "cpu")
    tF, tR, stats, _ = fmax.fmax_loop_tab(state["kdensity"], radii_grid,
                                          state, N, interp)
    # float64 and one-ulp-moved float32 lookups over JAX's own Hessians
    rng = np.random.default_rng(0)
    F64 = np.full(jF.shape, -10.0)
    moved = [np.full(jF.shape, -10.0) for _ in range(2)]
    for ism, R in enumerate(radii_grid):
        sd = np.array(jder.second_derivatives(jax_delta, jnp.float32(R), N))
        tab = [state[k][ism] for k in ("tables", "tables2")]

        def F_of(h, dtype):
            Fg = torch.full(h.shape[1:], -20.0, dtype=h.dtype)
            Rg = torch.zeros(h.shape[1:], dtype=torch.int32)
            collapse.collapse_update_table_plain(
                h, Fg, Rg, 0, tab[0].to(dtype), tab[1].to(dtype),
                state["dv"].to(dtype), state["idx_map"],
                ct["ampl"][ism], interp)
            return Fg.numpy()

        F64 = np.maximum(F64, F_of(torch.from_numpy(sd).double(),
                                   torch.float64))
        for i in range(2):
            sdm = (sd * (1.0 + 2.0 ** -23 * rng.choice([-1.0, 1.0], sd.shape))
                   ).astype(np.float32)
            moved[i] = np.maximum(moved[i], F_of(torch.from_numpy(sdm),
                                                 torch.float32))
    tol = 1e-4 * np.maximum(1.0, np.abs(jF))
    noise = np.max([np.abs(x - F64) for x in moved] + [np.abs(jF - F64)],
                   axis=0)
    resolved = noise <= 0.25 * tol
    assert resolved.mean() >= 0.95
    assert np.mean((np.abs(tF.numpy() - jF) <= tol)[resolved]) >= 0.9999
    assert np.mean(tR.numpy() == jR) >= 0.999
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(jvar),
                               rtol=1e-5)


def test_spline_variant_needs_tables2(setup):
    _, _, _, ct = setup
    state = fmax.load_jax_state(
        {k: ct[k] for k in ("tables", "dv", "idx_map", "ampl")}, "cpu")
    delta = torch.zeros((8, 8, 5), dtype=torch.complex64)
    with pytest.raises(ValueError, match="second-derivative"):
        fmax.fmax_loop_tab(delta, np.zeros(1, np.float32), state, 8,
                           "bicubic")
    sd = torch.zeros((6, 4, 4, 4))
    with pytest.raises(ValueError, match="tab2"):
        collapse.collapse_update_table(
            sd, torch.zeros(4, 4, 4), torch.zeros(4, 4, 4, dtype=torch.int32),
            0, state["tables"][0], None, state["dv"], state["idx_map"], 1.0,
            "bilinear")


def test_classic_table_build_matches_jax_on_resolved_nodes(setup):
    _, cosmo, sm, ct = setup
    mine = tabulated.build_ct_tables_all(cosmo, sm)
    np.testing.assert_array_equal(mine["idx_map"], ct["idx_map"])
    np.testing.assert_array_equal(mine["ampl"], ct["ampl"])
    for ism in (0, sm.n // 2, sm.n - 1):
        ls = tabulated.node_eigenvalues(float(np.sqrt(sm.variance[ism])))
        bc = collapse.ell_classic(*[torch.from_numpy(x) for x in ls]).numpy()
        F64 = np.where(bc > 0.0, 1.0 + cosmo.InverseGrowingMode(
            np.maximum(bc, 1e-30)), 0.0)
        want = ct["tables"][ism].ravel()
        got = mine["tables"][ism].ravel()
        tol = 1e-4 * np.maximum(1.0, np.abs(F64))
        resolved = np.abs(want - F64) <= 0.25 * tol
        assert resolved.mean() >= 0.9
        assert np.mean((np.abs(got - want) <= tol)[resolved]) >= 0.999


def test_sng_entries_match_the_shared_solver(setup, jsetup):
    """The port's copy of the SNG solver (ops/sng.py) gives the JAX
    package's entries."""
    from pinocchio_tpu.ops.sng import ell_sng_F
    _, cosmo, sm, _ = setup
    jcosmo = jsetup[1]
    ls = tabulated.node_eigenvalues(float(np.sqrt(sm.variance[sm.n // 2])))
    nodes = np.random.default_rng(3).choice(ls[0].size, 20, replace=False)
    sub = [x[nodes] for x in ls]
    got = tabulated.ct_entries(cosmo, *sub, model="sng")
    D_in = float(jcosmo.GrowingMode(1.0 / 1.e-5 - 1.0))
    np.testing.assert_array_equal(got, ell_sng_F(*sub, D_in, jcosmo))
    assert (got > 0).any()


def test_prepare_ct_tables_sng_reads_the_file_without_solving(
        setup, jsetup, tmp_path, monkeypatch):
    from pinocchio_tpu.ops import sng as jsng
    from pinocchio_tpu_torch.ops import sng
    p, cosmo, sm, ct = setup
    _, jcosmo, jsm = jsetup
    path = str(tmp_path / "sng.ct")
    tabulated.write_ct_table_file(path, p, sm, ct["tables"])

    def no_solve(*a, **k):
        raise AssertionError("the SNG solver ran")

    monkeypatch.setattr(sng, "ell_sng_F", no_solve)
    monkeypatch.setattr(jsng, "ell_sng_F", no_solve)
    jps, ps = _params(ell_model="sng", CTtableFile=path)
    got = fmax.prepare_ct_tables(ps, cosmo, sm, verbose=False)
    want = jfmax.prepare_ct_tables(jps, jcosmo, jsm, verbose=False)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jp, p = _params(64, ell_model="tabulated", ct_interp="bicubic")
    jax_res = jax_run_pipeline(jp, outdir=str(tmp_path_factory.mktemp("j")),
                               verbose=False, write_outputs=False)
    port_res = run_pipeline(p, outdir=str(tmp_path_factory.mktemp("t")),
                            device="cpu", verbose=False, write_outputs=False)
    return p, jax_res, port_res


def test_tabulated_pipeline_matches_jax(runs):
    p, jax_res, port_res = runs
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
