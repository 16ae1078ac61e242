"""Collapse-time math of the PyTorch port against the JAX package.

Inputs are numpy-seeded symmetric Hessians: generic Gaussian ones plus
isotropic (the q == 0 diagonal branch), degenerate (two equal
eigenvalues), near-isotropic (where rounding trips the q^3 < r^2 fail
branch) and vanishing ones (|l1| < 1e-20).

The tolerance is the K3 one, |dx| <= 1e-4 max(1, |x|), held on the cells
where float32 resolves the formula to that accuracy.  The float32 formulas
cancel badly in a small set of cells (ell_classic's three-root branch with
|a1| ~ 1e2-1e3; near-degenerate eigenvalues under acos; the fail test
q^3 < r^2 at a double eigenvalue), and there the compiled JAX function and
the port round differently: XLA fuses multiply-adds and expands acos as
atan2, the port does neither.  A cell counts as resolved when the float64
evaluation of the same formulas, JAX's float32 result and the port's
float32 results on inputs moved by one ulp all lie within a quarter of the
tolerance of each other.  Measured here: 99.0-99.1 % of cells resolved for
the eigenvalues, 97.5 % for ell_classic and 96.6 % for F; on the resolved
cells the port agrees with JAX on all but 2.5e-5 of them; everywhere, the
port's error against float64 is at most four times JAX's plus the
tolerance on 99.9 % of cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu.ops import collapse as jcol
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.ops import collapse
from torch_hessians import SPECIAL, special_hessians
from torch_params import params_pair

PARAMS = dict(GridSize=32, BoxSize=32.0, output_z=[0.0], norad=True,
              plc_enabled=False)

torch.set_num_threads(2)

TOL = 1e-4


def _hessians():
    rng = np.random.default_rng(20261016)
    n = 40000
    scale = np.array([1.0, 1.0, 1.0, 0.5, 0.5, 0.5])[:, None]
    generic = rng.standard_normal((6, n)) * scale
    special = special_hessians(rng)
    d = np.concatenate([generic] + [special[k] for k in SPECIAL], axis=1)
    return d.astype(np.float32), n


@pytest.fixture(scope="module")
def hessians():
    return _hessians()


@pytest.fixture(scope="module")
def pack():
    return collapse.make_inverse_growth_fit(Cosmology(params_pair(**PARAMS)[1]))


def _perturbed(fn, inputs, seed=0, copies=2):
    """fn on float32 inputs moved by random relative amounts of 2^-23:
    the spread of these evaluations is the float32 rounding noise of the
    formula at each cell, independent of either implementation's luck."""
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(copies):
        moved = [torch.from_numpy((x * (1.0 + 2.0 ** -23 * rng.choice(
            [-1.0, 1.0], x.shape))).astype(np.float32)) for x in inputs]
        outs.append(np.asarray(fn(*moved), np.float64))
    return outs


def _held(port, ref_jax, ref64, noisy, min_resolved):
    """Agreement of port and JAX on the cells the float32 formula resolves
    to a quarter of the tolerance; asserts the resolved fraction, the
    agreement there, and that the port is never much further from float64
    than JAX is.  Returns (resolved fraction, agreement)."""
    port, ref_jax, ref64 = (np.asarray(x, np.float64)
                            for x in (port, ref_jax, ref64))
    tol = TOL * np.maximum(1.0, np.abs(ref_jax))
    jax_err = np.abs(ref_jax - ref64)
    noise = np.max([np.abs(x - ref64) for x in noisy] + [jax_err], axis=0)
    resolved = noise <= 0.25 * tol
    agree = np.abs(port - ref_jax) <= tol
    frac_resolved = resolved.mean()
    frac_agree = agree[resolved].mean()
    assert frac_resolved >= min_resolved, frac_resolved
    assert frac_agree >= 0.9999, frac_agree
    port_err = np.abs(port - ref64)
    assert np.mean(port_err <= 4.0 * jax_err + tol) >= 0.999
    return frac_resolved, frac_agree


def test_inverse_growth_fit_identical(pack):
    np.testing.assert_array_equal(pack, jcol.make_inverse_growth_fit(
        JaxCosmology(params_pair(**PARAMS)[0])))


def test_eigenvalues_match_jax(hessians):
    d, n = hessians
    want = [np.asarray(x) for x in
            jax.jit(jcol.eigenvalues_descending)(jnp.asarray(d))]
    got = [x.numpy() for x in
           collapse.eigenvalues_descending(torch.from_numpy(d))]
    ref = [x.numpy() for x in
           collapse.eigenvalues_descending(torch.from_numpy(d).double())]
    for i in range(3):
        noisy = _perturbed(lambda *c: collapse.eigenvalues_descending(
            torch.stack(c))[i].numpy(), list(d))
        _held(got[i], want[i], ref[i], noisy, 0.98)
    # the fail flag on generic Hessians, and the isotropic q == 0 branch
    assert np.mean(got[3][:n] == want[3][:n]) >= 0.9999
    iso = slice(n, n + 256)
    np.testing.assert_array_equal(got[0][iso], d[0, iso])
    assert not got[3][iso].any() and not want[3][iso].any()


def test_ell_classic_matches_jax(hessians):
    d, _ = hessians
    l1, l2, l3, _ = jax.jit(jcol.eigenvalues_descending)(jnp.asarray(d))
    want = np.asarray(jax.jit(jcol.ell_classic)(l1, l2, l3))
    ls = [torch.from_numpy(np.asarray(x)) for x in (l1, l2, l3)]
    got = collapse.ell_classic(*ls).numpy()
    ref = collapse.ell_classic(*[x.double() for x in ls]).numpy()
    noisy = _perturbed(lambda *c: collapse.ell_classic(*c).numpy(),
                       [x.numpy() for x in ls])
    _held(got, want, ref, noisy, 0.95)
    # vanishing Hessians never collapse
    np.testing.assert_array_equal(got[-256:], np.float32(-0.1))


def test_collapse_update_matches_jax(hessians, pack):
    d, n_generic = hessians
    n = d.shape[1]
    rng = np.random.default_rng(3)
    F0 = rng.uniform(-10.0, 4.0, n).astype(np.float32)
    R0 = rng.integers(-1, 5, n).astype(np.int32)
    # 3-D shapes: the JAX statistics reduce over the last three axes
    jF, jR, jm, jv = jcol.collapse_update(
        jnp.asarray(d.reshape(6, 1, 1, n)), jnp.asarray(F0.reshape(1, 1, n)),
        jnp.asarray(R0.reshape(1, 1, n)), 7, jnp.asarray(pack))
    jF, jR = np.asarray(jF).ravel(), np.asarray(jR).ravel()
    Ft, Rt = torch.from_numpy(F0.copy()), torch.from_numpy(R0.copy())
    means = collapse.collapse_update(torch.from_numpy(d), Ft, Rt, 7, pack)
    F64 = collapse.collapse_F(torch.from_numpy(d).double(), pack).numpy()
    noisy = [np.maximum(F0, x) for x in _perturbed(
        lambda *c: collapse.collapse_F(torch.stack(c), pack).numpy(),
        list(d), copies=6)]
    # where two eigenvalues coincide, q^3 - r^2 vanishes and rounding
    # alone decides the fail branch (JAX takes it on half the exactly
    # degenerate batch, the port on none): the near-isotropic batch is held
    # below to "fail only at a double eigenvalue" instead of cell by cell
    near = np.zeros(n, bool)
    near[n_generic + 512:n_generic + 768] = True
    keep = ~near
    _held(Ft.numpy()[keep], jF[keep], np.maximum(F0, F64)[keep],
          [x[keep] for x in noisy], 0.95)
    l1, l2, l3, fail = (x.numpy() for x in collapse.eigenvalues_descending(
        torch.from_numpy(d).double()))
    gap = np.minimum(l1 - l2, l2 - l3) / np.maximum(1.0, np.abs(l1))
    port_fail = collapse.eigenvalues_descending(torch.from_numpy(d))[3]
    jax_fail = jcol.eigenvalues_descending(jnp.asarray(d))[3]
    for f in (port_fail.numpy(), np.asarray(jax_fail)):
        assert np.all(gap[f] < 1e-2)
    # Rmax follows the strict running max: equal wherever F agrees
    agree = np.abs(Ft.numpy() - jF) <= 1e-6
    assert np.mean(Rt.numpy()[agree] == jR[agree]) >= 0.9999
    g = slice(0, n_generic)
    assert np.mean(Rt.numpy()[g] == jR[g]) >= 0.999
    assert abs(means[0].item() - float(jm)) <= 1e-5 * max(1.0, abs(float(jm)))
    assert abs(means[1].item() / float(jv) - 1.0) <= 1e-5


def test_collapse_update_tie_keeps_earlier_radius(hessians, pack):
    d, _ = hessians
    dt = torch.from_numpy(d)
    F = collapse.collapse_F(dt, pack)
    Fmax, Rmax = F.clone(), torch.full_like(F, 3, dtype=torch.int32)
    collapse.collapse_update(dt, Fmax, Rmax, 9, pack)
    assert torch.equal(Fmax, F)
    assert bool((Rmax == 3).all())
