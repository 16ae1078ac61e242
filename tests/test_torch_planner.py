"""The port's memory planner and its self-containment, on the CPU.

The dense model is held to the peaks measured on an H100 80GB HBM3 at
256^3 (PERF.md section 5: 2.83 GiB classic, 4.25 GiB f(R) scale-dependent
growth with RECOMPUTE_DISPLACEMENTS, with the hand-off's rank field) within
15 %; the engine choice under
'auto' for an 80 GB card is dense at 512^3 and out-of-core at 1024^3; a grid
that no engine fits aborts with the per-array map.  The port's copies of
the jax-free modules give the JAX package's numbers.
"""

import dataclasses

import numpy as np
import pytest

from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu_torch import planner
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from torch_params import bench_kwargs, params_pair

CARD = 80e9


@pytest.fixture
def card(monkeypatch):
    """An 80 GB card, whatever this machine has."""
    monkeypatch.setattr(planner, "device_memory", lambda device: CARD)
FR = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,
          recompute_displacements=True, MaxMemPerParticle=400)


@pytest.mark.parametrize("kw,measured", [({}, 2.83), (FR, 4.25)])
def test_dense_model_matches_the_measured_peaks(kw, measured):
    p = Params(**bench_kwargs(256, **kw))
    peak = planner.device_peak(p, ooc=False)["peak"] / planner.GiB
    assert abs(peak / measured - 1.0) <= 0.15, peak


@pytest.mark.parametrize("n,ooc", [(512, False), (1024, True)])
def test_auto_selects_ooc_only_when_dense_does_not_fit(card, n, ooc):
    p = Params(**bench_kwargs(n), ooc="auto")
    assert planner.ooc_selected(p, "cuda") is ooc
    rep = planner.plan(p, "cuda")
    assert rep["fits_device"]
    assert rep["ooc"]["peak"] < rep["dense"]["peak"]


def test_ooc_on_and_off_are_obeyed(card):
    for mode, want in (("on", True), ("off", False)):
        p = Params(**bench_kwargs(64), ooc=mode)
        assert planner.ooc_selected(p, "cuda") is want


def test_no_engine_fits_aborts_with_the_map(card):
    p = Params(**bench_kwargs(4096), ooc="auto")
    with pytest.raises(planner.MemoryPlanError) as err:
        planner.enforce_budget(p, "cuda", verbose=False)
    msg = str(err.value)
    assert "exceeds the device" in msg and "RUN PLAN for 4096^3" in msg
    assert "needed_sort" in msg and "out-of-core engine" in msg


def test_dense_forced_beyond_the_card_aborts(card):
    p = Params(**bench_kwargs(1024), ooc="off")
    with pytest.raises(planner.MemoryPlanError, match="set ooc"):
        planner.enforce_budget(p, "cuda", verbose=False)


def test_ooc_ledger_at_1024():
    """The out-of-core phases at 1024^3: every phase under the card, the
    needed-order sort the largest, the rows of one field about 7.7 GiB."""
    p = Params(**bench_kwargs(1024))
    d = planner.device_peak(p, ooc=True)
    tot = {k: sum(v.values()) / planner.GiB for k, v in d["phases"].items()}
    assert set(tot) == {"cycle", "sources", "fold", "needed sort",
                        "v-streams"}
    assert max(tot.values()) < CARD / planner.GiB
    assert 24.0 < tot["cycle"] < 32.0
    rows = d["phases"]["v-streams"]["rows_of_one_field"] / planner.GiB
    assert 7.0 < rows < 8.5
    assert abs(d["frac"] - 0.64) < 0.02


def test_host_estimate_counts_the_rows():
    p = Params(**bench_kwargs(1024))
    frac = 0.64
    host = planner.host_sweep_bytes(p, frac) / planner.GiB
    rows = frac * 1024 ** 3 * 48 / planner.GiB        # 4 fields x 12 B
    assert rows < host < 3 * rows


def test_host_map_counts_the_snapshot_and_the_plc():
    """With the timeless snapshot the whole grid's products (Fmax, Rmax and
    four stacks: 56 B per cell at 3LPT) are on the host from fmax on, and
    its writer adds 32 B per cell; the PLC adds its 4 Nmax crossings of
    40 B to the sweep; special mode 3 has no sweep, and its writer adds
    44 B per cell."""
    p = Params(**bench_kwargs(256))
    frac, cells = 0.66, 256 ** 3
    base = planner.host_phases(p, frac)
    assert set(base) == {"fmax", "sweep"}
    assert "dense_products" not in base["fmax"]
    snap = planner.host_phases(
        dataclasses.replace(p, WriteTimelessSnapshot=True), frac)
    assert snap["fmax"]["dense_products"] == 56.0 * cells
    assert snap["snapshot"]["timeless_writer"] == 32.0 * cells
    cone = planner.host_phases(
        dataclasses.replace(p, plc_enabled=True, StartingzForPLC=0.3), frac)
    assert cone["sweep"]["plc_buffers"] == 160.0 * int(cells / 6 * 0.8)
    mode3 = planner.host_phases(p, frac, dense_products=True)
    assert set(mode3) == {"fmax", "snapshot"}
    assert mode3["snapshot"]["lpt_writer"] == 44.0 * cells
    rep = planner.plan(p, "cpu", dense_products=True)
    assert rep["host"]["phase"] == "snapshot"


def test_port_cosmology_equals_the_jax_package():
    jp, p = params_pair(**bench_kwargs(64))
    jc, c = JaxCosmology(jp), Cosmology(p)
    k = np.logspace(-3, 1, 50)
    for name in ("PowerSpectrum",):
        np.testing.assert_array_equal(getattr(c, name)(k),
                                      getattr(jc, name)(k))
    for z in (0.0, 0.5, 2.0):
        for fn in ("GrowingMode", "GrowingMode_2LPT", "GrowingMode_3LPT_1",
                   "GrowingMode_3LPT_2"):
            assert getattr(c, fn)(z) == getattr(jc, fn)(z)
    np.testing.assert_array_equal(c.sp_grow1.x, jc.sp_grow1.x)
    np.testing.assert_array_equal(c.sp_grow1.y, jc.sp_grow1.y)
    for r in (0.5, 2.0, 8.0):
        assert c.var_gauss.MassVariance(r) == jc.var_gauss.MassVariance(r)


@pytest.mark.parametrize("ntasks", [2, 4, 8])
def test_subbox_plan_matches_jax(ntasks):
    """The sub-box decomposition in the plan (nbox and the padded volumes
    over N^3) equals the JAX planner's for the same sub-box count."""
    from pinocchio_tpu import planner as jplanner
    jp, p = params_pair(**bench_kwargs(128, subbox_tasks=ntasks))
    want = jplanner.plan(jp, subboxes=ntasks, verbose=False,
                         cosmo=JaxCosmology(jp))
    rep = planner.plan(p, "cpu")
    assert rep["nbox"] == tuple(want["nbox"])
    assert rep["boundary_overhead"] == want["boundary_overhead"]
    assert "sub-boxes" in planner.format_memory_map(rep)


def test_host_map_counts_each_swept_sub_box():
    """Each sub-box swept at once adds its row map (4 B per padded cell),
    its stored particles' arrays and groups and, with the PLC, its own
    4 Nmax crossing buffers; the products are counted once; the boxes
    beyond the pool's threads keep only their results."""
    p = dataclasses.replace(Params(**bench_kwargs(256, subbox_tasks=8)),
                            plc_enabled=True, StartingzForPLC=0.3)
    cosmo = Cosmology(p)
    sub = planner.subbox_plan(p, cosmo)
    geoms, frac = sub["geoms"], 0.66
    padded = sum(float(np.prod(g.L)) for g in geoms)
    assert len(geoms) == 8 and not sub["two_turn"]
    assert sub["boundary_overhead"] == padded / 256 ** 3
    one = planner.host_phases(p, frac)["sweep"]
    all8 = planner.host_phases(p, frac, geoms=geoms, workers=8)["sweep"]
    assert all8["row_map"] == 4.0 * padded
    assert all8["plc_buffers"] == 8 * one["plc_buffers"]
    assert all8["rows"] == one["rows"]
    assert all8["sweep_arrays"] == pytest.approx(24.0 * frac * padded)
    two = planner.host_phases(p, frac, geoms=geoms, two_turn=True,
                              workers=8)["sweep"]
    assert two["turn_masks"] == 3.0 * padded
    four = planner.host_phases(p, frac, geoms=geoms, workers=4)["sweep"]
    assert four["plc_buffers"] == 4 * one["plc_buffers"]
    assert four["finished_boxes"] > 0
    assert sum(four.values()) < sum(all8.values())
