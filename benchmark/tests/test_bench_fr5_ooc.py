"""The cell fr5_512.ooc: f(R) with RECOMPUTE_DISPLACEMENTS on the
out-of-core engine, and its two readers.

- At 32^3 on the CPU the program is within the cell's limits and its
  control, the program's own 16-bit ledger (ooc_dtype bfloat16), is over at
  least one of them (on the card, at the cell's size,
  benchmark/calibrate.py reads them); a short traced run through the
  harness is correct and reports the cell's metrics.
- ooc_rows_device_s and gradient_tab_roofline_pct on synthetic records:
  each reads None without its input (a program that does not time its row
  phase, an untraced run, a cell that names neither gradient operation).
- On the card (``cuda``): one short run of the cell through the
  benchmark's command, correct, on the out-of-core engine.
"""

import json
import os
import subprocess
import sys

import pytest

from bench_small import SEED, run_small, small_cell
from benchmark import check, harness, roofline
from benchmark.reference import realization as R

CELL = "fr5_512.ooc"


def _over(nums: dict, limits: dict) -> list:
    return [k for k, v in nums.items() if v > limits[k]]


def test_the_cell_and_its_metrics_in_the_spec():
    spec = harness.load_spec()
    w = {w["name"]: w for w in spec["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "fr5_recompute_512_mig10", "ensemble_ooc", 1)
    cell = harness.Cell(spec, CELL)
    # the 10 GB slice's deployment runs fr5_512.dense's physics, on the
    # out-of-core engine
    dense = harness.Cell(spec, "fr5_512.dense")
    assert cell.config["params"] == dict(dense.config["params"], ooc="on")
    assert cell.params_dict()["ooc"] == "on"
    assert cell.params_dict()["recompute_displacements"] is True
    # lcdm512.ooc's operations with K14's gradient in K10's place
    ooc = set(harness.Cell(spec, "lcdm512.ooc").ops)
    assert set(cell.ops) == (ooc - {"ooc_factors_gradient"}) | {
        "ooc_factors_gradient_tab"}
    by = {m["name"]: m for m in spec["per_layer"]}
    assert by["ooc_rows_device_s"]["workloads"] == ["lcdm512.ooc", CELL]
    assert by["gradient_tab_roofline_pct"]["workloads"] == [
        "fr5_512.dense", CELL]
    for name in ("ooc_rows_device_s", "gradient_tab_roofline_pct"):
        assert by[name]["moves"] == "realization_s"
    assert (by["ooc_rows_device_s"]["layer"]
            == by["ooc_lpt_s"]["layer"] == "out-of-core engine")
    assert (by["gradient_tab_roofline_pct"]["layer"]
            == by["kernel_roofline_pct"]["layer"] == "kernels")
    reported = {m["name"] for m in cell.per_layer}
    assert {"ooc_rows_device_s", "gradient_tab_roofline_pct",
            "ooc_lpt_s"} <= reported and "lpt_device_s" not in reported


def test_control_fails_and_program_passes():
    cell = small_cell(CELL)
    system = harness.System(cell, "cpu")
    assert system.engine == "ooc" and system.scaledep_gm is not None
    p, cosmo, lad = check.reference_inputs(cell.params_dict())
    rec, prog = system.realize(SEED, keep=True)
    assert rec["nsets"] == 4 and rec["nfields"] == 4
    ref = R.Realization(p, cosmo, lad, SEED, "cpu", system.engine)
    ref.cycle()
    assert _over(check.compare(prog, ref, p.Flast), cell.limits) == []
    system.params.ooc_dtype = "bfloat16"
    _, ctrl = system.realize(SEED, keep=True)
    over = _over(check.compare(ctrl, ref, p.Flast), cell.limits)
    assert over, "the control passed every limit"


def test_small_cell_traced_is_correct(tmp_path):
    res = run_small(small_cell(CELL), tmp_path, trace=True)
    assert res["correct"] is True, res["compared"]
    # the CPU has no device trace to read and no device timing events
    assert "ooc_rows_device_s" not in res["metrics"]
    assert "gradient_tab_roofline_pct" not in res["metrics"]
    assert {"cycle_s", "ooc_lpt_s", "launches"} <= set(res["metrics"])


# ------------------------------------------------------------------
# the readers on synthetic records
# ------------------------------------------------------------------

def _reader(name):
    return harness.Cell(harness.load_spec(), CELL).reader(name)


def _run(timings, engine="ooc", trace=None, ops=(), N=512):
    recs = [dict(timings=t, nsmooth=9, nsets=4, nfields=4, count=1000)
            for t in timings]
    return dict(engine=engine, records=recs, trace=trace, N=N,
                ops=[json.load(open(os.path.join(
                    harness.BENCH, "roofline", op + ".json"))) for op in ops])


def test_rows_device_s_mean_and_none():
    read = _reader("ooc_rows_device_s")
    t = [dict(lpt=0.5, rows_device_s=0.2), dict(lpt=0.6, rows_device_s=0.4)]
    assert read(_run(t)) == pytest.approx(0.3)
    assert read(_run(t, engine="dense")) is None
    # a program from before the row events
    old = [dict(lpt=0.5, lpt_rows=0.3), dict(lpt=0.6, lpt_rows=0.35)]
    assert read(_run(old)) is None


K14 = ("void (anonymous namespace)::factors_kz_kernel<(anonymous "
       "namespace)::GradientOp<(anonymous namespace)::TableGrowth<(anonymous "
       "namespace)::LdgTable> > >(float2 const*)")
K10 = ("void (anonymous namespace)::factors_kz_kernel<(anonymous "
       "namespace)::GradientOp<(anonymous namespace)::ScalarGrowth> >"
       "(float2 const*)")
K8 = ("void (anonymous namespace)::window_kernel<true, (anonymous "
      "namespace)::GradientOp<(anonymous namespace)::TableGrowth<(anonymous "
      "namespace)::LdgTable> > >(float2 const*)")


@pytest.mark.parametrize("op,kernel", [("ooc_factors_gradient_tab", K14),
                                       ("kspace_gradient_tab", K8)])
def test_gradient_tab_roofline_pct(op, kernel):
    read = _reader("gradient_tab_roofline_pct")
    ops = ("fft", "ooc_factors_hessian", op)
    trace = dict(realizations=3, kernels={kernel: 0.5, K10: 9.0})
    run = _run([{}], trace=trace, ops=ops)
    bound = roofline.work(run["ops"][-1], roofline.shapes(run))[2]
    assert read(run) == pytest.approx(100.0 * 3 * bound / 0.5)
    # an untraced run, a cell that names neither operation, no kernel of it
    assert read(_run([{}], ops=ops)) is None
    assert read(_run([{}], trace=trace,
                     ops=("fft", "ooc_factors_gradient"))) is None
    assert read(_run([{}], trace=dict(realizations=3, kernels={K10: 1.0}),
                     ops=ops)) is None


# ------------------------------------------------------------------
# on the card
# ------------------------------------------------------------------

@pytest.mark.cuda
def test_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 13), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["device"]["platform"] == "gpu"
    assert {"setup_s", "realization_s"} <= set(out["metrics"])
    with open(os.path.join(harness.ROOT, "benchmark_out",
                           f"records-{CELL}.json")) as fd:
        recs = json.load(fd)
    assert recs["engine"] == "ooc"
    assert all(r["nsets"] == 4 for r in recs["records"])
    assert all(0.0 < r["timings"]["rows_device_s"] <= r["timings"]["lpt"]
               for r in recs["records"])
