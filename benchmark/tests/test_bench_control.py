"""The control of each cell comes out as not correct under the cell's own
limits, at a size a test run holds (on the card, at the cell's size,
benchmark/calibrate.py reads it): the nearest precision below the
configuration's in the program's place.  On the out-of-core engine that is
the program's own 16-bit ledger (ooc_dtype bfloat16); on the dense engine
the reference with every stored field rounded to bfloat16."""

import json

import pytest
import torch

from bench_small import SEED, small_cell
from benchmark import calibrate, check, harness
from benchmark.reference import realization as R


def _over(nums: dict, limits: dict) -> list:
    return [k for k, v in nums.items() if v > limits[k]]


@pytest.mark.parametrize("name", ["lcdm512.dense", "fr5_512.dense",
                                  "lcdm512.ooc"])
def test_control_fails_and_program_passes(name):
    cell = small_cell(name)
    system = harness.System(cell, "cpu")
    p, cosmo, lad = check.reference_inputs(cell.params_dict())
    _, prog = system.realize(SEED, keep=True)
    ref = R.Realization(p, cosmo, lad, SEED, "cpu", system.engine)
    ref.cycle()
    assert _over(check.compare(prog, ref, p.Flast), cell.limits) == []
    if system.engine == "ooc":
        system.params.ooc_dtype = "bfloat16"
        _, ctrl = system.realize(SEED, keep=True)
    else:
        low = R.Realization(p, cosmo, lad, SEED, "cpu", system.engine,
                            store="bfloat16")
        low.cycle()
        ctrl = check.products_of(low, p.Flast)
    over = _over(check.compare(ctrl, ref, p.Flast), cell.limits)
    assert over, "the control passed every limit"


def test_calibrate_reads_the_three_kinds(tmp_path, capsys):
    out = tmp_path / "calib.jsonl"
    assert calibrate.main(["--workload", "lcdm512.dense", "--seed", "5",
                           "--seeds", "2", "--controls", "1", "--float64",
                           "1", "--device", "cpu", "--grid", "32",
                           "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    kinds = [x["kind"] for x in lines]
    assert kinds.count("program") == 2 and "control" in kinds
    assert "float64" in kinds and kinds[-1] == "summary"
    summary = lines[-1]
    assert summary["program_F_off"] < summary["float64_F_off"] \
        < summary["control_F_off"]


def test_hist_envelope_admits_rounding_and_not_a_shift():
    """hist_off reads 0 for every Fmax within F_off's tolerance of the
    reference's, cell by cell (a sound change of rounding), and more than 0
    for the counts of Fmax moved past it."""
    g = torch.Generator().manual_seed(5)
    Fref = torch.rand(1 << 18, generator=g) * 4.0
    Fref[:1000] = -10.0
    noise = torch.randn(Fref.shape, generator=g).clamp(-3, 3) / 3
    rounded = Fref + 0.9 * check.F_TOL * noise
    assert check.hist_outside(R.pdf_hist(rounded), Fref) == 0
    assert check.hist_outside(R.pdf_hist(Fref + 0.05), Fref) > 1e-3
