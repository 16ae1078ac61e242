"""On the card: one short run of each cell through the benchmark's
command, with its result line and its correctness (python -m pytest -m cuda
benchmark/tests on the H100)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lcdm512.dense", "fr5_512.dense",
                                  "lcdm512.ooc"])
def test_cell_runs_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["device"]["platform"] == "gpu"
    assert {"setup_s", "realization_s"} <= set(out["metrics"])
