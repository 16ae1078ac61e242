"""The benchmark loads nothing of JAX or of the JAX package, and its plain
reference nothing of the program: loaded modules compared by their whole
top-level name (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pinocchio_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=harness.ROOT))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    code = ("import benchmark.harness, benchmark.check, benchmark.trace, "
            "benchmark.roofline, benchmark.traffic, benchmark.calibrate\n"
            "import pinocchio_tpu_torch.fmax, pinocchio_tpu_torch.fmax_ooc, "
            "pinocchio_tpu_torch.planner, pinocchio_tpu_torch.scaledep, "
            "pinocchio_tpu_torch.io.catalogs\n"
            "from benchmark import harness\n"
            "c = harness.Cell(harness.load_spec(), 'fr5_512.dense')\n"
            "[c.reader(m['name']) for m in c.end_to_end + c.per_layer]\n")
    loaded = _loaded(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "pinocchio_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import benchmark.check, "
                     "benchmark.reference.realization, "
                     "benchmark.reference.cosmology, "
                     "benchmark.reference.scaledep, benchmark.reference.config")
    assert not loaded & (FORBIDDEN | {"pinocchio_tpu_torch"}), loaded


def test_run_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "pinocchio_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pinocchio_tpu.fmax", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["jaxlib", "pinocchio_tpu"]


def test_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lcdm512.dense",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    tmp_path / "benchmark")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lcdm512.dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0 and res.stdout.strip() == ""
