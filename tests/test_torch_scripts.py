"""The port's twins of the JAX package's user scripts, on the CPU:
scripts/torch_plot_example.py (plot_example.py), torch_hmf_validation.py
(hmf_validation.py) and torch_make_camb_inputs.py (make_camb_inputs.py,
whose files tests/test_torch_camb.py holds to the JAX script's).

- The plot twin writes mf.png and lss.png from a port run's files, and
  plc.png only where the run wrote a PLC catalog; its PNGs are byte for
  byte those of the JAX script (run in a subprocess) on the same files.
- The HMF twin at --grid 32 --device cpu writes VALIDATION_log.txt, one
  line per output, whose residuals equal mean |n/n_fit - 1| over the bins
  with halos recomputed from its .mf.out files; without the reference's
  mass functions it compares no counts and prints "plotting skipped";
  with them (here a copy of the run's own, under any RunFlag) it adds the
  counts' difference and draws the figure; without a card and without
  --device cpu it raises.
- The three twins' main run on a 16^3 CPU run in a process that imports
  neither jax nor any module of the JAX package.
"""

import contextlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLC = dict(plc_enabled=True, StartingzForPLC=0.05, LastzForPLC=0.0,
           PLCAperture=30.0, PLCProvideConeData=True)


def _script(name):
    """The module of scripts/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(main, argv):
    """main(argv) -> (its return value, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def _write_parameter_file(d, n, plc=False):
    (d / "outputs").write_text("2.0\n1.0\n0.5\n0.0\n")
    pf = d / "parameter_file"
    pf.write_text(f"GridSize {n}\nBoxSize {float(n)}\n" + (
        "StartingzForPLC 0.05\nLastzForPLC 0.0\nPLCAperture 30\n"
        "PLCProvideConeData\n" if plc else ""))
    return pf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (a port run's directory with its parameter file, Params):
    32^3 with and without the past light cone."""
    out = {}
    for name, kw in (("plain", {}), ("plc", PLC)):
        d = tmp_path_factory.mktemp(f"plot_{name}")
        p = Params(**dict(bench_kwargs(32), **kw))
        run_pipeline(p, outdir=str(d), device="cpu", verbose=False)
        _write_parameter_file(d, 32, plc=bool(kw))
        out[name] = (d, p)
    return out


@pytest.mark.parametrize("name", ["plain", "plc"])
def test_plot_twin_writes_the_jax_scripts_pngs(runs, name, tmp_path):
    d, _ = runs[name]
    pngs = ["mf.png", "lss.png"] + (["plc.png"] if name == "plc" else [])
    code, printed = _call(_script("torch_plot_example").main,
                          [str(d / "parameter_file"), "--outdir", str(d)])
    assert code == 0
    assert printed.strip() == "wrote " + ", ".join(pngs)
    assert sorted(f for f in os.listdir(d) if f.endswith(".png")) == \
        sorted(pngs)
    mine = {f: (d / f).read_bytes() for f in pngs}
    for f in pngs:
        os.remove(d / f)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "plot_example.py"),
         str(d / "parameter_file"), "--outdir", str(d)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout == printed
    for f in pngs:
        assert (d / f).read_bytes() == mine[f], f


def test_hmf_twin_logs_the_residual_of_each_output(tmp_path):
    out = tmp_path / "hmf"
    code, printed = _call(_script("torch_hmf_validation").main,
                          ["--grid", "32", "--device", "cpu",
                           "--outdir", str(out)])
    assert code == 0
    assert "plotting skipped" in printed
    assert "halo count vs reference" not in printed
    lines = (out / "VALIDATION_log.txt").read_text().splitlines()
    zs = [2.0, 1.0, 0.5, 0.0]
    assert len(lines) == len(zs)
    for z, line in zip(zs, lines):
        mf = np.loadtxt(out / f"pinocchio.{z:6.4f}.run.mf.out")
        sel = mf[:, 4] > 0
        assert sel.any()
        want = np.abs(mf[sel, 1] / mf[sel, 5] - 1.0).mean()
        assert line == (f"z={z:6.4f}: HMF Average Residual vs Watson fit: "
                        f"{want:.5g}")
        assert line in printed
    assert not (out / "HMF_Validation_with_Watson_fit.png").exists()


@pytest.mark.parametrize("run_flag", ["run", "test"])
def test_hmf_twin_against_reference_files(tmp_path, run_flag):
    """validate_run on a finished run, the reference's directory holding
    the same mass functions: every count within +0.00 %, the figure
    drawn; the file names follow RunFlag."""
    hmf = _script("torch_hmf_validation")
    p = hmf.validation_params(16)
    p.RunFlag = run_flag
    out = tmp_path / "run"
    out.mkdir()
    run_pipeline(p, outdir=str(out), device="cpu", verbose=False)
    ref = tmp_path / "reference"
    ref.mkdir()
    for z in p.output_z:
        f = f"pinocchio.{z:6.4f}.{run_flag}.mf.out"
        shutil.copy(out / f, ref / f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = hmf.validate_run(str(out), p, str(ref))
    assert [r[0] for r in rows] == p.output_z
    assert all(r[2] == 0.0 for r in rows)
    assert buf.getvalue().count("halo count vs reference: +0.00%") == 4
    assert "plotting skipped" not in buf.getvalue()
    assert (out / hmf.FIGURE).exists()
    log = (out / "VALIDATION_log.txt").read_text().splitlines()
    assert [float(x.split(": ")[2].split(";")[0]) for x in log] == \
        pytest.approx([r[1] for r in rows], rel=1e-4)


def test_hmf_twin_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script("torch_hmf_validation").main(["--grid", "16", "--outdir",
                                              str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_twins_import_no_jax(tmp_path):
    """The CAMB, HMF and plot twins' main on a 16^3 CPU run (the plot twin
    also on a run with the past light cone), in one process: neither jax
    nor any module of the JAX package is imported."""
    pf = _write_parameter_file(tmp_path, 16)
    plc_dir = tmp_path / "plc"
    plc_dir.mkdir()
    plc_pf = _write_parameter_file(plc_dir, 16, plc=True)
    code = (
        "import importlib.util, os, sys\n"
        "def main(name):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join('scripts', name + '.py'))\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod.main\n"
        f"d = {str(tmp_path)!r}\n"
        "assert main('torch_make_camb_inputs')(\n"
        f"    [{str(pf)!r}, '--outdir', os.path.join(d, 'camb'), '--nz', "
        "'5', '--norad']) == 0\n"
        "assert main('torch_hmf_validation')(\n"
        "    ['--grid', '16', '--device', 'cpu', '--outdir', d]) == 0\n"
        f"assert main('torch_plot_example')([{str(pf)!r}, '--outdir', d]) "
        "== 0\n"
        "from pinocchio_tpu_torch.config import read_parameter_file\n"
        "from pinocchio_tpu_torch.run import run_pipeline\n"
        f"p = read_parameter_file({str(plc_pf)!r}, norad=True)\n"
        f"run_pipeline(p, outdir={str(plc_dir)!r}, device='cpu', "
        "verbose=False)\n"
        f"assert main('torch_plot_example')([{str(plc_pf)!r}, '--outdir', "
        f"{str(plc_dir)!r}]) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'pinocchio_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print('NOJAX')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:] + res.stdout[-2000:]
    assert "NOJAX" in res.stdout
    assert (tmp_path / "camb" / "hubble.dat").exists()
    assert (tmp_path / "VALIDATION_log.txt").exists()
    for f in ("mf.png", "lss.png"):
        assert (tmp_path / f).exists() and (plc_dir / f).exists()
    assert (plc_dir / "plc.png").exists()
    assert not (tmp_path / "plc.png").exists()
