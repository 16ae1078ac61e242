"""The port's FITS writer and reader (pinocchio_tpu_torch/io/fits.py) and its
entry scripts (scripts/torch_pinocchio2fits.py, torch_validate_fits.py), on
the CPU.

write_fits writes the JAX package's bytes, for catalog, PLC and history
records with integer, float, string and logical header cards; read_fits
reads them back; the catalog and history converters write the JAX
converters' bytes from one port run's files; and the two scripts convert
and validate that run's catalogs, histories and PLC in a process that
imports neither jax nor the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pinocchio_tpu.io import fits as jfits
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.io import fits, readers
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs, params_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 32
RUN = dict(plc_enabled=True, StartingzForPLC=0.05, LastzForPLC=0.0,
           PLCAperture=30.0, PLCProvideConeData=True)
RECORDS = {"catalog": readers.CATALOG_DTYPE, "plc": readers.PLC_DTYPE,
           "histories": readers.HISTORIES_DTYPE}
CARDS = [("NHALOS", 7, "Number of halos in catalog"), ("PAR1", "GridSize", ""),
         ("VAL1", 64, ""), ("VAL2", 0.3089, "a float"), ("VAL3", True, ""),
         ("VAL4", -1.5e-12, ""), ("NAME", "a string longer than eight", "")]


def _records(dtype, n, seed):
    """n records of dtype with every byte drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, n * dtype.itemsize, dtype=np.uint8)
    return np.frombuffer(raw.tobytes(), dtype)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port run at 32^3 with the past light cone, and its parameter
    file and outputs list beside its files."""
    out = tmp_path_factory.mktemp("fits_run")
    p = Params(**dict(bench_kwargs(N), **RUN))
    run_pipeline(p, outdir=str(out), device="cpu", verbose=False)
    (out / "parameter_file").write_text(
        f"GridSize {N}\nBoxSize {float(N)}\nStartingzForPLC 0.05\n"
        "LastzForPLC 0.0\nPLCAperture 30\nPLCProvideConeData\n")
    (out / "outputs").write_text("".join(f"{z}\n"
                                         for z in p.output_z))
    return out, p


@pytest.mark.parametrize("kind", sorted(RECORDS))
def test_write_fits_bytes_equal_jax(tmp_path, kind):
    rec = _records(RECORDS[kind], 37, seed=len(kind))
    other = _records(RECORDS[kind], 5, seed=99)
    tables = [(kind.upper(), rec, CARDS), ("MORE", other, [])]
    a = fits.write_fits(str(tmp_path / "port.fits"), tables,
                        primary_cards=[("CODE", "pinocchio-tpu", "")])
    b = jfits.write_fits(str(tmp_path / "jax.fits"), tables,
                         primary_cards=[("CODE", "pinocchio-tpu", "")])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read()
    assert len(data) % fits.BLOCK == 0


@pytest.mark.parametrize("kind", sorted(RECORDS))
def test_read_fits_round_trip(tmp_path, kind):
    rec = _records(RECORDS[kind], 23, seed=7)
    path = fits.write_fits(str(tmp_path / "t.fits"),
                           [(kind.upper(), rec, CARDS)])
    ((name, hdr, back),) = fits.read_fits(path)
    assert name == kind.upper() and len(back) == len(rec)
    assert hdr["NHALOS"] == 7 and hdr["VAL1"] == 64 and hdr["VAL3"] is True
    assert hdr["VAL2"] == pytest.approx(0.3089)
    assert hdr["NAME"] == "a string longer than eight"
    for col in rec.dtype.names:
        a = np.ascontiguousarray(back[col]).astype(rec[col].dtype)
        assert a.tobytes() == np.ascontiguousarray(rec[col]).tobytes(), col


def test_converters_write_the_jax_bytes(run_dir, tmp_path):
    """convert_catalog_to_fits (with the run's parameters in the header)
    and convert_histories_to_fits on the port run's files."""
    out, p = run_dir
    jp, pp = params_pair(**dict(bench_kwargs(N), **RUN))
    cats = sorted(f for f in os.listdir(out) if f.endswith(".catalog.out"))
    assert len(cats) == len(p.output_z)
    for name in cats + [f"pinocchio.{p.RunFlag}.histories.out"]:
        src = str(out / name)
        port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
        port_dir.mkdir(exist_ok=True)
        jax_dir.mkdir(exist_ok=True)
        if "catalog" in name:
            a = fits.convert_catalog_to_fits(src, pp, str(port_dir))
            b = jfits.convert_catalog_to_fits(src, jp, str(jax_dir))
        else:
            a = fits.convert_histories_to_fits(src, pp, str(port_dir))
            b = jfits.convert_histories_to_fits(src, jp, str(jax_dir))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name


def test_scripts_convert_and_validate_a_port_run(run_dir):
    """scripts/torch_pinocchio2fits.py on every catalog, the histories and
    the PLC of the run (each read back and checked column by column), then
    scripts/torch_validate_fits.py over the directory: no error, and
    neither jax nor the JAX package imported."""
    out, p = run_dir
    files = sorted(str(out / f) for f in os.listdir(out)
                   if f.endswith((".catalog.out", ".histories.out",
                                  ".plc.out")))
    assert len(files) == len(p.output_z) + 2
    code = (
        "import runpy, sys\n"
        "def script(name, argv):\n"
        "    sys.argv = [name] + argv\n"
        "    try:\n"
        "        runpy.run_path('scripts/' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, (name, e.code)\n"
        f"script('torch_pinocchio2fits.py', {files!r} + ['--outdir', "
        f"{str(out)!r}, '--paramfile', {str(out / 'parameter_file')!r}])\n"
        f"script('torch_validate_fits.py', [{str(out / 'parameter_file')!r},"
        f" '--dir', {str(out)!r}])\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m == 'pinocchio_tpu'\n"
        "       or m.startswith('pinocchio_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:] + res.stdout[-2000:]
    assert res.stdout.count("[VALID:") == len(p.output_z) + 1
    assert "INVALID" not in res.stdout
    assert "validation finished with 0 error(s)" in res.stdout
    assert "NOJAX" in res.stdout
    for f in files:
        assert os.path.exists(f[:-3] + "fits")
