"""The port's storage estimate, device-count sweep and planner CLI, on the
CPU.

expected_halo_number, expected_plc_halo_number and estimate_file_sizes
(estimate_file_size, fragment.c:922-1065) are held to the JAX package's
within rtol 1e-9, on in-code Params: catalogs of several outputs written in
2 files each, the past light cone and the timeless snapshot.  The sweep is
held to the port's own plan at each card count (the JAX package's sweep
models the TPU's ledger, not the port's engines).  The CLI (python -m
pinocchio_tpu_torch.planner) reads a parameter file, plans for a card of
--device-gb GiB, and refuses to plan without it where there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pinocchio_tpu import planner as jplanner
from pinocchio_tpu.cosmology import Cosmology as JaxCosmology
from pinocchio_tpu_torch import planner
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs, params_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLC = dict(plc_enabled=True, StartingzForPLC=0.3, LastzForPLC=0.0,
           PLCAperture=30.0)
CASES = {
    "catalogs": dict(NumFiles=2),
    "plc_snapshot": dict(PLC, NumFiles=2, WriteTimelessSnapshot=True),
    "lpt2_snapshot": dict(WriteTimelessSnapshot=True, three_lpt=False),
}


@pytest.fixture(scope="module")
def pairs():
    """case -> (JAX Params, JAX cosmology, port Params, port cosmology)."""
    out = {}
    for name, kw in CASES.items():
        jp, p = params_pair(**dict(bench_kwargs(64), **kw))
        out[name] = (jp, JaxCosmology(jp), p, Cosmology(p))
    return out


@pytest.mark.parametrize("z", [0.0, 0.5, 2.0])
def test_expected_halo_number_matches_jax(pairs, z):
    jp, jc, p, c = pairs["catalogs"]
    got = planner.expected_halo_number(p, c, z)
    assert got > 0
    assert got == pytest.approx(jplanner.expected_halo_number(jp, jc, z),
                                rel=1e-9)


def test_expected_plc_halo_number_matches_jax(pairs):
    jp, jc, p, c = pairs["plc_snapshot"]
    got = planner.expected_plc_halo_number(p, c)
    assert got > 0
    assert got == pytest.approx(jplanner.expected_plc_halo_number(jp, jc),
                                rel=1e-9)
    # an empty cone
    jp2, p2 = params_pair(**dict(bench_kwargs(64),
                                 **dict(PLC, StartingzForPLC=0.0)))
    assert planner.expected_plc_halo_number(p2, c) == 0.0
    assert jplanner.expected_plc_halo_number(jp2, jc) == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimate_file_sizes_matches_jax(pairs, case, capsys):
    jp, jc, p, c = pairs[case]
    got = planner.estimate_file_sizes(p, c)
    printed = capsys.readouterr().out
    want = jplanner.estimate_file_sizes(jp, jc)
    assert capsys.readouterr().out == printed
    assert printed.startswith("ESTIMATED STORAGE REQUIREMENTS:")
    assert sorted(got) == sorted(want)
    assert sorted(got["catalogs"]) == sorted(want["catalogs"])
    for z, b in want["catalogs"].items():
        assert got["catalogs"][z] == pytest.approx(b, rel=1e-9)
    for k in set(want) - {"catalogs"}:
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    assert ("plc" in got) == (case == "plc_snapshot")
    assert ("snapshot" in got) == case.endswith("snapshot")
    if p.NumFiles > 1:
        assert "/file)" in printed


def test_run_pipeline_prints_the_estimate(tmp_path, capsys):
    """run_pipeline prints the estimate (after the plan, before fmax) when
    it is verbose and writes its outputs, and not otherwise."""
    p = Params(**bench_kwargs(16))
    run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=True)
    out = capsys.readouterr().out
    assert "ESTIMATED STORAGE REQUIREMENTS:" in out
    assert out.index("RUN PLAN") < out.index("ESTIMATED STORAGE") \
        < out.index("smoothing 1/")
    run_pipeline(p, outdir=str(tmp_path), device="cpu", verbose=True,
                 write_outputs=False)
    assert "ESTIMATED STORAGE" not in capsys.readouterr().out


def test_sweep_is_the_ports_plan(capsys):
    """Each row of the sweep is plan(n_chips=c) for a card of the given
    size: 1, 2, 4, ... cards up to max_chips; at 1024^3 on 80 GiB cards
    the out-of-core engine on one and two, the dense one from four."""
    p = Params(**bench_kwargs(1024))
    cosmo = Cosmology(p)
    limit = 80.0 * planner.GiB
    rows = planner.sweep(p, limit, max_chips=16, cosmo=cosmo)
    assert "DEVICE SWEEP for 1024^3" in capsys.readouterr().out
    assert [r["chips"] for r in rows] == [1, 2, 4, 8, 16]
    for r in rows:
        rep = planner.plan(p, "cuda", cosmo, n_chips=r["chips"], limit=limit)
        assert r["engine"] == rep["engine"]
        assert r["device_gib"] == rep["device_bytes"] / planner.GiB
        assert r["fits"] == rep["fits_device"]
        assert r["host_gib"] == rep["host_bytes"] / planner.GiB
    assert [r["engine"] for r in rows[:3]] == ["out-of-core", "out-of-core",
                                               "dense"]
    assert all(a["device_gib"] > b["device_gib"]
               for a, b in zip(rows[2:], rows[3:]))
    # no more cards than the out-of-core engine's kz planes
    small = planner.sweep(Params(**bench_kwargs(8)), limit, cosmo=cosmo,
                          verbose=False)
    assert [r["chips"] for r in small] == [1, 2, 4]


def _parameter_file(tmp_path, n=64):
    pf = tmp_path / "parameter_file"
    pf.write_text(f"GridSize {n}\nBoxSize {float(n)}\nNumFiles 2\n"
                  "StartingzForPLC 0.3\nLastzForPLC 0.0\nPLCAperture 30\n")
    (tmp_path / "outputs").write_text("2.0\n1.0\n0.0\n")
    return str(pf)


def test_cli_plans_for_device_gb(tmp_path, capsys):
    pf = _parameter_file(tmp_path)
    rep = planner.main([pf, "--device-gb", "80", "--norad"])
    out = capsys.readouterr().out
    assert "RUN PLAN for 64^3" in out and "80.00 GiB" in out
    assert "ESTIMATED STORAGE REQUIREMENTS:" in out
    assert "past light cone" in out
    assert rep["device_limit"] == 80 * planner.GiB
    assert rep["engine"] == "dense" and rep["fits_device"]
    assert sorted(rep["storage"]["catalogs"]) == [0.0, 1.0, 2.0]


def test_cli_options(tmp_path, capsys):
    """--grid, --subboxes, --chips and --ooc-dtype reach the plan (at
    1024^3 on 80 GiB the out-of-core engine; the 16-bit storage halves its
    stacks); --sweep."""
    pf = _parameter_file(tmp_path)
    base = [pf, "--device-gb", "80", "--norad", "--grid", "1024"]
    f32 = planner.main(base)
    b16 = planner.main(base + ["--ooc-dtype", "bfloat16"])
    two = planner.main(base + ["--chips", "2"])
    assert f32["grid"] == 1024 and f32["engine"] == "out-of-core"
    stack = [r["ooc"]["phases"]["cycle"]["hessian_stack"]
             for r in (f32, b16, two)]
    # two cards: the larger kz window of 257 of the 513 planes
    assert stack[0] == 2 * stack[1] and stack[2] * 513 == stack[0] * 257
    assert b16["ooc"]["peak"] < f32["ooc"]["peak"]
    assert two["n_chips"] == 2 and two["ooc"]["peak"] < f32["ooc"]["peak"]
    sub = planner.main([pf, "--device-gb", "80", "--norad", "--subboxes",
                        "4"])
    assert np.prod(sub["nbox"]) == 4
    capsys.readouterr()
    rows = planner.main([pf, "--device-gb", "80", "--norad", "--sweep"])
    assert "DEVICE SWEEP" in capsys.readouterr().out
    assert rows["sweep"][0]["chips"] == 1


def test_cli_refuses_without_a_card_or_device_gb(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI reads its memory")
    pf = _parameter_file(tmp_path)
    with pytest.raises(SystemExit) as err:
        planner.main([pf, "--norad"])
    assert err.value.code == 2
    assert "--device-gb" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="--device-gb"):
        planner.card_memory()


def test_cli_module_runs(tmp_path):
    """python -m pinocchio_tpu_torch.planner in a subprocess, without jax
    in the process."""
    pf = _parameter_file(tmp_path, n=32)
    code = ("import runpy, sys\n"
            f"sys.argv = ['planner', {pf!r}, '--device-gb', '80']\n"
            "runpy.run_module('pinocchio_tpu_torch.planner', "
            "run_name='__main__')\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m == 'pinocchio_tpu' or "
            "m.startswith('pinocchio_tpu.')]\n"
            "print('NOJAX')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "RUN PLAN for 32^3" in res.stdout and "NOJAX" in res.stdout
