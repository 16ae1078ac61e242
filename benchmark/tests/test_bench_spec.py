"""BENCHMARK.json against the benchmark's contract, and the harness driven
by data: a cell, a traffic mix, a per-layer metric and a roofline operation
added as new files and entries alone, without editing a file that is
there."""

import hashlib
import json
import math
import os
import re
import shutil
import statistics

import pytest

from bench_small import run_small, small_cell
from benchmark import harness, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj).*size|_dim$|"
                    r"_rank$|head|expansion|experts_per_tok", re.I)


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_spec_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(spec["command"]) <= 32
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in spec[k]}) == len(spec[k])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(spec)) <= 64 * 1024


def test_run_seconds_fits_24_cells(spec):
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for c in spec["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert len(c["reduced"]) <= 16
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k)
            assert k in cfg["params"]
        assert cfg["name"] == c["name"]


def test_workloads(spec):
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    four = 0
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert 1 <= len(spec["workloads"]) <= 24
    assert four <= max(1, len(spec["workloads"]) // 4)


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        cell = harness.Cell(spec, w)
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_file_is_found_by_name(spec):
    for w in spec["workloads"]:
        cell = harness.Cell(spec, w["name"])
        assert set(cell.limits) == {"order_bad", "cells_off", "F_off",
                                    "hist_off", "hist_total", "rows_gap"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert len(set(cell.ops)) == len(cell.ops)
        for op in cell.roofline_ops():
            for p in op["kernels"]:
                re.compile(p)
    bench = os.path.join(harness.ROOT, "benchmark")
    for f in os.listdir(os.path.join(bench, "roofline")):
        op = json.load(open(os.path.join(bench, "roofline", f)))
        assert op["name"] + ".json" == f


def _shapes(scaledep=False, N=512):
    return dict(N=N, Nh=N // 2 + 1, cells=N ** 3, modes=N * N * (N // 2 + 1),
                nsmooth=9, nsets=4 if scaledep else 1, nfields=4,
                count=0.66 * N ** 3)


def test_roofline_arithmetic():
    spec = harness.load_spec()
    ops = harness.Cell(spec, "lcdm512.dense").roofline_ops()
    by = {op["name"]: op for op in ops}
    sh = _shapes()
    # K2 at 512^3: 56 bytes a mode over nsmooth + 1 calls, bound by bytes
    o, b, t = roofline.work(by["kspace_hessian"], sh)
    assert b == 56 * sh["modes"] * 10 and math.isclose(
        t, b / roofline.PEAK_BYTES)
    # each cell is measured against its own engine's operations alone
    assert "vrows_slab" not in by
    assert "kspace_gradient_tab" not in by
    ooc = set(harness.Cell(spec, "lcdm512.ooc").ops)
    assert "vrows_slab" in ooc and not ooc & {"kspace_hessian",
                                              "collapse_update"}
    fr = set(harness.Cell(spec, "fr5_512.dense").ops)
    assert "kspace_gradient_tab" in fr and "kspace_gradient" not in fr
    assert roofline.evaluate("2 * log2(8) + N", dict(N=1)) == 7.0
    with pytest.raises(ValueError):
        roofline.evaluate("__import__('os')", {})
    kern = {"void (anonymous namespace)::window_kernel<true, (anonymous "
            "namespace)::HessianOp>(float2 const*)": 2.0,
            "void (anonymous namespace)::window_kernel<true, (anonymous "
            "namespace)::GradientOp<(anonymous namespace)::ScalarGrowth> >"
            "(float2 const*)": 1.0}
    assert roofline.kernel_seconds(by["kspace_hessian"], kern) == 2.0
    assert roofline.kernel_seconds(by["kspace_gradient"], kern) == 1.0


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_metric_and_operation_by_files_alone(tmp_path):
    """A later change that adds a configuration, a traffic mix, a cell, a
    per-layer metric and a roofline operation writes new files and new
    entries; every file already there stays byte for byte, and the harness
    runs the new cell with the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    before = _digest(str(root))
    b = root / "benchmark"
    cfg = json.load(open(b / "configs" / "lcdm_hmfval_512.json"))
    cfg["name"] = "lcdm_tiny"
    cfg["params"].update(GridSize=32, BoxSize=32.0,
                         output_z=[1.0, 0.0])
    json.dump(cfg, open(b / "configs" / "lcdm_tiny.json", "w"))
    json.dump(dict(name="ensemble_dense", params=dict(ooc="off")),
              open(b / "traffic" / "ensemble_dense.json", "w"))
    own = json.load(open(b / "cells" / "lcdm512.dense.json"))
    own["roofline"].append("tiny_op")
    json.dump(own, open(b / "cells" / "tiny.dense.json", "w"))
    (b / "metrics" / "realizations_done.py").write_text(
        "def read(run):\n    return len(run['records'])\n")
    json.dump(dict(name="tiny_op", kernels=[r"\bnever_a_kernel\b"],
                   ops="cells", bytes="4 * cells", library=False),
              open(b / "roofline" / "tiny_op.json", "w"))
    spec["configs"].append(dict(name="lcdm_tiny", source="test",
                                file="benchmark/configs/lcdm_tiny.json",
                                reduced=["GridSize"], why="test"))
    spec["workloads"].append(dict(name="tiny.dense", config="lcdm_tiny",
                                  traffic="ensemble_dense", chips=1,
                                  why="test"))
    spec["per_layer"].append(dict(
        name="realizations_done", unit="runs", better="higher",
        source="program_counter", layer="entry", moves="realization_s",
        workloads=["tiny.dense"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(str(root))
    assert all(after[k] == v for k, v in before.items())

    cell = harness.Cell(harness.load_spec(str(root)), "tiny.dense",
                        root=str(root))
    assert cell.params_dict()["GridSize"] == 32
    assert "tiny_op" in {op["name"] for op in cell.roofline_ops()}
    # the new operation applies only to the cell that names it
    for w in spec["workloads"][:-1]:
        old = harness.Cell(harness.load_spec(str(root)), w["name"],
                           root=str(root))
        assert "tiny_op" not in {op["name"] for op in old.roofline_ops()}
    res = run_small(cell, tmp_path, trace=True)
    assert res["correct"] is True
    assert res["metrics"]["realizations_done"]["value"] == res["attempted"]
    res = run_small(cell, tmp_path, trace=False)
    assert set(res["metrics"]) >= {"setup_s", "realization_s"}
    assert res["correct"] is True


def test_seeds_are_drawn_from_the_run_seed():
    from benchmark.traffic import Generator
    a = Generator(2 ** 31 + 5)
    b = Generator(2 ** 31 + 5)
    assert [a.next_seed() for _ in range(5)] == [b.next_seed()
                                                 for _ in range(5)]
    c = Generator(2 ** 31 + 6)
    assert a.next_seed() != c.next_seed()
    # the reservoir keeps each of n realizations with probability 1/n
    hits = [0] * 4
    for s in range(4000):
        g = Generator(s)
        kept = None
        for i in range(1, 5):
            if g.sample(i):
                kept = i
        hits[kept - 1] += 1
    assert statistics.pstdev(hits) < 60


def test_small_cells_are_correct(tmp_path):
    for name in ("lcdm512.dense", "lcdm512.ooc"):
        res = run_small(small_cell(name), tmp_path)
        assert res["correct"] is True, res["compared"]
        assert list(res)[-1] == "compared"
