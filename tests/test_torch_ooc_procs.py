"""The out-of-core engine over several processes: each process a gloo group
member on CPU shards, launched as a subprocess with a free localhost port,
a group timeout and a communicate() timeout.

- The engine (tests/torch_ooc_procs_worker.py) over a 4-shard mesh split
  over 2 processes (2 shards each) and over 4 (1 each), for the classic
  ellipsoid, the bicubic table lookup (K13), f(R) growth with
  RECOMPUTE_DISPLACEMENTS (K14, 4 sets) and bfloat16 storage, each read
  through the views before the join and joined before it is read, with
  landing chunks of 5000 rows: every process
  holds Fmax, the grid variances, the FmaxPDF counts, the needed (ci, F)
  and every row set bit for bit those of one process's OocMesh over the
  same 4 shards.
- Two busy threads, over 3 processes of one shard each, whose kz windows
  and x-blocks are uneven: the row streams, slowed, while the
  main thread sums arrays over the default group until the last row
  landed; the products bit for bit one process's over 3 shards, and sums
  ran while rows streamed (the row streams use a group of their own).
- End to end through the CLI: two processes of `python -m
  pinocchio_tpu_torch.run <pf> --device cpu --chips 4 --hosts 2 --host-id
  h --coordinator localhost:P --subboxes 2 --grid 32 --ooc on` with the
  PLC to z 0.05 and DumpProducts.  Each host's chunks, the mass functions,
  n(z), FmaxPDF and the dump are the in-process mocked run_pipeline(hosts=
  (h, 2))'s over the same out-of-core mesh byte for byte;
  scripts/torch_merge_chunks.py reassembles a one-process run's files; a
  restart of the two processes from their dump writes the chunks of the
  mocked hosts' restart from the same dump, byte for byte.  Every process
  of both sides runs with one thread (OMP_NUM_THREADS=1,
  torch.set_num_threads(1)), so the CPU FFTs give the same bits from run
  to run and no comparison needs a tolerance.  The merged catalogs are
  held to the JAX package's in-process run_pipeline(chips=4) with ooc
  'on' in the tolerance family of its sub-box tests: halo counts per
  output within max(5, 0.5 %), over 97 % of the final halos equal in name
  and mass.
- A peer that exits at its first x-slab gather, or at its first
  collective on the rows group while the rows stream on the background
  thread, fails the other process, nonzero, within its group timeout.
- A read of another process's Fmax shard raises; the planner counts the
  whole host products and its share of the sub-boxes in each out-of-core
  process of a node.
"""

import dataclasses
import filecmp
import importlib.util
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_ooc_procs_worker as worker
from pinocchio_tpu_torch import planner
from pinocchio_tpu_torch.config import Params, read_parameter_file
from pinocchio_tpu_torch.io import readers
from pinocchio_tpu_torch.parallel.driver import RemoteShard
from pinocchio_tpu_torch.parallel.pfft import make_pencil_mesh
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs, params_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ooc_procs_worker.py")
ENV = dict(os.environ, OMP_NUM_THREADS="1")
N = 32
PLC = dict(StartingzForPLC=0.05, LastzForPLC=0.0, PLCProvideConeData=True)
CATALOGS = [f"pinocchio.{z:6.4f}.run.catalog.out" for z in (2.0, 1.0, 0.5,
                                                            0.0)]
# the process groups of the worker: (mode, processes)
GROUPS = (("cases", 2), ("cases", 4), ("busy", 3))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(p, timeout):
    out, _ = p.communicate(timeout=timeout)
    return p.returncode, out


def _start(argv):
    return subprocess.Popen(argv, cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


# ---------------- the processes, all started at once ----------------

@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every worker group of GROUPS and the CLI's two processes (cli_runs),
    started together: {"workers": [(Popen, dir, (mode, world))], "cli":
    [Popen], "cli_dir": their base directory}; every process is stopped
    when the module ends.  This process runs with one torch thread
    meanwhile, as they do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    workers = []
    for mode, world in GROUPS:
        d = tmp_path_factory.mktemp(f"ooc_procs_{mode}{world}")
        port = free_port()
        workers += [(_start([sys.executable, WORKER, str(port), str(r),
                             str(world), str(d), mode]), d, (mode, world))
                    for r in range(world)]
    base = tmp_path_factory.mktemp("ooc_procs_cli")
    pf = _parameter_file(base)
    os.makedirs(base / "procs")
    port = free_port()
    cli = [_start(_cli(pf, base / "procs", port) + ["--host-id", str(h)])
           for h in range(2)]
    yield dict(workers=workers, cli=cli, cli_dir=base)
    _stop([w[0] for w in workers] + cli)
    torch.set_num_threads(threads)


# ---------------- the engine over 2, 3 and 4 processes ----------------

@pytest.fixture(scope="module")
def group_runs(started):
    """The worker groups' results, and the one-process runs they are held
    to, made meanwhile: (results {(mode, world): [result per rank]},
    one-process products {name: dict})."""
    want = {"jax": _jax_catalogs()}
    want.update({name: worker.run_case(name, 4) for name in worker.CASES})
    want["busy"] = worker.run_case("classic", worker.SHARDS["busy"],
                                   prefix="busy")
    done = [_wait(p, 240) for p, _, _ in started["workers"]]
    for r, (rc, out) in enumerate(done):
        assert rc == 0, f"worker {r}:\n{out[-3000:]}"
        assert "NOJAX" in out, out[-2000:]
    dirs = {key: d for _, d, key in started["workers"]}
    got = {key: [dict(np.load(d / f"result.{r}.npz"))
                 for r in range(key[1])] for key, d in dirs.items()}
    return got, want


def _held(got: dict, prefix: str, want: dict, name: str):
    keys = sorted(k[len(name) + 1:] for k in want)
    assert keys == sorted(k[len(prefix) + 1:] for k in got
                          if k.startswith(prefix + "/"))
    assert len([k for k in keys if k.startswith("set")]) >= 4
    for k in keys:
        a, b = got[f"{prefix}/{k}"], want[f"{name}/{k}"]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), (prefix, k)


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("name", list(worker.CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_processes_equal_one_process(group_runs, world, name, streamed):
    """streamed: each process's products read through the views before
    the join; else read after it."""
    got, want = group_runs
    for res in got["cases", world]:
        _held(res, f"{name}/{streamed}", want[name], name)
    if name == "fr_recompute":
        assert "fr_recompute/set3/v1" in want[name]


def test_uneven_split_equals_one_process(group_runs):
    """3 processes of one shard: kz windows of 6/6/5 planes, x-blocks of
    2/1/1 slabs, each process's products one process's."""
    from pinocchio_tpu_torch.config import Params
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fmax_ooc import OocMesh
    from pinocchio_tpu_torch.parallel.pfft import make_mesh
    p = Params(**bench_kwargs(N))
    om = OocMesh(p, Cosmology(p), "cpu", make_mesh(3, devices=["cpu"] * 3))
    assert [w for _, w in om.windows] == [6, 6, 5]
    assert [nx // om.Bx for _, nx in om.x_blocks] == [2, 1, 1]
    got, want = group_runs
    for res in got["busy", 3]:
        _held(res, "busy", want["busy"], "busy")


def test_two_busy_threads(group_runs):
    """The main thread's sums over the default group ran while the rows
    streamed on the rows group, and the products are one process's."""
    got, want = group_runs
    during = [int(res["during"]) for res in got["busy", 3]]
    assert during[0] == during[1] == during[2] > 0, during
    for res in got["busy", 3]:
        _held(res, "busy", want["busy"], "busy")


@pytest.mark.parametrize("key", [("cases", 2), ("cases", 4), ("busy", 3)])
def test_traffic_of_the_new_kinds(group_runs, key):
    """The x-slab gathers, spectrum pieces and hand-off crossed the group
    in every process, each counted under its kind."""
    from pinocchio_tpu_torch.parallel.multihost import TRAFFIC
    kinds = list(TRAFFIC)
    for res in group_runs[0][key]:
        t = dict(zip(kinds, res["traffic"].tolist()))
        for kind in ("slab", "spec", "handoff", "gather", "reduce"):
            assert t[kind][0] > 0 and t[kind][1] > 0, (kind, t)
        assert t["transpose"] == t["route"] == [0, 0]


# ---------------- end to end through the CLI ----------------

def _parameter_file(d, restart=False):
    (d / "outputs").write_text("2.0\n1.0\n0.5\n0.0\n")
    # GridSize 16 in the file, 32 from --grid
    tags = dict(PLC, **({"ReadProductsFromDumps": True} if restart
                        else {"DumpProducts": True}))
    (d / "parameter_file").write_text(
        "GridSize 16\nBoxSize 32.0\nOutputList outputs\n"
        + "".join(f"{k} {'' if v is True else v}\n" for k, v in tags.items()))
    return d / "parameter_file"


def _cli(pf, out, port, timeout=120):
    return [sys.executable, "-m", "pinocchio_tpu_torch.run", str(pf),
            "--norad", "--device", "cpu", "--chips", "4", "--hosts", "2",
            "--coordinator", f"localhost:{port}", "--subboxes", "2",
            "--grid", str(N), "--ooc", "on", "--outdir", str(out),
            "--group-timeout", str(timeout)]


def _mocked(pf, out):
    p = read_parameter_file(str(pf), norad=True)
    p = dataclasses.replace(p, GridSize=N, subbox_tasks=2, ooc="on")
    return p, [run_pipeline(p, outdir=str(out), device="cpu", verbose=False,
                            hosts=(h, 2),
                            mesh=make_pencil_mesh(4, devices=["cpu"] * 4))
               for h in range(2)]


def _merge_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_merge_chunks", os.path.join(REPO, "scripts",
                                           "torch_merge_chunks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli_runs(started, tmp_path_factory):
    """The two processes through the CLI into 'procs' (started), the
    mocked hosts in one process into 'mock' and one process without hosts
    into 'single' (the same out-of-core mesh, parameter file and
    overrides); then each side's restart from its own dump into the
    restart directory's 'procs' and 'mock'."""
    base = started["cli_dir"]
    pf = base / "parameter_file"
    dirs = {k: base / k for k in ("procs", "mock", "single")}
    for k in ("mock", "single"):
        os.makedirs(dirs[k])
    outs = [_wait(pr, 240) for pr in started["cli"]]
    for h, (rc, out) in enumerate(outs):
        assert rc == 0, f"host {h}:\n{out[-3000:]}"
    # the processes' restart runs while this process makes the mocked
    # hosts' run, the one-process run and the mocked hosts' restart
    rbase = tmp_path_factory.mktemp("ooc_procs_restart")
    rpf = _parameter_file(rbase, restart=True)
    for side in ("procs", "mock"):
        os.makedirs(rbase / side)
        os.symlink(dirs[side] / "DumpProducts", rbase / side / "DumpProducts")
    port = free_port()
    rprocs = [_start(_cli(rpf, rbase / "procs", port) + ["--host-id", str(h)])
              for h in range(2)]
    try:
        p, mock = _mocked(pf, dirs["mock"])
        single = run_pipeline(p, outdir=str(dirs["single"]), device="cpu",
                              verbose=False,
                              mesh=make_pencil_mesh(4, devices=["cpu"] * 4))
        _mocked(rpf, rbase / "mock")
        routs = [_wait(pr, 240) for pr in rprocs]
    finally:
        _stop(rprocs)
    for h, (rc, out) in enumerate(routs):
        assert rc == 0, f"restart host {h}:\n{out[-3000:]}"
    return dict(p=p, dirs=dirs, outs=[o for _, o in outs], mock=mock,
                single=single, restart=rbase, routs=[o for _, o in routs])


def _same_dirs(got, want):
    a, b = sorted(os.listdir(got)), sorted(os.listdir(want))
    assert a == b
    for f in a:
        if os.path.isdir(os.path.join(got, f)):
            _same_dirs(os.path.join(got, f), os.path.join(want, f))
        else:
            assert filecmp.cmp(os.path.join(got, f), os.path.join(want, f),
                               shallow=False), f


def test_cli_processes_write_the_mocked_hosts_files(cli_runs):
    d = cli_runs["dirs"]
    for h in range(2):
        assert f"[cluster] process {h}/2 up" in cli_runs["outs"][h]
        assert "out-of-core ledger sharded over 4 devices of 2 processes" \
            in cli_runs["outs"][h]
    got = sorted(os.listdir(d["procs"]))
    assert not any(".part" in f or f.startswith(".host") for f in got)
    for f in CATALOGS + ["pinocchio.run.histories.out",
                         "pinocchio.run.plc.out"]:
        assert f"{f}.0" in got and f"{f}.1" in got
    for f in ("pinocchio.run.nz.out", "pinocchio.run.FmaxPDF.out",
              "DumpProducts"):
        assert f in got
    _same_dirs(d["procs"], d["mock"])
    names = [cli_runs["mock"][h]["frag"].catalogs[-1].name for h in range(2)]
    assert len(names[0]) > 0 and len(names[1]) > 0


def test_cli_process_reports_the_new_traffic(cli_runs):
    import json
    for h, out in enumerate(cli_runs["outs"]):
        line = [ln for ln in out.splitlines()
                if ln.startswith("[cluster] {")][-1]
        rep = json.loads(line[len("[cluster] "):])
        assert rep["host"] == h and rep["nhosts"] == 2
        assert rep["wall_s"] > 0 and rep["device_peak_gib"] == 0
        assert rep["host_peak_gib"] > 0 and rep["node_processes"] == 2
        assert rep["planned_host_gib"] > 0
        for kind in ("slab", "spec", "handoff", "gather", "reduce"):
            assert rep["traffic"][kind]["calls"] > 0, kind
        assert rep["traffic"]["transpose"]["calls"] == 0


def test_restart_from_the_processes_dump(cli_runs):
    """The two processes restarted from their dump write the files of the
    mocked hosts restarted from theirs, and the catalogs of the first
    run."""
    r, d = cli_runs["restart"], cli_runs["dirs"]
    for h, out in enumerate(cli_runs["routs"]):
        assert "products read from dumps" in out, out[-2000:]
    _same_dirs(r / "procs", r / "mock")
    for f in CATALOGS:
        for h in range(2):
            assert filecmp.cmp(r / "procs" / f"{f}.{h}",
                               d["mock"] / f"{f}.{h}", shallow=False)


def _same_catalog(a, b):
    assert len(a) == len(b) > 0
    oa, ob = np.argsort(a["name"]), np.argsort(b["name"])
    for field in a.dtype.names:
        np.testing.assert_array_equal(a[field][oa], b[field][ob])


def test_merged_processes_equal_one_process(cli_runs):
    p, d = cli_runs["p"], cli_runs["dirs"]
    _merge_tool().merge(p, str(d["procs"]))
    assert not any(".out." in f for f in os.listdir(d["procs"]))
    for f in CATALOGS:
        _same_catalog(readers.read_catalog(str(d["procs"] / f)),
                      readers.read_catalog(str(d["single"] / f)))
    a = readers.read_histories(str(d["procs"] / "pinocchio.run.histories.out"))
    b = readers.read_histories(str(d["single"]
                                   / "pinocchio.run.histories.out"))
    assert a[0] == b[0] > 0
    key = lambda t: tuple(t["name"].tolist())  # noqa: E731
    for x, y in zip(sorted(a[1], key=key), sorted(b[1], key=key)):
        np.testing.assert_array_equal(x, y)
    _same_catalog(readers.read_plc(str(d["procs"] / "pinocchio.run.plc.out")),
                  readers.read_plc(str(d["single"] / "pinocchio.run.plc.out")))
    for f in ("pinocchio.run.nz.out", "pinocchio.run.FmaxPDF.out"):
        assert filecmp.cmp(d["procs"] / f, d["single"] / f, shallow=False), f


def _jax_catalogs():
    """The catalogs of the JAX package's in-process run_pipeline(chips=4)
    with ooc 'on' on the CLI runs' switches (made while the processes
    run)."""
    import tempfile

    from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
    kw = dict(bench_kwargs(N), plc_enabled=True, subbox_tasks=2, ooc="on",
              **PLC)
    jp, _ = params_pair(**kw)
    with tempfile.TemporaryDirectory() as d:
        return jax_run_pipeline(jp, outdir=d, verbose=False,
                                write_outputs=False,
                                chips=4)["frag"].catalogs


def test_merged_processes_against_jax(group_runs, cli_runs):
    """The processes' catalogs against the JAX package's in-process
    run_pipeline(chips=4) with ooc 'on' on the same switches: halo counts
    per output within max(5, 0.5 %), over 97 % of the final halos equal in
    name and mass."""
    jcats = group_runs[1]["jax"]
    port = [r["frag"].catalogs for r in cli_runs["mock"]]
    mh = cli_runs["p"].MinHaloMass
    for iout, s in enumerate(jcats):
        mass = np.concatenate([c[iout].mass for c in port])
        ns, nm = int((s.mass >= mh).sum()), int((mass >= mh).sum())
        assert ns > 0 and abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)
    s = jcats[-1]
    sm = dict(zip(s.name.tolist(), s.mass.tolist()))
    names = np.concatenate([c[-1].name for c in port])
    masses = np.concatenate([c[-1].mass for c in port])
    matched = sum(1 for n, m in zip(names.tolist(), masses.tolist())
                  if sm.get(n) == m)
    assert matched / len(s.name) > 0.97


# ---------------- failures and the plan ----------------

# host 1: the CLI, which exits at its first x-slab gather (``slab``), or at
# its first collective on the rows group (``rows``): a row field's x-slab
# gather of the lpt_rows phase, on the background thread, while the main
# thread sweeps
QUITTER = ("import os, sys\n"
           "from pinocchio_tpu_torch.parallel import multihost\n"
           "staged = multihost.all_to_all_staged\n"
           "where = sys.argv.pop(1)\n"
           "def quit_at(kind, *a, **kw):\n"
           "    if where == 'slab' and kind == 'slab':\n"
           "        os._exit(3)\n"
           "    if where == 'rows' and kw.get('group') is not None:\n"
           "        assert kw['group'] is multihost.rows_group()\n"
           "        os._exit(4)\n"
           "    return staged(kind, *a, **kw)\n"
           "multihost.all_to_all_staged = quit_at\n"
           "from pinocchio_tpu_torch.run import main\n"
           "main(sys.argv[1:])\n")


def _peer_dies(tmp_path, where):
    """Host 0, a CLI run with a 20 s group timeout, beside host 1 that
    quits at ``where``: (host 0's exit code and output, host 1's exit
    code, the wall of both)."""
    (tmp_path / "parameter_file").write_text("GridSize 32\nBoxSize 32.0\n")
    pf = tmp_path / "parameter_file"
    port = free_port()
    argv = _cli(pf, tmp_path, port, timeout=20)
    t0 = time.perf_counter()
    procs = [_start(argv + ["--host-id", "0"]),
             _start([sys.executable, "-c", QUITTER, where] + argv[3:]
                    + ["--host-id", "1"])]
    try:
        (rc0, out0), (rc1, out1) = [_wait(p, 120) for p in procs]
    finally:
        _stop(procs)
    assert not any("catalog" in f or "histories" in f
                   for f in os.listdir(tmp_path))
    return rc0, out0, rc1, out1, time.perf_counter() - t0


def test_a_peer_that_dies_in_a_slab_step(tmp_path):
    """Host 1 exits in its first x-slab gather of the collapse cycle: host
    0, a CLI run with a 20 s group timeout, exits nonzero within it and
    writes no catalog."""
    rc0, out0, rc1, out1, wall = _peer_dies(tmp_path, "slab")
    assert rc1 == 3, out1[-2000:]
    assert rc0 != 0, out0[-2000:]
    assert wall < 20 + 60, wall


def test_a_peer_that_dies_while_the_rows_stream(tmp_path):
    """Host 1 exits at its first collective on the rows group, an x-slab
    gather of a row field on the background thread, after its main thread
    went on to the sweep: host 0's row streams fail, the failure comes out
    of the sweep or of PendingFetch.join(), and host 0 exits nonzero within
    its 20 s group timeout, writing no catalog."""
    rc0, out0, rc1, out1, wall = _peer_dies(tmp_path, "rows")
    assert rc1 == 4, out1[-2000:]
    assert rc0 != 0, out0[-2000:]
    # the error of the rows group's collective, raised on the background
    # thread and re-raised in the main thread
    assert "in lpt_rows" in out0 and "all_to_all_single" in out0, \
        out0[-2000:]
    assert wall < 20 + 60, wall


def test_a_remote_shard_raises():
    shard = RemoteShard("Fmax", 3, 1)
    with pytest.raises(RuntimeError, match="process 1 .*products.gather"):
        shard.device
    with pytest.raises(RuntimeError, match="shard 3's Fmax"):
        np.asarray(shard)


def test_planner_counts_the_products_in_each_process(monkeypatch):
    """Over 2 processes of a 4-shard out-of-core mesh the device map is
    per device and the engine choice its; each process is planned with the
    whole products and its round-robin share of the sub-boxes, and the
    host estimate of a node with both processes is twice one process's.  A
    dense process is planned as one process, whatever the node holds."""
    from pinocchio_tpu_torch.cosmology import Cosmology
    from pinocchio_tpu_torch.fragment import subbox
    # every sub-box swept at once, whatever this host's cores
    monkeypatch.setattr(subbox, "pool_workers", lambda: 4)
    p = Params(**bench_kwargs(64, ooc="on", subbox_tasks=4))
    cosmo = Cosmology(p)
    kw = dict(n_chips=2, shards=4, limit=80 * 2 ** 30)
    one = planner.plan(p, "cuda", cosmo, procs=2, **kw)
    two = planner.plan(p, "cuda", cosmo, procs=2, node_procs=2, **kw)
    alone = planner.plan(p, "cuda", cosmo, **kw)
    assert one["use_ooc"] and two["use_ooc"]
    assert one["device_bytes"] == two["device_bytes"]
    assert two["host_bytes"] == pytest.approx(2 * one["host_bytes"])
    assert "2 processes on this node" in planner.format_memory_map(two)
    share, whole = one["host"]["phases"], alone["host"]["phases"]
    assert share["fmax"] == whole["fmax"]
    for k in ("sweep_arrays", "groups", "row_map"):
        assert share["sweep"][k] == pytest.approx(whole["sweep"][k] / 2), k
    dense = dataclasses.replace(p, ooc="off")
    d2 = planner.plan(dense, "cuda", cosmo, procs=2, node_procs=2, **kw)
    assert not d2["use_ooc"] and d2["node_procs"] == 1
    assert d2["host_bytes"] == planner.plan(dense, "cuda", cosmo,
                                            **kw)["host_bytes"]
    auto = dataclasses.replace(p, ooc="auto")
    limit = 0.5 * (one["dense"]["peak"] + one["ooc"]["peak"])
    assert planner.plan(auto, "cuda", cosmo, n_chips=2, shards=4,
                        limit=limit, procs=2, node_procs=2)["use_ooc"]
