"""The port over several processes (the process layer): each process a gloo
group member on CPU shards, launched as a subprocess with a free localhost
port, a group timeout and a communicate() timeout.

- Primitives over 2 and 4 processes (tests/torch_procs_worker.py), each
  bit for bit the one-process version on the same inputs: pfft.all_to_all
  over every collective of a slab 4, a pencil 2x2 and a volumes 2x2x2 mesh,
  a forward and inverse transform with the whole-field gather; the
  collapse cycle's combined means and the FmaxPDF counts; with 2 processes
  the exchange of one 32^3 run's products for 2 hosts, single-turn, turn 0
  and turn 1 (every host's spheres all-gathered), and the two-turn
  fragmentation of each host slice.
- End to end through the CLI: two processes of `python -m
  pinocchio_tpu_torch.run <pf> --device cpu --chips 4 --hosts 2 --host-id h
  --coordinator localhost:P --subboxes 2 --grid 32` with the switches of
  test_torch_multihost.py (the PLC to z 0.05 and the timeless snapshot;
  RMAX is a build switch with no parameter-file tag, so the CLI's snapshot
  has none).  Each host's chunks and the in-run mass functions, n(z) and
  FmaxPDF are the in-process mocked run_pipeline(hosts=(h, 2))'s byte for
  byte (the snapshot chunks array for array), and scripts/
  torch_merge_chunks.py reassembles files equal to a one-process run's.
  Every process of both sides runs with one thread (OMP_NUM_THREADS=1,
  torch.set_num_threads(1)): the CPU FFTs then give the same bits from
  run to run, so the comparison needs no tolerance.  The merged catalogs
  are held to the JAX package's in-process run_pipeline(chips=4) in the
  tolerance family of its sub-box tests (halo counts per output within
  max(5, 0.5 %), over 97 % of the final halos equal in name and mass).
- A peer that exits before its first collective fails the other process,
  nonzero, within its group timeout.
- The primitives' workers import neither jax nor the JAX package.
- dryrun_multichip, the counterpart of __graft_entry__.dryrun_multichip,
  on 4 and 8 CPU shards.
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

import torch_procs_worker as worker
from pinocchio_tpu_torch.config import read_parameter_file
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.io import readers
from pinocchio_tpu_torch.parallel import driver
from pinocchio_tpu_torch.parallel.pfft import make_pencil_mesh
from pinocchio_tpu_torch.run import main, run_pipeline
from torch_params import bench_kwargs, params_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_procs_worker.py")
ENV = dict(os.environ, OMP_NUM_THREADS="1")
N = 32
PLC = dict(StartingzForPLC=0.05, LastzForPLC=0.0, PLCProvideConeData=True,
           WriteTimelessSnapshot=True)
CATALOGS = [f"pinocchio.{z:6.4f}.run.catalog.out" for z in (2.0, 1.0, 0.5,
                                                            0.0)]


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


def launch(argvs, timeout=240):
    """Run one process per argv together; (returncode, output) of each."""
    procs = [subprocess.Popen(a, cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    try:
        return [_wait(p, timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _wait(p, timeout):
    out, _ = p.communicate(timeout=timeout)
    return p.returncode, out


# ---------------- primitives over 2 and 4 processes ----------------

@pytest.fixture(scope="module")
def products(tmp_path_factory):
    """One 32^3 fmax run over a CPU pencil 2x2 mesh: Fmax, the grid
    variance and two displacement sets (the second the first scaled by
    1.25), for the exchange."""
    d = tmp_path_factory.mktemp("procs_products")
    p = worker.exchange_params()
    torch.set_num_threads(1)
    res = driver.run_fmax_distributed(p, Cosmology(p),
                                      make_pencil_mesh(4, devices=["cpu"] * 4),
                                      keep_dense_products=True)
    vel = res.dense.vel
    np.savez(d / "products.npz", F=res.dense.Fmax,
             true_variance=res.smoothing.true_variance,
             **{f"{s}/{k}": v * (1.0 + 0.25 * s) for s in (0, 1)
                for k, v in vel.items()})
    return d


@pytest.fixture(scope="module")
def group_runs(products, tmp_path_factory):
    """The worker over 2 and over 4 processes, both groups at once: {world:
    [result per rank]}."""
    runs, argvs = {}, []
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"procs{world}")
        os.link(products / "products.npz", d / "products.npz")
        port = free_port()
        argvs += [[sys.executable, WORKER, str(port), str(r), str(world),
                   str(d)] for r in range(world)]
        runs[world] = d
    done = launch(argvs, timeout=150)
    for r, (rc, out) in enumerate(done):
        assert rc == 0, f"worker {r}:\n{out[-3000:]}"
        assert "NOJAX" in out, out[-2000:]
    return {world: [dict(np.load(d / f"result.{r}.npz"))
                    for r in range(world)] for world, d in runs.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["slab", "pencil", "volumes"])
def test_transposes_equal_one_process(group_runs, world, kind):
    want = worker.transposes(kind)
    for r, got in enumerate(group_runs[world]):
        keys = [k for k in got if k.startswith(kind + "/")
                and k.count("/") == 3]
        assert len(keys) == len(worker.COLLECTIVES[kind]) * int(
            np.prod(worker.SHAPES[kind])) // world
        for k in keys + [f"{kind}/k", f"{kind}/back"]:
            assert np.array_equal(got[k], want[k]), (r, k)
            assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["slab", "pencil", "volumes"])
def test_reductions_equal_one_process(group_runs, world, kind):
    want = worker.reductions(kind)
    for got in group_runs[world]:
        for k in (f"{kind}/combine", f"{kind}/hist"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("world", [2, 4])
def test_traffic_is_counted(group_runs, world):
    """Every kind of collective the worker ran moved bytes through the
    group: the transposes, gathers and sums, and with 2 processes the
    exchange's route; none of the out-of-core engine's kinds (x-slab
    gathers, spectrum pieces, hand-off)."""
    for got in group_runs[world]:
        (tb, tc), (rb, rc), (gb, gc), (sb, sc), *ooc = got["traffic"]
        assert tb > 0 and tc > 0 and gb > 0 and gc > 0 and sb > 0 and sc > 0
        assert (rb > 0 and rc > 0) == (world == 2)
        assert len(ooc) == 3 and not np.any(ooc)


def test_exchange_equals_one_process(group_runs, products):
    results = group_runs[2]
    for h, got in enumerate(results):
        want = worker.exchanges(str(products / "products.npz"), host=h)
        assert sorted(want) == sorted(k for k in got if k.startswith(
            ("spheres/", "exchange/", "two_turn/")))
        for k, v in want.items():
            assert np.array_equal(got[k], v), (h, k)
        assert len(got["exchange/1/ci"]) > 0
        assert len(got["exchange/0/ci"]) < len(got["exchange/None/ci"])
        assert len(got["two_turn/1/name"]) > 0
    for h in (0, 1):
        assert np.array_equal(results[0][f"spheres/{h}"],
                              worker.spheres_of(h))


# ---------------- end to end through the CLI ----------------

def _parameter_file(d):
    (d / "outputs").write_text("2.0\n1.0\n0.5\n0.0\n")
    # GridSize 16 in the file, 32 from --grid
    (d / "parameter_file").write_text(
        "GridSize 16\nBoxSize 32.0\nOutputList outputs\n"
        + "".join(f"{k} {'' if v is True else v}\n" for k, v in PLC.items()))
    return d / "parameter_file"


def _merge_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_merge_chunks", os.path.join(REPO, "scripts",
                                           "torch_merge_chunks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The two processes through the CLI into 'procs', the mocked hosts in
    one process into 'mock' and one process without hosts into 'single'
    (the same mesh, parameter file and overrides)."""
    base = tmp_path_factory.mktemp("procs_cli")
    pf = _parameter_file(base)
    dirs = {k: base / k for k in ("procs", "mock", "single")}
    for d in dirs.values():
        os.makedirs(d)
    port = free_port()
    argv = [sys.executable, "-m", "pinocchio_tpu_torch.run", str(pf),
            "--norad", "--device", "cpu", "--chips", "4", "--hosts", "2",
            "--coordinator", f"localhost:{port}", "--subboxes", "2",
            "--grid", str(N), "--outdir", str(dirs["procs"]),
            "--group-timeout", "120"]
    procs = [subprocess.Popen(argv + ["--host-id", str(h)], cwd=REPO,
                              env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for h in range(2)]
    try:
        p = read_parameter_file(str(pf), norad=True)
        p = dataclasses.replace(p, GridSize=N, subbox_tasks=2)
        mock = [run_pipeline(p, outdir=str(dirs["mock"]), device="cpu",
                             verbose=False, hosts=(h, 2),
                             mesh=make_pencil_mesh(4, devices=["cpu"] * 4))
                for h in range(2)]
        single = run_pipeline(p, outdir=str(dirs["single"]), device="cpu",
                              verbose=False,
                              mesh=make_pencil_mesh(4, devices=["cpu"] * 4))
        outs = [_wait(pr, 240) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for h, (rc, out) in enumerate(outs):
        assert rc == 0, f"host {h}:\n{out[-3000:]}"
    return dict(p=p, dirs=dirs, outs=[o for _, o in outs], mock=mock,
                single=single)


def test_cli_processes_write_the_mocked_hosts_files(cli_runs):
    d = cli_runs["dirs"]
    for h in range(2):
        assert f"[cluster] process {h}/2 up" in cli_runs["outs"][h]
    got, want = sorted(os.listdir(d["procs"])), sorted(os.listdir(d["mock"]))
    assert got == want
    assert not any(".part" in f or f.startswith(".host") for f in got)
    for f in CATALOGS + ["pinocchio.run.histories.out",
                         "pinocchio.run.plc.out"]:
        assert f"{f}.0" in got and f"{f}.1" in got
    for f in got:
        if f.endswith(".npz"):
            with np.load(d["procs"] / f) as a, np.load(d["mock"] / f) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    assert np.array_equal(a[k], b[k]), (f, k)
        else:
            assert filecmp.cmp(d["procs"] / f, d["mock"] / f,
                               shallow=False), f
    names = [cli_runs["mock"][h]["frag"].catalogs[-1].name for h in range(2)]
    assert len(names[0]) > 0 and len(names[1]) > 0


def test_cli_process_reports_its_traffic(cli_runs):
    import json
    for h, out in enumerate(cli_runs["outs"]):
        line = [ln for ln in out.splitlines()
                if ln.startswith("[cluster] {")][-1]
        rep = json.loads(line[len("[cluster] "):])
        assert rep["host"] == h and rep["nhosts"] == 2
        assert rep["wall_s"] > 0 and rep["device_peak_gib"] == 0
        for kind in ("transpose", "route", "gather", "reduce"):
            assert rep["traffic"][kind]["calls"] > 0, kind


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
    for f in ("pinocchio.run.t_snapshot.out", "pinocchio.run.nz.out",
              "pinocchio.run.FmaxPDF.out"):
        assert filecmp.cmp(d["procs"] / f, d["single"] / f, shallow=False), f


def test_merged_processes_against_jax(cli_runs, tmp_path):
    """The merged catalogs against the JAX package's in-process
    run_pipeline(chips=4) on the same switches: halo counts per output
    within max(5, 0.5 %), over 97 % of the final halos equal in name and
    mass."""
    from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
    kw = dict(bench_kwargs(N), plc_enabled=True, subbox_tasks=2, **PLC)
    jp, _ = params_pair(**kw)
    jres = jax_run_pipeline(jp, outdir=str(tmp_path), verbose=False,
                            write_outputs=False, chips=4)
    port = [r["frag"].catalogs for r in cli_runs["mock"]]
    mh = cli_runs["p"].MinHaloMass
    for iout, s in enumerate(jres["frag"].catalogs):
        mass = np.concatenate([c[iout].mass for c in port])
        ns, nm = int((s.mass >= mh).sum()), int((mass >= mh).sum())
        assert ns > 0 and abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)
    s = jres["frag"].catalogs[-1]
    sm = dict(zip(s.name.tolist(), s.mass.tolist()))
    names = np.concatenate([c[-1].name for c in port])
    masses = np.concatenate([c[-1].mass for c in port])
    matched = sum(1 for n, m in zip(names.tolist(), masses.tolist())
                  if sm.get(n) == m)
    assert matched / len(s.name) > 0.97


def test_grid_flag_overrides_the_parameter_file(tmp_path, monkeypatch):
    import pinocchio_tpu_torch.run as run_mod
    seen = {}
    monkeypatch.setattr(run_mod, "run_pipeline",
                        lambda params, **kw: seen.update(N=params.GridSize))
    pf = _parameter_file(tmp_path)
    main([str(pf), "--device", "cpu", "--grid", "32", "--outdir",
          str(tmp_path)])
    assert seen["N"] == 32
    main([str(pf), "--device", "cpu", "--outdir", str(tmp_path)])
    assert seen["N"] == 16


# ---------------- failures ----------------

def test_a_peer_that_exits_fails_the_other(tmp_path):
    """Host 1 joins the group and exits before its first collective: host
    0, a CLI run with a 20 s group timeout, exits nonzero within it."""
    pf = _parameter_file(tmp_path)
    port = free_port()
    quitter = ("import sys; sys.path.insert(0, '.'); "
               "from pinocchio_tpu_torch.parallel.multihost import "
               "initialize_cluster; "
               f"initialize_cluster(2, 'localhost:{port}', 1, timeout=20.0)")
    t0 = time.perf_counter()
    done = launch([
        [sys.executable, "-m", "pinocchio_tpu_torch.run", str(pf), "--norad",
         "--device", "cpu", "--chips", "4", "--hosts", "2", "--host-id", "0",
         "--coordinator", f"localhost:{port}", "--outdir", str(tmp_path),
         "--group-timeout", "20"],
        [sys.executable, "-c", quitter]], timeout=120)
    wall = time.perf_counter() - t0
    (rc0, out0), (rc1, out1) = done
    assert rc1 == 0, out1[-2000:]
    assert rc0 != 0, out0[-2000:]
    assert wall < 20 + 60, wall
    assert not any(f.endswith(".out") for f in os.listdir(tmp_path))


def test_process_mesh_needs_its_group():
    from pinocchio_tpu_torch.parallel import pfft
    mesh = pfft.mesh_for(4, "pencil", devices=["cpu"] * 2, procs=(1, 2))
    assert [mesh.local(i) for i in range(4)] == [False, False, True, True]
    assert mesh.n_devices() == 2
    with pytest.raises(RuntimeError, match="not initialized"):
        pfft.make_decomp(mesh, 16)
    with pytest.raises(ValueError, match="do not divide"):
        pfft.mesh_for(4, "pencil", devices=["cpu"], procs=(0, 3))


# ---------------- the dry run ----------------

@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    """run_fmax_distributed over n CPU shards (pencil, and volumes at 8)
    held to run_fmax."""
    driver.dryrun_multichip(n, devices=["cpu"] * n)
