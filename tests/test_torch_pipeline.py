"""The PyTorch port end to end against the JAX package, on the CPU.

At 64^3 (GridSize 64, BoxSize 64, outputs z = 2, 1, 0.5, 0, no radiation,
no PLC) the port's run_pipeline is held to JAX's run_pipeline with the
tolerance family of the JAX package's own sub-box tests (test_subbox.py):
halo counts per output within max(5, 0.5 %), over 97 % of the final halos
identical in name and mass, and mass-function bins of more than 100 halos
within 3 %.  Measured: counts within 2, 98.1 % identical.

Given JAX's delta(k), run_fmax's Fmax, Rmax and grid variance are held to
the collapse kernel's tolerances: |dF| <= 1e-4 max(1, |F|) on 99.99 % of
the cells that float32 resolves (see test_torch_collapse.py: the cells
where float64, JAX and one-ulp-moved float32 evaluations agree to a
quarter of the tolerance; 97.7 % of cells here, agreement 99.996 %), Rmax
equal on 99.9 % (measured 99.97 %), the variance within 1e-5 (measured
1.4e-7).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinocchio_tpu.ops import derivatives as jder
from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu_torch import fmax, fmax_ooc
from pinocchio_tpu_torch.config import Params
from pinocchio_tpu_torch.cosmology import Cosmology
from pinocchio_tpu_torch.ops import collapse
from pinocchio_tpu_torch.run import (check_supported, main, run_pipeline,
                                     run_special_mode)
from torch_params import bench_kwargs, params_pair

torch.set_num_threads(2)

N = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(n=N):
    return Params(**bench_kwargs(n))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jp, p = params_pair(**bench_kwargs(N))
    jax_res = jax_run_pipeline(jp, outdir=str(tmp_path_factory.mktemp("j")),
                               verbose=False, write_outputs=False)
    out = tmp_path_factory.mktemp("t")
    port_res = run_pipeline(p, outdir=str(out), device="cpu", verbose=False)
    return p, jax_res, port_res, out


def test_outputs_written(runs):
    p, _, port_res, out = runs
    files = set(os.listdir(out))
    for z in p.output_z:
        for kind in ("catalog", "mf"):
            assert f"pinocchio.{z:6.4f}.{p.RunFlag}.{kind}.out" in files
    for name in ("FmaxPDF", "histories", "cosmology"):
        assert f"pinocchio.{p.RunFlag}.{name}.out" in files
    hist = np.loadtxt(out / f"pinocchio.{p.RunFlag}.FmaxPDF.out")
    assert hist[:, 2].sum() == N ** 3


def test_halo_counts_match(runs):
    p, jax_res, port_res, _ = runs
    mh = p.MinHaloMass
    for s, m in zip(jax_res["frag"].catalogs, port_res["frag"].catalogs):
        assert s.z == m.z
        ns, nm = int((s.mass >= mh).sum()), int((m.mass >= mh).sum())
        assert ns > 0
        assert abs(nm - ns) <= max(5, 0.005 * ns), (s.z, ns, nm)


def test_halo_identity_match(runs):
    _, jax_res, port_res, _ = runs
    s, m = jax_res["frag"].catalogs[-1], port_res["frag"].catalogs[-1]
    sm = dict(zip(s.name.tolist(), s.mass.tolist()))
    matched = sum(1 for nm, ms in zip(m.name.tolist(), m.mass.tolist())
                  if sm.get(nm) == ms)
    assert matched / len(s.name) > 0.97


def test_mass_functions_match(runs):
    _, jax_res, port_res, _ = runs
    s, m = jax_res["frag"].catalogs[-1], port_res["frag"].catalogs[-1]
    bins = np.arange(1, 5, 0.2)
    hs, _ = np.histogram(np.log10(s.mass), bins=bins)
    hm, _ = np.histogram(np.log10(m.mass), bins=bins)
    big = hs > 100
    assert big.any()
    assert np.abs(hm[big] / hs[big] - 1.0).max() < 0.03


def test_fmax_matches_jax_on_the_same_delta(runs):
    p, jax_res, _, _ = runs
    jf = jax_res["fmax"]
    state = fmax.load_jax_state({"kdensity": np.asarray(jf.kdensity)}, "cpu")
    res = fmax.run_fmax(p, Cosmology(p), "cpu",
                        kdensity=state["kdensity"])
    jF, jR = np.asarray(jf.products.Fmax), np.asarray(jf.products.Rmax)
    tF, tR = res.products.Fmax.numpy(), res.products.Rmax.numpy()

    # float64 and one-ulp-moved float32 collapse over JAX's own Hessians
    sm = jf.smoothing
    pack = fmax.inverse_growth_packs(Cosmology(p), sm)[0]
    rng = np.random.default_rng(0)
    F64 = np.full(jF.shape, -10.0)
    moved = [np.full(jF.shape, -10.0) for _ in range(3)]
    for r in sm.radii:
        sd = np.asarray(jder.second_derivatives(
            jf.kdensity, jnp.float32(r / jf.grid.CellSize), N))
        F64 = np.maximum(F64, collapse.collapse_F(
            torch.from_numpy(sd).double(), pack).numpy())
        for i in range(3):
            sdm = (sd * (1.0 + 2.0 ** -23 * rng.choice([-1.0, 1.0], sd.shape))
                   ).astype(np.float32)
            moved[i] = np.maximum(moved[i], collapse.collapse_F(
                torch.from_numpy(sdm), pack).numpy())
    tol = 1e-4 * np.maximum(1.0, np.abs(jF))
    noise = np.max([np.abs(x - F64) for x in moved] + [np.abs(jF - F64)],
                   axis=0)
    resolved = noise <= 0.25 * tol
    assert resolved.mean() >= 0.95
    assert np.mean((np.abs(tF - jF) <= tol)[resolved]) >= 0.9999
    assert np.mean(tR == jR) >= 0.999
    np.testing.assert_allclose(res.smoothing.true_variance,
                               jf.smoothing.true_variance, rtol=1e-5)


def test_sparse_products_are_sweep_ordered(runs):
    """Needed particles: exactly the cells with F >= Flast, in descending F
    with ties by ascending cell index, rows equal to the dense fields."""
    p, _, port_res, _ = runs
    res = port_res["fmax"]
    sp = res.host_products
    F = res.products.Fmax.numpy().ravel()
    want = np.flatnonzero(F >= p.Flast)
    want = want[np.lexsort((want, -F[want]))]
    np.testing.assert_array_equal(sp.ci, want)
    np.testing.assert_array_equal(sp.F, F[want])
    assert sorted(sp.vel) == ["v1", "v2", "v31", "v32"]
    assert all(v.shape == (len(want), 3) for v in sp.vel.values())


def test_port_imports_no_jax(tmp_path):
    """The paths (classic; tabulated bicubic; f(R) growth with
    RECOMPUTE_DISPLACEMENTS; the out-of-core engine with each of them and
    a product dump, and with bfloat16 storage; a restart from that dump;
    the past light cone with the
    timeless snapshot; fragmentation over sub-boxes, single-turn and
    two-turn; classic and f(R) over an 8-shard mesh, on the dense and on
    the out-of-core engine; two mocked hosts over
    a 4-shard mesh with the exchange, single-turn through run_pipeline and
    two-turn through a host slice, and scripts/torch_merge_chunks.py on
    their chunks; special mode 2), the planner's CLI and the FITS scripts
    (scripts/torch_pinocchio2fits.py and torch_validate_fits.py on the
    merged files) run without importing jax or any module of the JAX
    package; and so do two processes of the CLI with the out-of-core
    engine over 4 CPU shards (each process checks its own modules)."""
    code = (
        "import sys\n"
        "from pinocchio_tpu_torch.config import Params\n"
        "from pinocchio_tpu_torch.run import run_pipeline, "
        "run_special_mode\n"
        "tab = dict(ell_model='tabulated', ct_interp='bicubic')\n"
        "fr = dict(mod_grav_fr=True, fr0=1e-5, scale_dependent=True,\n"
        "          recompute_displacements=True, MaxMemPerParticle=400)\n"
        "plc = dict(plc_enabled=True, StartingzForPLC=0.02,\n"
        "           PLCProvideConeData=True, WriteTimelessSnapshot=True,\n"
        "           add_rmax_to_snapshot=True)\n"
        "base = dict(GridSize=16, BoxSize=16.0, output_z=[1.0, 0.0],\n"
        "            norad=True, plc_enabled=False)\n"
        "for kw in ({}, tab, fr, dict(ooc='on'), dict(tab, ooc='on'),\n"
        "           dict(fr, ooc='on', DumpProducts=True),\n"
        "           dict(ooc='on', ooc_dtype='bfloat16'),\n"
        "           dict(fr, ReadProductsFromDumps=True), plc,\n"
        "           dict(plc, subbox_tasks=4)):\n"
        "    p = Params(**dict(base, **kw))\n"
        f"    res = run_pipeline(p, outdir={str(tmp_path)!r}, device='cpu',"
        " verbose=False)\n"
        "from pinocchio_tpu_torch.parallel.pfft import make_volume_mesh\n"
        "for kw in ({}, fr, dict(ooc='on'), dict(fr, ooc='on')):\n"
        "    run_pipeline(Params(**dict(base, **kw)), device='cpu',\n"
        f"                 outdir={str(tmp_path)!r}, verbose=False,\n"
        "                 mesh=make_volume_mesh(8, devices=['cpu'] * 8))\n"
        "from pinocchio_tpu_torch.fragment.subbox import "
        "run_fragmentation_multibox\n"
        "from pinocchio_tpu_torch.cosmology import Cosmology\n"
        "run_fragmentation_multibox(p, Cosmology(p), res['fmax'], (2, 2, 1),"
        " two_turn=True, verbose=False)\n"
        f"run_special_mode(Params(**base), 2, {str(tmp_path)!r}, "
        "device='cpu', verbose=False)\n"
        "import os, runpy\n"
        "from pinocchio_tpu_torch.parallel.driver import "
        "run_fmax_distributed\n"
        "from pinocchio_tpu_torch.parallel.pfft import make_pencil_mesh\n"
        "def mesh4():\n"
        "    return make_pencil_mesh(4, devices=['cpu'] * 4)\n"
        f"hd = os.path.join({str(tmp_path)!r}, 'hosts')\n"
        "os.makedirs(hd)\n"
        "hp = Params(**dict(base, **plc, subbox_tasks=2))\n"
        "for h in range(2):\n"
        "    run_pipeline(hp, outdir=hd, device='cpu', verbose=False,\n"
        "                 mesh=mesh4(), hosts=(h, 2))\n"
        "fr = run_fmax_distributed(p, Cosmology(p), mesh4(),\n"
        "                          defer_handoff=True)\n"
        "run_fragmentation_multibox(p, Cosmology(p), fr, (2, 2, 1),\n"
        "                           two_turn=True, host_slice=(1, 2),\n"
        "                           verbose=False)\n"
        "pf = os.path.join(hd, 'parameter_file')\n"
        "open(pf, 'w').write('GridSize 16\\nBoxSize 16.0\\n'\n"
        "                    'StartingzForPLC 0.02\\nPLCProvideConeData\\n'\n"
        "                    'WriteTimelessSnapshot\\n')\n"
        "open(os.path.join(hd, 'outputs'), 'w').write('1.0\\n0.0\\n')\n"
        "sys.argv = ['torch_merge_chunks.py', pf, '--dir', hd, '--norad']\n"
        "runpy.run_path('scripts/torch_merge_chunks.py', "
        "run_name='__main__')\n"
        "assert os.path.exists(os.path.join(hd, "
        "'pinocchio.run.t_snapshot.out'))\n"
        "from pinocchio_tpu_torch import planner\n"
        "planner.main([pf, '--device-gb', '80'])\n"
        "import glob\n"
        "outs = [f for f in sorted(glob.glob(os.path.join(hd, "
        "'pinocchio.*.out')))\n"
        "        if f.endswith(('catalog.out', 'histories.out', "
        "'plc.out'))]\n"
        "assert len(outs) == 4, outs\n"
        "for name, argv in (('torch_pinocchio2fits.py', outs + ['--outdir', "
        "hd]),\n"
        "                   ('torch_validate_fits.py', [pf, '--dir', hd])):\n"
        "    sys.argv = [name] + argv\n"
        "    try:\n"
        "        runpy.run_path('scripts/' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, (name, e.code)\n"
        "import socket, subprocess\n"
        "with socket.socket() as sk:\n"
        "    sk.bind(('localhost', 0))\n"
        "    port = sk.getsockname()[1]\n"
        "child = ('import runpy, sys\\n'\n"
        "         'sys.argv = [\"run\"] + sys.argv[1:]\\n'\n"
        "         'runpy.run_module(\"pinocchio_tpu_torch.run\", '\n"
        "         'run_name=\"__main__\")\\n'\n"
        "         'bad = [m for m in sys.modules if m.split(\".\")[0] in '\n"
        "         '(\"jax\", \"pinocchio_tpu\")]\\n'\n"
        "         'assert not bad, bad[:5]\\n'\n"
        "         'print(\"CHILD NOJAX\")\\n')\n"
        "od = os.path.join(hd, 'procs')\n"
        "ppf = os.path.join(od, 'parameter_file')\n"
        "os.makedirs(od)\n"
        "open(ppf, 'w').write('GridSize 16\\nBoxSize 16.0\\n')\n"
        "argv = [sys.executable, '-c', child, ppf, '--norad', '--device',\n"
        "        'cpu', '--chips', '4', '--hosts', '2', '--coordinator',\n"
        "        f'localhost:{port}', '--subboxes', '2', '--ooc', 'on',\n"
        "        '--outdir', od, '--group-timeout', '120']\n"
        "ps = [subprocess.Popen(argv + ['--host-id', str(h)],\n"
        "                       stdout=subprocess.PIPE,\n"
        "                       stderr=subprocess.STDOUT, text=True)\n"
        "      for h in range(2)]\n"
        "outs = [p.communicate(timeout=240)[0] for p in ps]\n"
        "assert all(p.returncode == 0 and 'CHILD NOJAX' in o\n"
        "           for p, o in zip(ps, outs)), [o[-2000:] for o in outs]\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m == 'pinocchio_tpu'\n"
        "       or m.startswith('pinocchio_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NOJAX" in res.stdout
    for kind in ("plc", "nz", "t_snapshot", "density0"):
        assert (tmp_path / f"pinocchio.run.{kind}.out").exists()


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pf = tmp_path / "parameter_file"
    pf.write_text("GridSize 16\nBoxSize 16.0\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(pf), "--device", "cuda", "--outdir", str(tmp_path)])
    assert not any(f.endswith(".out") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("overrides", [
    dict(ell_model="sng"), dict(ell_model="tabulated", ct_interp="bilinear"),
    dict(scale_dependent=True), dict(recompute_displacements=True),
    dict(ooc="on"), dict(ooc="auto"),
    dict(ooc="auto", ell_model="tabulated"),
    # the out-of-core engine with every collapse and growth model, and the
    # product dumps on either engine
    dict(ooc="on", ell_model="tabulated"), dict(ooc="on", ell_model="sng"),
    dict(ooc="on", scale_dependent=True),
    dict(ooc="on", mod_grav_fr=True, fr0=1e-5, scale_dependent=True),
    dict(ooc="on", recompute_displacements=True),
    dict(ooc="on", DumpProducts=True), dict(DumpProducts=True),
    dict(ReadProductsFromDumps=True),
    # the past light cone on either engine, the timeless snapshot on the
    # dense one
    dict(plc_enabled=True, StartingzForPLC=1.0),
    dict(plc_enabled=True, StartingzForPLC=1.0, ooc="on"),
    dict(WriteTimelessSnapshot=True),
    # fragmentation over sub-boxes on either engine
    dict(subbox_tasks=4), dict(subbox_tasks=4, ooc="on")])
def test_features_in_the_slice_are_accepted(overrides):
    p = _params(16)
    for k, v in overrides.items():
        setattr(p, k, v)
    check_supported(p)
    if p.ooc == "on":
        fmax_ooc.check_ooc_supported(p)


@pytest.mark.parametrize("overrides,item", [
    (dict(WriteTimelessSnapshot=True, ooc="on"), "item 13"),
])
def test_features_outside_the_slice_raise(overrides, item):
    p = _params(16)
    p.plc_enabled = True
    for k, v in overrides.items():
        setattr(p, k, v)
    with pytest.raises(NotImplementedError, match=item):
        check_supported(p)


def test_special_mode_3_refuses_the_out_of_core_engine(tmp_path):
    p = _params(16)
    p.ooc = "on"
    with pytest.raises(NotImplementedError, match="item 13"):
        run_special_mode(p, 3, str(tmp_path), device="cpu", verbose=False)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv,ooc,error,item", [
    # a mesh with the out-of-core engine and the timeless snapshot (the
    # case keeps its id from when such a mesh refused the out-of-core
    # engine itself, item 12c), a mesh of more cards than the machine has
    # (this one has none), and several processes with the out-of-core
    # engine and the timeless snapshot (item 13) or with fewer shards than
    # processes, both refused before the group's rendezvous (the two cases
    # keep their ids from when the CLI refused --hosts itself, item 12b-ii)
    pytest.param(["--chips", "2", "--device", "cpu"], "on",
                 NotImplementedError, "item 13",
                 id="argv0-on-NotImplementedError-item 12c"),
    (["--chips", "4", "--device", "cuda"], "auto", RuntimeError, "CUDA"),
    pytest.param(["--hosts", "2", "--chips", "4", "--device", "cpu"], "on",
                 NotImplementedError, "item 13",
                 id="argv2-auto-NotImplementedError-item 12b-ii"),
    pytest.param(["--hosts", "2", "--subboxes", "2", "--device", "cpu"],
                 "auto", ValueError, "--chips a multiple",
                 id="argv3-auto-NotImplementedError-item 12b-ii")])
def test_cli_options_outside_the_slice_raise(tmp_path, monkeypatch, argv, ooc,
                                             error, item):
    import pinocchio_tpu_torch.run as run_mod
    if error is RuntimeError and torch.cuda.device_count() >= 4:
        pytest.skip("the machine has 4 CUDA devices")
    read = run_mod.read_parameter_file
    monkeypatch.setattr(run_mod, "read_parameter_file",
                        lambda *a, **kw: read(*a, ooc=ooc, **kw))
    pf = tmp_path / "parameter_file"
    pf.write_text("GridSize 16\nBoxSize 16.0\n"
                  + ("WriteTimelessSnapshot\n" if item == "item 13" else ""))
    with pytest.raises(error, match=item):
        main([str(pf), "--outdir", str(tmp_path)] + argv)
    assert not any(f.endswith(".out") for f in os.listdir(tmp_path))


def test_cli_special_mode_2_writes_the_density(tmp_path):
    """`python -m pinocchio_tpu_torch.run <pf> 2 --device cpu`: the linear
    density as a snapshot of N^3 float32 values with mean 0, and no other
    product."""
    from pinocchio_tpu_torch.io.snapshot import read_snapshot
    pf = tmp_path / "parameter_file"
    pf.write_text("GridSize 16\nBoxSize 16.0\n")
    main([str(pf), "2", "--device", "cpu", "--outdir", str(tmp_path)])
    outs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".out"))
    assert outs == ["pinocchio.run.density0.out"]
    _, blocks = read_snapshot(str(tmp_path / outs[0]))
    dens = np.frombuffer(blocks["DENS"], np.float32)
    assert dens.size == 16 ** 3 and np.all(np.isfinite(dens))
    assert abs(dens.mean()) <= 1e-6 * np.abs(dens).max()
