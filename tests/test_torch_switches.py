"""The output and sweep switches that no other port test sets, pinned to the
JAX package on the CPU: one JAX run at 32^3 (the HMF_Validation switches)
dumps its products, and both packages restart from that dump with one
switch set, every file each writes byte for byte the other's.

- DoNotWriteCatalogs (with a past light cone to z 0.05) gates only the PLC
  catalog and n(z), in both packages: every output's catalog and mass
  function is written whatever the switch says (JAX run.py:236-239,
  :261; the port's run.py mirrors it; ROADMAP item 13);
- CatalogInAscii, OutputInH100, DoNotWriteHistories, light_output,
  AnalyticMassFunction 0 and 3, use_sim_params;
- over 2 sub-boxes: classic_fragmentation, BoundaryLayerFactor 1.5 and
  ExitIfExtraParticles.
"""

import dataclasses
import os
import shutil

import pytest
import torch

from pinocchio_tpu.run import run_pipeline as jax_run_pipeline
from pinocchio_tpu_torch.run import run_pipeline
from torch_params import bench_kwargs, params_pair

N = 32
PLC = dict(plc_enabled=True, StartingzForPLC=0.05, LastzForPLC=0.0,
           PLCAperture=30.0, PLCProvideConeData=True)
CASES = {
    "DoNotWriteCatalogs": dict(PLC, DoNotWriteCatalogs=True),
    "CatalogInAscii": dict(CatalogInAscii=True),
    "OutputInH100": dict(OutputInH100=True),
    "DoNotWriteHistories": dict(DoNotWriteHistories=True),
    "light_output": dict(light_output=True),
    "classic_fragmentation": dict(classic_fragmentation=True, subbox_tasks=2),
    "AnalyticMassFunction0": dict(AnalyticMassFunction=0),
    "AnalyticMassFunction3": dict(AnalyticMassFunction=3),
    "use_sim_params": dict(use_sim_params=True),
    "BoundaryLayerFactor1.5": dict(BoundaryLayerFactor=1.5, subbox_tasks=2),
    "ExitIfExtraParticles": dict(ExitIfExtraParticles=True, subbox_tasks=2),
}


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    """The JAX package's run at 32^3 with DumpProducts: its directory."""
    jp, _ = params_pair(**bench_kwargs(N, DumpProducts=True))
    out = tmp_path_factory.mktemp("jax_dump")
    jax_run_pipeline(jp, outdir=str(out), verbose=False)
    assert (out / "DumpProducts").is_dir()
    return out


def _files(d):
    return sorted(f for f in os.listdir(d) if os.path.isfile(d / f))


@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_with_the_switch_writes_the_jax_files(jax_dump, tmp_path,
                                                      case):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jp, p = params_pair(**dict(bench_kwargs(N), **CASES[case]))
    outs, res = {}, {}
    try:
        for name, run, params, kw in (("jax", jax_run_pipeline, jp, {}),
                                      ("port", run_pipeline, p,
                                       dict(device="cpu"))):
            out = tmp_path / name
            shutil.copytree(jax_dump / "DumpProducts", out / "DumpProducts")
            q = dataclasses.replace(params, ReadProductsFromDumps=True)
            res[name] = run(q, outdir=str(out), verbose=False, **kw)
            outs[name] = out
    finally:
        torch.set_num_threads(threads)
    mine, theirs = _files(outs["port"]), _files(outs["jax"])
    assert mine == theirs
    for f in mine:
        assert (outs["port"] / f).read_bytes() == \
            (outs["jax"] / f).read_bytes(), f
    cats = [f for f in mine if f.endswith(".catalog.out")]
    assert len(cats) == 4 and sum(f.endswith(".mf.out") for f in mine) == 4
    if case == "DoNotWriteCatalogs":
        # the switch gates only the PLC catalog and n(z) of a cone that
        # has crossings
        assert not any(f.endswith((".plc.out", ".nz.out")) for f in mine)
        assert all(len(r["frag"].plc.z) > 0 for r in res.values())
    if case == "CatalogInAscii":
        assert (outs["port"] / cats[0]).read_bytes()[:1] == b"#"

    hist = any(f.endswith(".histories.out") for f in mine)
    assert hist == (case != "DoNotWriteHistories")
