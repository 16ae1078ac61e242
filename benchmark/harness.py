"""The benchmark of pinocchio_tpu_torch's device stage: one cell of
BENCHMARK.json, run back to back for a fixed time.

A cell names a configuration (``configs/<name>.json``: the run's Params)
and a traffic mix (``traffic/<name>.json``: the general generator's
parameters); the cell's own file ``cells/<cell>.json`` holds its
correctness limits and names the roofline operations it is measured
against, each described by ``roofline/<op>.json``; each metric is read by
``metrics/<metric>.py``.  All of them are found by name, so a cell, a
metric or an operation is added as files and entries alone, and an
operation added later applies only to the cells that name it.

A run: set-up (the kernel library, Params, the cosmology and, with
scale-dependent growth, its per-radius growth, the planner's plan, one warm
realization), then realizations back to back until ``seconds`` have passed,
each one call of the engine's entry followed by the join of its pending
hand-off and the drop of its host products.  With ``trace`` the window runs
under torch.profiler and the benchmark's own spans (per-layer metrics);
without it the end-to-end metrics.  After the window one realization, drawn
from the seed among those completed, is held to the plain reference
(``check.py``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "pinocchio_tpu")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fd:
        return json.load(fd)


def _json(path: str) -> dict:
    with open(path) as fd:
        return json.load(fd)


class Cell:
    """One workload of the spec with its files: the configuration, the
    traffic mix, its own file (limits, roofline operations), and the
    metrics it reports."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.root = root
        self.bench = os.path.join(root, "benchmark")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = _json(os.path.join(
            self.bench, "traffic", self.workload["traffic"] + ".json"))
        own = _json(os.path.join(self.bench, "cells", name + ".json"))
        self.limits = own["limits"]
        self.ops = own["roofline"]
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in spec["end_to_end"]
                           if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if self._reports(m) and m["moves"] in reported]

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def params_dict(self) -> dict:
        """The run's Params as keyword arguments: the configuration's, then
        the traffic mix's."""
        out = dict(self.config["params"])
        out.update(self.traffic.get("params", {}))
        return out

    def reader(self, metric: str):
        """The read(run) function of metrics/<metric>.py."""
        path = os.path.join(self.bench, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def roofline_ops(self) -> list:
        """The roofline operations the cell's own file names."""
        return [_json(os.path.join(self.bench, "roofline", op + ".json"))
                for op in self.ops]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------
# the system under test
# ------------------------------------------------------------------

class System:
    """The port, set up for one cell: Params, cosmology, the per-radius
    growth of a scale-dependent cosmology, the plan and the engine."""

    def __init__(self, cell: Cell, device):
        import torch
        from pinocchio_tpu_torch import kernels, planner
        from pinocchio_tpu_torch.config import Params
        from pinocchio_tpu_torch.cosmology import Cosmology
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            kernels.build()
            kernels.lib()
        self.params = Params(**cell.params_dict())
        self.cosmo = Cosmology(self.params)
        self.scaledep_gm = None
        if getattr(self.cosmo, "scale_dep", False):
            from pinocchio_tpu_torch.fmax import Smoothing
            from pinocchio_tpu_torch.io.catalogs import largest_halo_mass
            from pinocchio_tpu_torch.scaledep import set_scaledep_gm
            self.scaledep_gm = set_scaledep_gm(
                self.params, self.cosmo,
                Smoothing.build(self.params, self.cosmo),
                largest_halo_mass(self.params, self.cosmo), verbose=False)
        limit = None if self.cuda else 80e9
        self.plan = planner.plan(self.params, self.device, self.cosmo,
                                 limit=limit)
        self.engine = "ooc" if self.plan["use_ooc"] else "dense"

    def _sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def realize(self, seed: int, keep: bool = False, span=None):
        """One realization of ``seed``: the entry, the join of its hand-off,
        the drop of its products.  Returns (record, products), products the
        host arrays (ci, F, sets, hist) when ``keep``, else None."""
        import torch
        from pinocchio_tpu_torch import fmax, fmax_ooc, kernels
        span = span or _no_span
        self.params.RandomSeed = int(seed)
        kernels.reset_launches()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        with span("bench.entry"):
            if self.engine == "ooc":
                res = fmax_ooc.run_fmax_ooc(
                    self.params, self.cosmo, self.device,
                    scaledep_gm=self.scaledep_gm, trace_memory=False)
            else:
                res = fmax.run_fmax(self.params, self.cosmo, self.device,
                                    scaledep_gm=self.scaledep_gm)
        t1 = time.perf_counter()
        with span("bench.join"):
            pending = res.pending_fetch or res.ooc_pending
            if pending is not None:
                pending.join()
            self._sync()
        t2 = time.perf_counter()
        peak = (torch.cuda.max_memory_allocated(self.device) if self.cuda
                else 0)
        sp = res.host_products
        sets = sp.segments if sp.segments is not None else [sp.vel]
        rec = dict(seed=int(seed), entry_s=t1 - t0, join_s=t2 - t1,
                   timings=dict(res.timings), peak=int(peak),
                   launches=dict(kernels.LAUNCHES), count=int(sp.ci.size),
                   nsmooth=int(res.smoothing.n), nsets=len(sets),
                   nfields=len(list(sets[0].keys())))
        products = None
        if keep:
            products = dict(
                ci=sp.ci, F=sp.F, hist=res.pdf_hist,
                sets=[{k: (s.buffer(k) if hasattr(s, "buffer") else s[k])
                       for k in s.keys()} for s in sets])
        with span("bench.drop"):
            del res, sp, sets, pending
            gc.collect()
        t3 = time.perf_counter()
        rec["drop_s"] = t3 - t2
        rec["total_s"] = t3 - t0
        return rec, products


def _no_span(name):
    return contextlib.nullcontext()


# ------------------------------------------------------------------
# one run
# ------------------------------------------------------------------

def device_info(device) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=1)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, out_dir: str = None) -> dict:
    """One run of ``cell``; returns the result object (the last line)."""
    from benchmark import check, traffic
    from benchmark.trace import Tracer

    gen = traffic.Generator(seed)
    out = out_dir or os.path.join(cell.root, "benchmark_out")
    system = System(cell, device)
    # the warm realization: every shape of the cell, cuFFT's plans, the
    # caching allocator
    system.realize(gen.warm_seed())
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(out, cell.name) if trace else None
    records, kept = [], None
    span = tracer.span if tracer else _no_span
    if tracer:
        tracer.start()
    t_win = time.perf_counter()
    while not records or time.perf_counter() - t_win < seconds:
        rseed = gen.next_seed()
        keep = gen.sample(len(records) + 1)
        with span("bench.realization"):
            rec, products = system.realize(rseed, keep=keep, span=span)
        records.append(rec)
        if keep:
            kept = (rec["seed"], products)
        del products
    window_s = time.perf_counter() - t_win
    trace_summary = tracer.stop() if tracer else None
    peak = max(r["peak"] for r in records)
    run_rec = dict(cell=cell.name, engine=system.engine, records=records,
                   plan=system.plan, setup_s=setup_s, window_s=window_s,
                   trace=trace_summary, ops=cell.roofline_ops(),
                   N=system.params.GridSize)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"records-{cell.name}.json"), "w") as fd:
        json.dump(dict(setup_s=setup_s, window_s=window_s,
                       engine=system.engine, records=records), fd)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run_rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    # the check, once the program's state is freed
    engine = system.engine
    del system
    gc.collect()
    _empty_cache(device)
    t_check = time.perf_counter()
    numbers = check.check(cell.params_dict(), engine, kept[0], kept[1],
                          device)
    print(f"check of realization {kept[0]}: "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    del kept
    compared = {k: dict(value=v, limit=cell.limits[k])
                for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    dev = device_info(device)
    dev["memory_peak_bytes"] = peak
    if trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
    result = dict(correct=correct, attempted=len(records), failed=0,
                  metrics=metrics, device=dev)
    if trace_summary is not None:
        result["breakdown"] = trace_summary["breakdown"]
    result["compared"] = compared
    return result


def _empty_cache(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, t_start: float = None, device=None) -> int:
    """The command line: --workload --seed --seconds --trace.  ``device``
    None looks for the cards the cell asks for and refuses to run without
    them; the tests pass a device to drive a run on the CPU."""
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(load_spec(), args.workload)
    if device is None:
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = "cuda:0"
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 t_start)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

