"""The traced run: torch.profiler over the window, with the benchmark's own
spans around each call into a layer (``bench.realization`` around one
realization; inside it ``bench.entry``, ``bench.join`` and ``bench.drop``).

The chrome trace is written to the run's output directory inside the
checkout and read back: the device's busy time (the union of its kernels,
copies and fills), the traced window (the first realization's start to the
last one's end), each kernel's device time by name, and the idle gaps of
the device labelled by what the host was doing meanwhile (the innermost
host event that covers the gap's middle, waits on the device left aside).
"""

from __future__ import annotations

import bisect
import json
import os
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WAITS = re.compile(r"Synchronize|EventQuery|bench\.realization")
TOP = 10
SHORT_US = 50.0     # gaps shorter than this are summed unlabelled
LOOKBACK = 500      # host events searched back from a gap


class Tracer:
    def __init__(self, out_dir: str, name: str):
        self.path = os.path.join(out_dir, f"trace-{name}.json")
        os.makedirs(out_dir, exist_ok=True)
        self.prof = None

    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def span(self, name: str):
        import torch
        return torch.profiler.record_function(name)

    def stop(self) -> dict:
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with open(self.path) as fd:
            events = json.load(fd)["traceEvents"]
        return summarize(events)


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut].replace("(anonymous namespace)::", "")[:160]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict:
    """busy_s, window_s, kernels {name: device seconds}, realizations
    (their count in the window) and the breakdown of the module
    docstring."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == "bench.realization"]
    if not spans:
        raise ValueError("the trace holds no bench.realization span")
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    dev, host = [], []
    kernels = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = e["ts"], e["ts"] + e.get("dur", 0.0)
            dev.append((max(a, w0), min(b, w1)))
            if cat == "kernel":
                kernels[e["name"]] += e.get("dur", 0.0) * 1e-6
            else:
                kernels[f"[{cat}] {e['name']}"] += e.get("dur", 0.0) * 1e-6
        elif cat in HOST_CATS:
            host.append(e)
    busy = _union([(a, b) for a, b in dev if b > a])
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = defaultdict(float)
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    spans_ = [e for e in host if e["cat"] == "user_annotation"]
    for a, b in gaps:
        name = (f"(gaps under {SHORT_US:g} us)" if b - a < SHORT_US
                else _host_at(host, starts, spans_, 0.5 * (a + b)))
        idle[name] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        realizations=len(spans), kernels=dict(kernels),
        breakdown=dict(
            device_ops=[[short_name(n), s] for n, s in top],
            idle_gaps=[[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]))


def _host_at(host, starts, spans, t) -> str:
    """The innermost host event covering time t that is not a wait on the
    device; a wait, or the benchmark's realization span, when nothing else
    covers it.  Searched: the LOOKBACK host events that start last before
    t, and every annotated span."""
    best, best_wait = None, None
    hi = bisect.bisect_right(starts, t)
    for e in host[max(0, hi - LOOKBACK):hi] + spans:
        if e["ts"] > t:
            continue
        if e["ts"] + e.get("dur", 0.0) < t:
            continue
        if WAITS.search(e["name"]):
            if best_wait is None or e["dur"] < best_wait["dur"]:
                best_wait = e
        elif best is None or e["dur"] < best["dur"]:
            best = e
    pick = best or best_wait
    return pick["name"][:120] if pick else "(no host event)"
