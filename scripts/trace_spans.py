#!/usr/bin/env python3
"""Each kernel's and copy's device time under the program span that
launched it, from a chrome trace of torch.profiler (the benchmark's traced
runs write ``benchmark_out/trace-<cell>.json``).

A device event is tied to the host call that launched it (cudaLaunchKernel,
cudaMemcpyAsync, ...) by the trace's correlation id.  On that call's thread
the script walks the host events that enclose the call: the innermost
annotated span (the port's fmax.*, ooc.*, handoff.* spans, or the
benchmark's bench.*) names where in the program the launch came from, and
the outermost and innermost PyTorch operators inside that span (aten::...)
name the call site, e.g. a clone before a c2r transform or the scaling of
an inverse transform.  It prints the device seconds per span, then the
largest (span, operators, kernel) rows, and with ``--json`` writes every
row.

    python3 scripts/trace_spans.py benchmark_out/trace-lcdm512.dense.json \
        [--top 30] [--json spans.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.trace import DEVICE_CATS, short_name  # noqa: E402

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NESTED_CATS = ("user_annotation", "cpu_op")


def _enclosing(intervals, points):
    """For each point (ts, key) of one thread, the chain of intervals that
    enclose it, outermost first: a sweep over both sorted by start, the
    open intervals on a stack (host events of one thread nest)."""
    intervals = sorted(intervals, key=lambda e: (e["ts"], -e.get("dur", 0)))
    points = sorted(points)
    out, stack, i = {}, [], 0
    for t, key in points:
        while i < len(intervals) and intervals[i]["ts"] <= t:
            e = intervals[i]
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= \
                    e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < t:
            stack.pop()
        out[key] = [e for e in stack
                    if e["ts"] + e.get("dur", 0) >= t]
    return out


def attribute(events: list) -> dict:
    """{(span, operators, kernel): [device seconds, count]} over the
    trace's device events whose launch is in the trace."""
    launches, device = {}, []
    nested = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launches[corr] = e
        elif cat in DEVICE_CATS and corr is not None:
            device.append(e)
        elif cat in NESTED_CATS:
            nested[(e.get("pid"), e.get("tid"))].append(e)
    points = defaultdict(list)
    for e in launches.values():
        points[(e.get("pid"), e.get("tid"))].append((e["ts"], e["args"][
            "correlation"]))
    chains = {}
    for thread, pts in points.items():
        chains.update(_enclosing(nested.get(thread, []), pts))
    rows = defaultdict(lambda: [0.0, 0])
    for e in device:
        chain = chains.get(e["args"]["correlation"])
        span, ops = "(no launch in the trace)", ""
        if chain is not None:
            spans = [i for i, c in enumerate(chain)
                     if c.get("cat") == "user_annotation"]
            span = chain[spans[-1]]["name"] if spans else "(no span)"
            inner = [c["name"] for c in chain[(spans[-1] + 1 if spans
                                               else 0):]
                     if c.get("cat") == "cpu_op"]
            ops = (" > ".join(dict.fromkeys((inner[0], inner[-1])))
                   if inner else "")
        name = short_name(e["name"])
        if e.get("cat") != "kernel":
            name = f"[{e['cat']}] {name}"
        row = rows[(span, ops, name)]
        row[0] += e.get("dur", 0.0) * 1e-6
        row[1] += 1
    return dict(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a chrome trace of torch.profiler")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--json", help="write every row to this file")
    args = ap.parse_args(argv)
    with open(args.trace) as fd:
        events = json.load(fd)["traceEvents"]
    rows = attribute(events)
    by_span = defaultdict(lambda: [0.0, 0])
    for (span, _, _), (s, n) in rows.items():
        by_span[span][0] += s
        by_span[span][1] += n
    print(f"{args.trace}: device seconds by the span that launched them")
    for span, (s, n) in sorted(by_span.items(), key=lambda kv: -kv[1][0]):
        print(f"  {s:10.4f} s {n:8d}  {span}")
    print(f"the {args.top} largest (span, operators, kernel) rows")
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:args.top]
    for (span, ops, name), (s, n) in top:
        print(f"  {s:10.4f} s {n:8d}  {span} | {ops or '-'} | {name}")
    if args.json:
        with open(args.json, "w") as fd:
            json.dump([dict(span=span, ops=ops, kernel=name, seconds=s,
                            count=n) for (span, ops, name), (s, n) in
                       sorted(rows.items(), key=lambda kv: -kv[1][0])], fd,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
