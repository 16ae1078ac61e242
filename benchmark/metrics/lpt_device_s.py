"""lpt_device_s: the dense engine's timings["lpt"] after the join, the
device's seconds between two CUDA events on the compute stream, one before
the displacement sources and one after the last set's row gather, the mean
per realization.  Nothing to read on the out-of-core engine (ooc_lpt_s
reads its phases), nor from a program whose timings lack handoff_alloc_s:
that program stamps the dense lpt with the host's enqueue time."""


def read(run):
    if run["engine"] != "dense":
        return None
    recs = [r["timings"] for r in run["records"]]
    vals = [t["lpt"] for t in recs if "lpt" in t and "handoff_alloc_s" in t]
    return sum(vals) / len(vals) if vals else None
