"""handoff_return_s: the program's timings["handoff_return"], seconds after
the collapse cycle until the entry returns, the mean per realization."""


def read(run):
    vals = [r["timings"].get("handoff_return") for r in run["records"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
