"""rows_landed_s: the program's timings["handoff_last"], seconds after the
collapse cycle until the last displacement row has landed on the host (the
waiter thread's clock on the copies' events, on both engines), the mean
per realization."""


def read(run):
    vals = [r["timings"].get("handoff_last") for r in run["records"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
