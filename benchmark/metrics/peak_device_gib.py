"""peak_device_gib: the largest torch.cuda.max_memory_allocated() of any
realization of the window (the counters reset at each one's start), GiB."""


def read(run):
    peak = max(r["peak"] for r in run["records"])
    return peak / 2.0 ** 30 if peak > 0 else None
