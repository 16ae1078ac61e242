"""cycle_s: the program's timings["fmax_loop"] (the collapse cycle over the
radii, ended by a device sync), the mean per realization."""


def read(run):
    vals = [r["timings"].get("fmax_loop") for r in run["records"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
