"""ooc_lpt_s: the out-of-core engine's timings["lpt"] after the join, the
sum of its synced phases sources, fold, spectra and lpt_rows, the mean per
realization.  Nothing to read on the dense engine."""


def read(run):
    if run["engine"] != "ooc":
        return None
    vals = [r["timings"].get("lpt") for r in run["records"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
