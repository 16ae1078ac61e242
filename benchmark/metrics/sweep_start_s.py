"""sweep_start_s: the entry's seconds from its call to its return, when the
counts, cell indices and F are on the host and the sweep could start
behind the watermark; the mean over the window's realizations."""


def read(run):
    recs = run["records"]
    return sum(r["entry_s"] for r in recs) / len(recs)
