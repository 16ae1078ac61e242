"""handoff_alloc_s: the program's timings["handoff_alloc_s"], the seconds
of page-locked allocation on the entry's own thread from the end of the
collapse cycle to the entry's return (the dense engine's FmaxPDF counts,
cell indices and F and every table; the out-of-core engine's cell
indices and F), the mean per realization.  None from a program without
it."""


def read(run):
    vals = [r["timings"].get("handoff_alloc_s") for r in run["records"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
