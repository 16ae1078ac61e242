"""pinned_gib: GiB of page-locked host memory allocated per realization
(each block rounded up to 2 MiB), from the program's process total
kernels.HOST_COUNTS["pinned_alloc"]["bytes"], which each record's
timings["pinned_alloc_bytes_total"] holds from the join of its hand-off:
the last record's total less the first's, over the records between them.
None with one record, or from a program without the counter."""


def read(run):
    vals = [r["timings"].get("pinned_alloc_bytes_total")
            for r in run["records"]]
    if len(vals) < 2 or vals[0] is None or vals[-1] is None:
        return None
    return (vals[-1] - vals[0]) / (len(vals) - 1) / 2 ** 30
