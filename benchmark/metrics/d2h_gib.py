"""d2h_gib: GiB copied from the device to the host per realization, from
the program's process total kernels.HOST_COUNTS["d2h"]["bytes"], which
each record's timings["d2h_bytes_total"] holds from the join of its
hand-off: the last record's total less the first's, over the records
between them.  None with one record, or from a program without the
counter."""


def read(run):
    vals = [r["timings"].get("d2h_bytes_total") for r in run["records"]]
    if len(vals) < 2 or vals[0] is None or vals[-1] is None:
        return None
    return (vals[-1] - vals[0]) / (len(vals) - 1) / 2 ** 30
