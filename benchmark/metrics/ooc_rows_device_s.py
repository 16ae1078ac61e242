"""ooc_rows_device_s: the out-of-core engine's timings["rows_device_s"]
after the join, the device's seconds between two CUDA events on the row
phase's compute stream (one before set 0's first build, one after the last
set's last K12), the mean per realization.  Nothing to read on the dense
engine, nor from a program that does not time its row phase on the
device."""


def read(run):
    if run["engine"] != "ooc":
        return None
    vals = [r["timings"].get("rows_device_s") for r in run["records"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
