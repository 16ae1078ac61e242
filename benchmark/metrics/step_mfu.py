"""step_mfu: the whole realization's share of the card's float32 peak: the
operations of every roofline/ file (the hand-written kernels' and cuFFT's)
for the realizations traced, over PEAK_OPS times the traced window."""

from benchmark import roofline


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    sh = roofline.shapes(run)
    ops = sum(roofline.work(op, sh)[0] for op in run["ops"])
    return 100.0 * ops * tr["realizations"] / (roofline.PEAK_OPS
                                               * tr["window_s"])
