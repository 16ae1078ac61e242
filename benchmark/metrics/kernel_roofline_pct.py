"""kernel_roofline_pct: the hand-written kernels' share of their roofline
in the traced window: the sum of the bound times of the operations of
roofline/ (not the library's) whose kernels ran, times the realizations
traced, over the device time the profiler gives those kernels."""

from benchmark import roofline


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    sh = roofline.shapes(run)
    bound = spent = 0.0
    for op in run["ops"]:
        if op.get("library"):
            continue
        t = roofline.kernel_seconds(op, tr["kernels"])
        b = roofline.work(op, sh)[2] * tr["realizations"]
        if t > 0 and b > 0:
            bound += b
            spent += t
    return 100.0 * bound / spent if spent > 0 else None
