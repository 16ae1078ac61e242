"""gradient_tab_roofline_pct: the gradient with a growth table's share of
its roofline in the traced window, whichever of its operations the cell
names: kspace_gradient_tab (K8, the dense engine) or
ooc_factors_gradient_tab (K14, the out-of-core engine).  Its bound time
times the realizations traced, over the device time the profiler gives its
kernels.  Nothing to read where the cell names neither or none of their
kernels ran."""

from benchmark import roofline

OPS = ("kspace_gradient_tab", "ooc_factors_gradient_tab")


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    sh = roofline.shapes(run)
    bound = spent = 0.0
    for op in run["ops"]:
        if op["name"] not in OPS:
            continue
        t = roofline.kernel_seconds(op, tr["kernels"])
        if t > 0:
            bound += roofline.work(op, sh)[2] * tr["realizations"]
            spent += t
    return 100.0 * bound / spent if spent > 0 else None
