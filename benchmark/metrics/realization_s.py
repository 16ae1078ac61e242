"""realization_s: the window's seconds over the realizations it completed,
each from its entry's call until its last row has landed on the host and
its products have been dropped.  Everything between realizations (the
release of the products kept for the check when another replaces them)
falls inside the window and so inside the metric."""


def read(run):
    return run["window_s"] / len(run["records"])
