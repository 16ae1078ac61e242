"""setup_s: seconds from the process's start to the first timed
realization (the kernel library, Params, cosmology and scale-dependent
growth, the plan, the warm realization)."""


def read(run):
    return run["setup_s"]
