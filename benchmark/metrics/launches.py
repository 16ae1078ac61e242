"""launches: the port's kernel launches per realization
(sum(kernels.LAUNCHES.values()), reset at each realization's start), the
mean over the window."""


def read(run):
    recs = run["records"]
    return sum(sum(r["launches"].values()) for r in recs) / len(recs)
