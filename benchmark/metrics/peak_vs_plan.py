"""peak_vs_plan: the window's measured device peak over the planner's
forecast for the engine it chose (plan()["device_bytes"])."""


def read(run):
    peak = max(r["peak"] for r in run["records"])
    plan = run["plan"]["device_bytes"]
    return peak / plan if peak > 0 and plan > 0 else None
