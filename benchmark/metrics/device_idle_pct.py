"""device_idle_pct: the share of the traced window in which no kernel, copy
or fill ran on the card (torch.profiler's device events)."""


def read(run):
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
