"""1 - (the union of the device's operation intervals over the traced
window) / (the window), in percent, in a cell of solves one at a time."""
from bench import stats


def read(ctx):
    if "busy_s" not in ctx or "work_points" not in ctx:
        return None
    return stats.idle_share(ctx["busy_s"], ctx["trace_window_s"])
