"""1 - (the union of the device's operation intervals over the traced
window) / (the window), in percent, in a served cell."""
from bench import stats


def read(ctx):
    if "busy_s" not in ctx or "served_completed" not in ctx:
        return None
    return stats.idle_share(ctx["busy_s"], ctx["trace_window_s"])
