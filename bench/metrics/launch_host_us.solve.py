"""The host's µs a kernel launch: the summed duration of the window's
``engine.launches`` spans (each the whole loop of wrapper calls of one
``engine.run``: plan, checks, the card's context, the library's handle
and the ctypes call) over the launches they count."""
from bench import spans


def read(ctx):
    recs = spans.named(ctx, "engine.launches")
    launches = sum(r["attrs"].get("launches", 0) for r in recs)
    if not launches:
        return None
    return sum(r["dur_us"] for r in recs) / launches
