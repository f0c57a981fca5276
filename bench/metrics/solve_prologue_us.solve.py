"""A solve's prologue in µs: the mean, over the window's ``engine.run``
spans, of the time from its start to the start of its
``engine.launches`` span (the schedule and the ping-pong buffers), over
which the card idles after each synchronized solve."""
from bench import spans


def read(ctx):
    offsets = spans.first_child_offsets(ctx, "engine.run", "engine.launches")
    if not offsets:
        return None
    return sum(offsets) / len(offsets)
