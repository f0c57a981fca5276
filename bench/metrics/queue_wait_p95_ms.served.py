"""The 95th percentile (nearest rank), over the requests finished in the
window, of the time from the start of a request's ``serve.submit`` span
to the start of the first ``serve.block`` span that carries its id, in
ms."""
from bench import spans, stats


def read(ctx):
    waits = spans.queue_waits_us(ctx)
    if not waits:
        return None
    return stats.percentile(waits, 95) / 1e3
