"""The mean duration of the ``serve.result_copy`` spans of the requests
finished in the window, in ms: the host copy of a result, with the wait
for the kernels queued before it on the stream."""
from bench import spans


def read(ctx):
    recs = spans.named(ctx, "serve.result_copy")
    if not recs:
        return None
    return sum(r["dur_us"] for r in recs) / len(recs) / 1e3
