"""The 95th percentile (nearest rank) of every completed request's
latency, from its submission to its result on the host, over all
requests submitted in the window, in ms."""
from bench import stats


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return stats.percentile(lat, 95) * 1e3
