"""The port's spans in a traced window, as the per-layer metrics read
them: ``ctx["span_records"]`` holds ``repro_torch.obs.span_records`` of
a ``repro_torch.obs.Tracer`` installed around the window alone, each
record ``{"name", "path", "ts_us", "dur_us", "attrs"}``. A reader finds
nothing, and returns None, where the key or its spans are missing."""
from __future__ import annotations

import bisect


def named(ctx: dict, name: str) -> list[dict]:
    """The window's spans called ``name``, in order of their start."""
    recs = [r for r in ctx.get("span_records") or () if r["name"] == name]
    return sorted(recs, key=lambda r: r["ts_us"])


def first_child_offsets(ctx: dict, parent: str, child: str) -> list[float]:
    """For each ``parent`` span with a ``child`` directly under it, the
    µs from the parent's start to its first such child's start. Spans of
    one name do not overlap on the thread that opens them, so a child
    belongs to the last parent that started before it."""
    parents = named(ctx, parent)
    starts = [p["ts_us"] for p in parents]
    first: dict[int, float] = {}
    for c in named(ctx, child):
        if len(c["path"]) < 2 or c["path"][-2] != parent:
            continue
        i = bisect.bisect_right(starts, c["ts_us"]) - 1
        if i < 0 or c["ts_us"] > starts[i] + parents[i]["dur_us"]:
            continue
        first.setdefault(i, c["ts_us"] - starts[i])
    return [first[i] for i in sorted(first)]


def queue_waits_us(ctx: dict) -> list[float]:
    """For each request finished in the window, the µs from the start of
    its ``serve.submit`` to the start of the first ``serve.block`` whose
    ``requests`` hold its id."""
    submitted = {r["attrs"].get("request"): r["ts_us"]
                 for r in named(ctx, "serve.submit")}
    dispatched: dict[int, float] = {}
    for b in named(ctx, "serve.block"):
        for rid in b["attrs"].get("requests") or ():
            dispatched.setdefault(rid, b["ts_us"])
    waits = []
    # One result copy a request finished in the window.
    for c in named(ctx, "serve.result_copy"):
        rid = c["attrs"].get("request")
        if rid in submitted and rid in dispatched:
            waits.append(dispatched[rid] - submitted[rid])
    return waits
