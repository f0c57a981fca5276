"""CLI for trace files: ``python -m repro_torch.obs {summarize,validate} t.json``.

The port's copy of ``python -m repro.obs``. ``summarize`` prints the span
tree, counter tracks, and the model-vs-measured drift report for a
Chrome-trace JSON written by ``obs.write_trace`` (e.g.
``launch/solve.py --serve --trace``). ``validate`` checks the file is
well-formed Chrome trace (every event carries ``ph``/``ts``/``pid``;
complete events also ``name``/``dur``) and exits nonzero otherwise.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.obs.compare import reconcile
from repro_torch.obs.trace import (counter_records, describe_summary, load_trace,
                             span_records, summarize_spans)


def validate(path: str) -> int:
    try:
        trace = load_trace(path)
    except (OSError, json.JSONDecodeError) as e:
        print(f"validate: cannot load {path}: {e}")
        return 1
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        print(f"validate: {path} has no traceEvents array")
        return 1
    bad = 0
    spans = counters = 0
    for i, ev in enumerate(events):
        missing = [k for k in ("ph", "ts", "pid") if k not in ev]
        if ev.get("ph") == "X":
            spans += 1
            missing += [k for k in ("name", "dur") if k not in ev]
        elif ev.get("ph") == "C":
            counters += 1
        if missing:
            bad += 1
            print(f"validate: event[{i}] missing {missing}: {ev}")
    if bad:
        print(f"validate: {path}: {bad} malformed event(s)")
        return 1
    print(f"validate: {path} ok — {len(events)} events "
          f"({spans} spans, {counters} counter samples)")
    return 0


def summarize(path: str, *, tolerance: float) -> int:
    trace = load_trace(path)
    records = span_records(trace)
    print(describe_summary(summarize_spans(records)))
    tracks = sorted({c["name"] for c in counter_records(trace)})
    if tracks:
        print(f"counter tracks: {', '.join(tracks)}")
    print(reconcile(trace, tolerance=tolerance).describe())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="inspect Chrome-trace JSON written by repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize",
                           help="span tree + counters + drift report")
    p_sum.add_argument("trace")
    p_sum.add_argument("--tolerance", type=float, default=2.0,
                       help="reconcile drift tolerance (default 2.0)")
    p_val = sub.add_parser("validate",
                           help="check the file is well-formed Chrome trace")
    p_val.add_argument("trace")
    args = ap.parse_args(argv)
    if args.cmd == "validate":
        return validate(args.trace)
    return summarize(args.trace, tolerance=args.tolerance)


if __name__ == "__main__":
    raise SystemExit(main())
