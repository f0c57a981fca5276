"""Contextvar-scoped tracing: nested spans -> Chrome-trace JSON.

The port's own copy of ``repro.obs.trace`` (stdlib only), with the same
span names, so a trace of either package reads the same: ``engine.run``,
``engine.run_converged`` and ``engine.build_schedule``. The port adds
``engine.launches`` (a schedule's loop of kernel launches) and
``serve.result_copy`` (a served result's host copy), and request ids on
the ``serve.*`` spans.

**Disabled by default**: until a :class:`Tracer` is installed
(``set_tracer`` / ``use_tracer``), the module-level :func:`span` returns
one shared no-op singleton, so instrumented paths cost nothing when
nobody is watching.

With a tracer installed, ``with span(name, **attrs) as sp`` records a
frozen :class:`SpanEvent` on exit (start/duration in microseconds since
the tracer's epoch, the nesting path, and the attrs; ``sp.set(...)``
adds more mid-span). Counter *tracks* (:meth:`Tracer.counter`) record
time series. Export surfaces:

* :meth:`Tracer.write_trace` — Chrome-trace/Perfetto JSON; spans are
  ``ph: "X"`` complete events, counters ``ph: "C"`` tracks, attrs ride
  in ``args``.
* :meth:`Tracer.summary` / :meth:`Tracer.describe` — a structured tree
  aggregated by span path (count, total, mean), for terminal output.

Spans time the host: on a CUDA tensor a span around launches measures
their enqueue unless the caller synchronizes inside it. While
``torch.profiler`` records, a span also enters
``torch.profiler.record_function(<name>)`` for its extent, so the
profiler's trace shows it as a host event on the device's clock, around
the launches it made. The module imports no torch: it finds torch among
the loaded modules, and only when a span opens on an installed tracer.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import sys
import threading
import time

_TRACER: contextvars.ContextVar["Tracer | None"] = contextvars.ContextVar(
    "repro_torch_obs_tracer", default=None)


def _jsonable(v):
    """Coerce an attr value into something json.dump accepts verbatim."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One finished span: what ran, where in the tree, for how long."""

    name: str
    path: tuple[str, ...]     # names from root to this span
    ts_us: float              # start, microseconds since tracer epoch
    dur_us: float
    pid: int
    tid: int
    attrs: dict


@dataclasses.dataclass(frozen=True)
class CounterEvent:
    """One sample of a counter track (Chrome ``ph: "C"``)."""

    name: str
    ts_us: float
    values: dict              # series name -> numeric value
    pid: int
    tid: int


class _NullSpan:
    """The disabled path: one shared instance, every method a no-op."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def _profiler_mark(name: str):
    """``torch.profiler.record_function(name)``, entered, while torch's
    profiler records; else None (torch not loaded, or not recording)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    mark = torch.profiler.record_function(name)
    mark.__enter__()
    return mark


class Span:
    """A live span; records a frozen :class:`SpanEvent` on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_mark")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._stack.append(self.name)
        self._mark = _profiler_mark(self.name)
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._now_us()
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        stack = self._tracer._stack
        path = tuple(stack)
        stack.pop()
        self._tracer._emit(SpanEvent(
            name=self.name, path=path, ts_us=self._t0,
            dur_us=t1 - self._t0, pid=self._tracer.pid,
            tid=threading.get_ident() & 0x7FFFFFFF,
            attrs={k: _jsonable(v) for k, v in self.attrs.items()}))
        return False


class Tracer:
    """Collects span + counter events; export via :meth:`write_trace`.

    ``sink``, if given, is called with every :class:`SpanEvent` as it
    closes (live progress reporting); sink exceptions propagate — a
    broken sink is a caller bug, not something to swallow silently.
    """

    def __init__(self, *, sink=None):
        self.events: list[SpanEvent] = []
        self.counters: list[CounterEvent] = []
        self.sink = sink
        self.pid = os.getpid()
        self._epoch = time.perf_counter()
        self._stack: list[str] = []

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _emit(self, event: SpanEvent) -> None:
        self.events.append(event)
        if self.sink is not None:
            self.sink(event)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def counter(self, name: str, values: dict, *,
                ts_us: float | None = None) -> None:
        """Record one sample of a counter track (``values`` is
        ``{series: number}`` — multiple series share one track)."""
        self.counters.append(CounterEvent(
            name=name, ts_us=self._now_us() if ts_us is None else ts_us,
            values={str(k): float(v) for k, v in values.items()},
            pid=self.pid, tid=threading.get_ident() & 0x7FFFFFFF))

    # ------------------------------------------------------------ export

    def to_chrome(self) -> dict:
        """The Chrome-trace JSON object (``traceEvents`` array format)."""
        evs = []
        for e in self.events:
            evs.append({"name": e.name, "cat": "repro", "ph": "X",
                        "ts": round(e.ts_us, 3), "dur": round(e.dur_us, 3),
                        "pid": e.pid, "tid": e.tid,
                        "args": dict(e.attrs, _path="/".join(e.path))})
        for c in self.counters:
            evs.append({"name": c.name, "cat": "repro", "ph": "C",
                        "ts": round(c.ts_us, 3), "pid": c.pid, "tid": c.tid,
                        "args": dict(c.values)})
        evs.sort(key=lambda ev: ev["ts"])
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")

    def summary(self) -> dict:
        """Aggregate stats per span path: ``{path_tuple: {count,
        total_us, min_us, max_us}}`` — the structured summary tree."""
        return summarize_spans(span_records(self))

    def describe(self) -> str:
        return describe_summary(self.summary())


# ---------------------------------------------------------------- module API

def get_tracer() -> Tracer | None:
    return _TRACER.get()


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` for the current context (None disables)."""
    _TRACER.set(tracer)
    return tracer


@contextlib.contextmanager
def use_tracer(tracer: Tracer | None):
    """Scoped install: spans inside the ``with`` record into ``tracer``."""
    token = _TRACER.set(tracer)
    try:
        yield tracer
    finally:
        _TRACER.reset(token)


def span(name: str, **attrs):
    """A span against the installed tracer — or the shared no-op when
    none is installed (the disabled path allocates nothing)."""
    tracer = _TRACER.get()
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, **attrs)


def counter(name: str, values: dict) -> None:
    """Record a counter-track sample on the installed tracer (no-op
    when none is installed)."""
    tracer = _TRACER.get()
    if tracer is not None:
        tracer.counter(name, values)


def write_trace(path: str) -> None:
    """Write the installed tracer's Chrome trace to ``path``."""
    tracer = _TRACER.get()
    if tracer is None:
        raise RuntimeError("obs.write_trace: no tracer installed "
                           "(set_tracer/use_tracer first)")
    tracer.write_trace(path)


# ------------------------------------------------------- trace normalization

def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def span_records(source) -> list[dict]:
    """Normalize a trace into span records.

    ``source`` may be a live :class:`Tracer`, a Chrome-trace dict, a raw
    ``traceEvents`` list, or a path to a trace file. Returns
    ``[{"name", "path", "ts_us", "dur_us", "attrs"}, ...]`` (``ts_us`` the
    start since the tracer's epoch), identical whether the trace is in
    memory or reloaded from disk: times are rounded as the Chrome export
    rounds them.
    """
    if isinstance(source, Tracer):
        return [{"name": e.name, "path": e.path, "ts_us": round(e.ts_us, 3),
                 "dur_us": round(e.dur_us, 3), "attrs": dict(e.attrs)}
                for e in source.events]
    if isinstance(source, str):
        source = load_trace(source)
    events = source.get("traceEvents", []) if isinstance(source, dict) \
        else source
    recs = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        attrs = dict(ev.get("args") or {})
        path = tuple(str(attrs.pop("_path", ev.get("name", ""))).split("/"))
        recs.append({"name": ev.get("name", ""), "path": path,
                     "ts_us": float(ev.get("ts", 0.0)),
                     "dur_us": float(ev.get("dur", 0.0)), "attrs": attrs})
    return recs


def counter_records(source) -> list[dict]:
    """Counter-track samples from a trace (same sources as
    :func:`span_records`): ``[{"name", "ts_us", "values"}, ...]``."""
    if isinstance(source, Tracer):
        return [{"name": c.name, "ts_us": c.ts_us, "values": dict(c.values)}
                for c in source.counters]
    if isinstance(source, str):
        source = load_trace(source)
    events = source.get("traceEvents", []) if isinstance(source, dict) \
        else source
    return [{"name": ev.get("name", ""), "ts_us": float(ev.get("ts", 0.0)),
             "values": dict(ev.get("args") or {})}
            for ev in events if ev.get("ph") == "C"]


def summarize_spans(records: list[dict]) -> dict:
    """Aggregate span records per path (the structured summary tree)."""
    agg: dict[tuple, dict] = {}
    for rec in records:
        node = agg.setdefault(rec["path"], {
            "count": 0, "total_us": 0.0, "min_us": float("inf"),
            "max_us": 0.0})
        node["count"] += 1
        node["total_us"] += rec["dur_us"]
        node["min_us"] = min(node["min_us"], rec["dur_us"])
        node["max_us"] = max(node["max_us"], rec["dur_us"])
    return agg


def describe_summary(summary: dict) -> str:
    """Render a path-aggregated summary as an indented tree."""
    if not summary:
        return "trace: no spans recorded"
    lines = ["span tree (count, total, mean):"]
    for path in sorted(summary):
        node = summary[path]
        mean = node["total_us"] / max(node["count"], 1)
        indent = "  " * (len(path) - 1)
        lines.append(f"  {indent}{path[-1]:<{max(28 - len(indent), 1)}s} "
                     f"x{node['count']:<4d} {node['total_us'] / 1e3:10.2f} ms "
                     f"(mean {mean / 1e3:8.3f} ms)")
    return "\n".join(lines)
