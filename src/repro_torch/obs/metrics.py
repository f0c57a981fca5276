"""Process-local metrics: counters, gauges, histograms, JSON snapshot.

The port's own copy of ``repro.obs.metrics`` (stdlib only), recording the
same names (``engine.plan.hit`` / ``engine.plan.miss``). Metrics are
always live, process-local and additive: tests that assert deltas
snapshot before/after or call :func:`reset`. :func:`snapshot` returns
plain JSON-able dicts (histograms summarize to
count/sum/min/max/mean/p50/p95/p99).
"""
from __future__ import annotations


def percentile(samples: list[float], q: float) -> float:
    """Linear-interpolated percentile of ``samples`` (q in [0, 100])."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] + (xs[hi] - xs[lo]) * frac)


class Counter:
    """A monotonically-increasing count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """A point-in-time value (last write wins)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """A sample distribution summarized as count/sum/percentiles."""

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def summary(self) -> dict:
        xs = self.samples
        return {
            "count": len(xs),
            "sum": float(sum(xs)),
            "min": float(min(xs)) if xs else 0.0,
            "max": float(max(xs)) if xs else 0.0,
            "mean": float(sum(xs) / len(xs)) if xs else 0.0,
            "p50": percentile(xs, 50),
            "p95": percentile(xs, 95),
            "p99": percentile(xs, 99),
        }


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> dict:
        """JSON-able view: counter/gauge values, histogram summaries."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


#: The process-wide default registry every instrumented module records to.
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
