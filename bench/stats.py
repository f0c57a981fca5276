"""The arithmetic of the numbers a run reports."""
from __future__ import annotations

import math
import statistics


def percentile(samples, q: float) -> float:
    """The ``q``-th percentile (0-100) by nearest rank: the smallest sample
    with at least ``q``% of all samples at or below it."""
    xs = sorted(samples)
    if not xs:
        raise ValueError("percentile of no samples")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def spread(values) -> float:
    """The distance between the first and third quartile, as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def gaps(intervals) -> list[tuple[float, float]]:
    """The holes between the union's pieces."""
    m = merge(intervals)
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)]


def idle_share(busy_s: float, window_s: float) -> float:
    """Percent of the window in which nothing ran on the device."""
    return 100.0 * (1.0 - busy_s / window_s)
