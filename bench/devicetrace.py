"""The device's side of a traced window, from ``torch.profiler``.

:func:`window` profiles the host and the card over a block of work and
hands back the raw events; :func:`reduce` turns them into the seconds in
which an operation ran on the device (the union of every kernel, copy
and fill interval), the operations that took the most time, and the
longest idle gaps named by what the host was doing when they began: the
innermost host event open on the launching thread at that moment, under
the benchmark's own label (``bench.*``) around it.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch
from torch.autograd import DeviceType

from bench import stats

_CUDA = DeviceType.CUDA


class Recording:
    """What a traced window leaves: its length and its raw events."""

    def __init__(self):
        self.window_s = None
        self.events = None


@contextlib.contextmanager
def window(device: torch.device):
    """Profile the block; the window runs from a synchronized start to a
    synchronized end."""
    from torch.profiler import ProfilerActivity, profile
    rec = Recording()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield rec
        torch.cuda.synchronize(device)
        rec.window_s = time.perf_counter() - t0
    rec.events = [(e.name(), e.device_type() == _CUDA, e.start_ns(),
                   e.start_ns() + e.duration_ns(), e.start_thread_id())
                  for e in prof.profiler.kineto_results.events()
                  if not _label_on_device(e)]


def _label_on_device(e) -> bool:
    """The device's copy of a host label, which is no device work."""
    return e.device_type() == _CUDA and (e.is_user_annotation()
                                         or e.name().startswith("bench."))


def label(name: str, on: bool):
    """A host label the gaps are named by (nothing when not tracing)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def reduce(events, top: int = 10) -> dict:
    """``events`` as ``(name, on_device, start_ns, end_ns, thread)``:
    busy seconds, the ``top`` device operations by seconds, and the
    ``top`` idle gaps by seconds, summed by what the thread that opened
    the most host events was doing."""
    dev = [(a, b) for _, on, a, b, _ in events if on and b > a]
    if not dev:
        return {"busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    by_op = collections.Counter()
    for name, on, a, b, _ in events:
        if on:
            by_op[name] += (b - a) * 1e-9
    threads = collections.Counter(t for _, on, _, _, t in events if not on)
    main = threads.most_common(1)[0][0] if threads else None
    host = [(a, b, name) for name, on, a, b, tid in events
            if not on and tid == main]
    host.sort()
    starts = [h[0] for h in host]
    by_gap = collections.Counter()
    for a, b in stats.gaps(dev):
        by_gap[_doing(host, starts, a)] += (b - a) * 1e-9
    return {"busy_s": stats.union_length(dev) * 1e-9,
            "device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_gap.most_common(top)]}


def _doing(host, starts, at) -> str:
    """``label/innermost`` host event open at ``at``."""
    i = bisect.bisect_right(starts, at)
    inner = outer = None
    # Host events nest on one thread: walk back over those that started
    # before ``at`` and keep the latest still open, and the latest
    # benchmark label still open.
    for a, b, name in reversed(host[max(0, i - 4096):i]):
        if b > at:
            if inner is None:
                inner = name
            if name.startswith("bench."):
                outer = name
                break
    if inner is None:
        return "no host event"
    return inner if outer in (None, inner) else f"{outer}/{inner}"
