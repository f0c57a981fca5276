"""Device time of a CUDA call, from CUDA events or the profiler.

:func:`device_ms` queues ``inner`` calls behind a spin kernel
(``torch.cuda._sleep``) so the host has enqueued them all before the
start event fires: the events then bracket device work only, not Python
launch overhead. It returns the median over ``reps`` of the per-call
time, in milliseconds. That holds while the host can enqueue the calls
faster than the spin lasts: a call of thousands of small kernels fills
the launch queue, the host then waits on the device, and its gaps are
timed too. :func:`kernel_ms` sums instead the time of every kernel a call
launches, from ``torch.profiler``; :func:`top_kernels` lists the kernels
that take the most of it. CUDA only: a CPU time is never
reported under these names.
"""
from __future__ import annotations

import statistics

import torch

#: Spin cycles queued ahead of each sample (tens of ms on an H100).
SPIN_CYCLES = 50_000_000


def device_ms(fn, *, reps: int = 7, inner: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` (after one warm-up)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times CUDA work and needs a card")
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def _kernels(fn) -> list:
    """The profiler's per-kernel averages of one ``fn()``."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel timing needs a card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if sum(e.self_device_time_total for e in kernels) <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return kernels


def kernel_ms(fn) -> tuple[float, int]:
    """Device milliseconds summed over the kernels one ``fn()`` launches,
    and their number, from ``torch.profiler``."""
    kernels = _kernels(fn)
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def top_kernels(fn, n: int = 8) -> list[tuple[str, float, int]]:
    """The ``n`` kernels of one ``fn()`` with the most device time:
    (name, milliseconds summed over its launches, launches)."""
    kernels = sorted(_kernels(fn), key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in kernels[:n]]
