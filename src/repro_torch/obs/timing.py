"""Device time of a CUDA call, from CUDA events.

:func:`device_ms` queues ``inner`` calls behind a spin kernel
(``torch.cuda._sleep``) so the host has enqueued them all before the
start event fires: the events then bracket device work only, not Python
launch overhead. It returns the median over ``reps`` of the per-call
time, in milliseconds. CUDA only: a CPU time is never reported under
this name.
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
