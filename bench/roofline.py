"""The least time of a window's work, from the spec and the shapes alone.

Never from launches, ``t`` or kernel variants: the same work reads the
same whatever implements it. A ``taps``-tap linear stencil needs at least
``taps`` operations per interior point per sweep, in f32 for both grid
dtypes (the spec sums its taps in f32); a solve needs its grid read once
and its interior written once. The least time is the larger of the two
at the card's published peaks (NVIDIA's H100 SXM data sheet, dense, at
its 700 W limit).
"""
from __future__ import annotations

#: Published peaks of one card, by ``torch.cuda.get_device_name()``
#: prefix: f32 operations a second outside the tensor cores, HBM bytes a
#: second.
PEAKS = {"NVIDIA H100": {"f32_flops": 67e12, "hbm_bytes": 3.35e12}}

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def peaks(device_name: str) -> dict:
    for prefix, p in PEAKS.items():
        if device_name.startswith(prefix):
            return p
    raise KeyError(f"no published peaks for {device_name!r}")


def solve_flops(ny: int, nx: int, taps: int, sweeps: int) -> float:
    """Operations one solve needs: ``taps`` a point a sweep."""
    return float(taps) * ny * nx * sweeps


def solve_bytes(ny: int, nx: int, r: int, dtype: str) -> float:
    """Bytes one solve needs: the ringed grid read once, the interior
    written once."""
    return float((ny + 2 * r) * (nx + 2 * r) + ny * nx) * DTYPE_BYTES[dtype]


def least_time(flops: float, nbytes: float,
               device_name: str) -> tuple[float, str]:
    """Seconds the work needs at least on one card, and which term
    bounds it (``"arithmetic"`` or ``"memory"``)."""
    p = peaks(device_name)
    arith = flops / p["f32_flops"]
    mem = nbytes / p["hbm_bytes"]
    return (arith, "arithmetic") if arith >= mem else (mem, "memory")
