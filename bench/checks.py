"""What a run must hold to: no JAX in the process, and the port's answers
equal to the plain reference's.

The comparisons are exact. The port's kernels compute the spec's f32
operations in the spec's order and flush as it flushes, so a sound run
gives the reference's bits; any other arithmetic (the control sums its
taps in bfloat16) or a lost or altered answer reads above 0.
"""
from __future__ import annotations

import math
import sys

import torch

#: Top-level module names that must not be loaded, compared whole: the
#: JAX stack and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: What a non-finite gap is reported as (it fails every limit).
NON_FINITE = 3.0e38


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.partition(".")[0] for m in (modules if modules is not None
                                           else list(sys.modules))}
    return sorted(n for n in FORBIDDEN if n in names)


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` in f32; NaN, an infinity or a shape
    that differs reads :data:`NON_FINITE`."""
    if got.shape != want.shape:
        return NON_FINITE
    d = (got.to(want.device, torch.float32) - want.to(torch.float32)).abs()
    v = float(d.max()) if d.numel() else 0.0
    return v if math.isfinite(v) else NON_FINITE


def abs_gap(got, want) -> float:
    """``|got - want|`` of two numbers; a missing or non-finite one reads
    :data:`NON_FINITE`."""
    if got is None or want is None:
        return NON_FINITE
    d = abs(float(got) - float(want))
    return d if math.isfinite(d) else NON_FINITE


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit)}


def passed(checks: list[dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks)


def merge(checks: list[dict]) -> list[dict]:
    """One entry a name: the largest value (the limits agree)."""
    out: dict[str, dict] = {}
    for c in checks:
        if c["name"] not in out or c["value"] > out[c["name"]]["value"]:
            out[c["name"]] = c
    return list(out.values())
