"""The fast-memory budget sentence, as ``repro.analysis.diagnostics`` words it.

Only :func:`budget_message` is needed by the port's planner so far; the
diagnostic vocabulary and reports come with the analysis layer.
"""
from __future__ import annotations


def budget_message(what: str, needed_bytes: int, device) -> str:
    """The one device/budget sentence every fast-memory error shares."""
    return (f"{what} needs ~{needed_bytes / 2**20:.2f} MiB of fast memory; "
            f"{device.name} has {device.fast_memory_bytes / 2**20:.2f} MiB "
            f"per core")
