"""Structured diagnostics: the port's copy of ``repro.analysis.diagnostics``.

Every check in :mod:`repro_torch.analysis` reports through the same
record: a :class:`Diagnostic` names a *stable* code from :data:`CODES`, a
severity, the schedule or request span it anchors to, a human message,
and a fix hint. A :class:`Report` is an ordered bundle of them with the
``ok``/``errors``/``describe()`` surface every caller shares, so a
rejection prints the same way whichever layer caught it. The vocabulary
and the text of ``describe()`` are the reference's, character for
character, so a diagnostic of either package reads the same.

Stdlib only: ``engine.plan`` raises its fast-memory errors through
:func:`budget_message` without importing anything else.
"""
from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning", "info")

#: The stable diagnostic vocabulary. Codes are an API: tests pin them,
#: the README documents them, and tools may filter on them — add new ones
#: rather than renaming.
CODES: dict[str, str] = {
    # Circular-buffer protocol (abstract interpretation of push/pop).
    "CB-UNDECLARED": "an op references a circular buffer the program "
                     "never declares",
    "CB-UNFED": "a consumed circular buffer has no producing op in any "
                "kernel (blocks forever)",
    "CB-OVERFLOW": "statically-derived occupancy exceeds the circular "
                   "buffer's capacity",
    "CB-UNDERFLOW": "a pop executes with no resident entry in the "
                    "circular buffer",
    # Deadlock / pipeline progress.
    "DL-CYCLE": "kernels wait on each other's circular buffers in a cycle",
    "DL-RATE": "per-iteration push/pop counts differ; occupancy drifts "
               "until the pipeline stalls",
    # Address bounds (block-relative accesses vs the DRAM stream extents).
    "AB-ROW": "a block access's row window leaves the stream's row extent",
    "AB-COL": "a block access's column window leaves the stream's column "
              "extent",
    # Device budgets (shared formatting with engine.plan).
    "BUD-SRAM": "summed circular-buffer footprint exceeds the device's "
                "per-core SRAM",
    "BUD-CBFILE": "the program needs more circular buffers than the "
                  "device's per-core CB file holds",
    "BUD-VMEM": "the plan's working set exceeds the device's fast-memory "
                "budget",
    # Schedule feasibility (the gates scattered runtime checks enforce).
    "SCHED-MASK-REMAINDER": "a pin mask requires a fully-fused schedule",
    "SCHED-REMAINDER-FUSED": "the remainder policy must be non-fused",
    "SCHED-MESH-DECOMP": "the grid interior does not decompose over the "
                         "mesh shape",
    "SCHED-OVERLAP-INFEASIBLE": "overlap is selected but the shard has no "
                                "halo-independent interior to hide the "
                                "exchange behind",
    "SCHED-PROG-MISMATCH": "the program disagrees with the schedule it is "
                           "checked against",
    # Solve-serving admission (repro_torch.serve.solve).
    "SCHED-REQUEST-INFEASIBLE": "a solve request cannot be scheduled on "
                                "the serving device (shape/policy/budget)",
    "SCHED-BUCKET-MIX": "a request does not match the batching bucket it "
                        "was routed to (shape/dtype/spec/policy/depth)",
    # Observability reconciliation (repro_torch.obs.compare): measured span
    # durations vs the modeled bills attached to them.
    "OBS-DRIFT": "a traced component's measured duration deviates from "
                 "its attached model beyond the reconcile tolerance",
    "OBS-UNMODELED": "a trace (or component) carries no usable model "
                     "attribution to reconcile against",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, anchored to a span of the program/schedule.

    ``span`` is a short locator such as ``"reader[2] read_block->in"``,
    ``"cb stage"`` or ``"schedule"``; ``hint`` says how to fix it.
    """

    severity: str
    code: str
    span: str
    message: str
    hint: str | None = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}; "
                             f"stable codes: {sorted(CODES)}")

    def describe(self) -> str:
        line = f"{self.severity:7s} {self.code:24s} {self.span}: " \
               f"{self.message}"
        if self.hint:
            line += f"\n{'':7s} hint: {self.hint}"
        return line


@dataclasses.dataclass(frozen=True)
class Report:
    """An ordered bundle of diagnostics with the shared query surface."""

    diagnostics: tuple[Diagnostic, ...] = ()

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "error")

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "warning")

    @property
    def ok(self) -> bool:
        """No error-severity diagnostics (warnings/info do not fail)."""
        return not self.errors

    def __bool__(self) -> bool:  # truthiness = "has findings", not "ok"
        return bool(self.diagnostics)

    def merged(self, other: "Report") -> "Report":
        return Report(self.diagnostics + other.diagnostics)

    def describe(self) -> str:
        if not self.diagnostics:
            return "verification: clean (no diagnostics)"
        head = f"verification: {len(self.errors)} error(s), " \
               f"{len(self.warnings)} warning(s)"
        return "\n".join([head] + [d.describe() for d in self.diagnostics])

    def raise_if_errors(self, exc_type: type[Exception] = ValueError) -> None:
        if not self.ok:
            raise exc_type(self.describe())


def error(code: str, span: str, message: str,
          hint: str | None = None) -> Diagnostic:
    return Diagnostic("error", code, span, message, hint)


def warning(code: str, span: str, message: str,
            hint: str | None = None) -> Diagnostic:
    return Diagnostic("warning", code, span, message, hint)


def info(code: str, span: str, message: str,
         hint: str | None = None) -> Diagnostic:
    return Diagnostic("info", code, span, message, hint)


def budget_message(what: str, needed_bytes: int, device) -> str:
    """The one device/budget sentence every fast-memory error shares.

    ``engine.plan`` (VMEM), ``backends.lower`` via the verifier (SRAM),
    and ``check_schedule`` all format through here, so "how much, on
    what, out of how much" reads identically at every layer.
    """
    return (f"{what} needs ~{needed_bytes / 2**20:.2f} MiB of fast memory; "
            f"{device.name} has {device.fast_memory_bytes / 2**20:.2f} MiB "
            f"per core")
