"""Model-vs-measured reconciliation: the port's copy of ``repro.obs.compare``.

Instrumented spans attach their own prediction as a ``model_s`` attr
(seconds the pricing layer expected); :func:`reconcile` joins measured
span durations against them per component name. The output reuses the
:mod:`repro_torch.analysis.diagnostics` vocabulary: a component whose
measured/modeled ratio leaves ``[1/tolerance, tolerance]`` fires a
warning-severity ``OBS-DRIFT`` finding; components with a zero or absent
model, and traces with nothing to reconcile, get ``OBS-UNMODELED`` info
findings, so "the trace proved nothing" is visible rather than silent.

The distributed executor's traced rounds attach their
:class:`~repro_torch.engine.schedule.ExchangeBill` to every
``exchange``/``compute``/``interior``/``rind`` span
(:mod:`repro_torch.dist.stencil`), and the backends simulator's
``sim.simulate`` span its ``SimResult.model_time_s``
(:mod:`repro_torch.backends.sim`), whose measured/modeled ratio is the
simulation-overhead factor. A served or single-device trace carries no model
and reconciles to ``OBS-UNMODELED``, as the reference's does on such a
trace. The text of every report is the reference's.

The :mod:`repro_torch.analysis` import is deferred into :func:`reconcile`,
so ``repro_torch.obs`` stays importable from the engine's lowest layers.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.trace import span_records

#: Span attr carrying the span's own modeled seconds. Spans may attach
#: any number of ``model_*_s`` components (e.g. a round's full exchange
#: bill); reconciliation joins on this one.
MODEL_ATTR = "model_s"


@dataclasses.dataclass(frozen=True)
class ComponentDrift:
    """Measured-vs-modeled totals for one span name across a trace."""

    component: str
    spans: int
    measured_s: float
    modeled_s: float

    @property
    def ratio(self) -> float:
        """measured / modeled (inf when the model predicted zero)."""
        if self.modeled_s <= 0.0:
            return float("inf")
        return self.measured_s / self.modeled_s

    def describe(self) -> str:
        ratio = f"x{self.ratio:.2f}" if self.modeled_s > 0 else "x-"
        return (f"{self.component:<12s} spans={self.spans:<4d} "
                f"measured={self.measured_s * 1e3:10.3f} ms  "
                f"modeled={self.modeled_s * 1e3:10.3f} ms  drift={ratio}")


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Per-component drift rows plus the structured diagnostics."""

    components: tuple[ComponentDrift, ...]
    report: "object"            # repro_torch.analysis.diagnostics.Report
    tolerance: float

    @property
    def drifting(self) -> tuple[ComponentDrift, ...]:
        return tuple(c for c in self.components
                     if c.modeled_s > 0
                     and not (1 / self.tolerance <= c.ratio
                              <= self.tolerance))

    def describe(self) -> str:
        lines = [f"reconcile (tolerance x{self.tolerance:g}):"]
        if not self.components:
            lines.append("  no modeled spans in trace")
        for c in self.components:
            lines.append("  " + c.describe())
        for d in self.report.diagnostics:
            lines.append("  " + d.describe().replace("\n", "\n  "))
        return "\n".join(lines)


def reconcile(trace, *, tolerance: float = 2.0) -> DriftReport:
    """Join measured span durations against their attached models.

    ``trace`` is anything :func:`repro_torch.obs.trace.span_records`
    accepts: a live :class:`~repro_torch.obs.trace.Tracer`, a Chrome-trace dict, a raw
    event list, or a path to a trace file — reconciling a reloaded file
    gives the same report as the in-memory tracer. Spans participate by
    carrying a ``model_s`` attr; totals group by span name (so every
    ``exchange`` span across every round folds into one ``exchange``
    component). A component whose measured/modeled ratio leaves
    ``[1/tolerance, tolerance]`` fires a warning-severity ``OBS-DRIFT``
    diagnostic; zero-model components and empty traces fire
    ``OBS-UNMODELED`` info findings.
    """
    from repro_torch.analysis.diagnostics import Report, info, warning

    totals: dict[str, list] = {}
    for rec in span_records(trace):
        attrs = rec["attrs"]
        if MODEL_ATTR not in attrs:
            continue
        try:
            modeled = float(attrs[MODEL_ATTR])
        except (TypeError, ValueError):
            modeled = -1.0
        node = totals.setdefault(rec["name"], [0, 0.0, 0.0])
        node[0] += 1
        node[1] += rec["dur_us"] / 1e6
        node[2] += modeled if modeled > 0 else 0.0

    components = []
    diags = []
    for name in sorted(totals):
        spans, measured, modeled = totals[name]
        comp = ComponentDrift(component=name, spans=spans,
                              measured_s=measured, modeled_s=modeled)
        components.append(comp)
        if modeled <= 0.0:
            diags.append(info(
                "OBS-UNMODELED", name,
                f"{spans} span(s) carry a non-positive model_s; the "
                f"component cannot be reconciled",
                hint="attach the priced bill (ExchangeBill / sim "
                     "model_time_s) as model_s on the span"))
        elif not (1 / tolerance <= comp.ratio <= tolerance):
            diags.append(warning(
                "OBS-DRIFT", name,
                f"measured {measured:.3e}s vs modeled {modeled:.3e}s over "
                f"{spans} span(s): drift x{comp.ratio:.2f} outside "
                f"[{1 / tolerance:.2f}, {tolerance:.2f}]",
                hint="expected on interpret-mode hosts pricing another "
                     "chip; on fitted hardware, re-fit the device model "
                     "constants or re-measure"))
    if not components:
        diags.append(info(
            "OBS-UNMODELED", "trace",
            "no spans carry a model_s attr; nothing to reconcile",
            hint="run an instrumented path (e.g. a distributed solve "
                 "with --trace) that attaches modeled bills"))
    return DriftReport(components=tuple(components),
                       report=Report(tuple(diags)), tolerance=tolerance)
