"""repro_torch.obs — spans, metrics and reconciliation for the port
(stdlib only).

Own copies of ``repro.obs.trace``, ``repro.obs.metrics`` and
``repro.obs.compare`` with the same span and counter names; the port
imports nothing of ``repro``. Inspect a trace with
``python -m repro_torch.obs summarize|validate PATH``.
"""
from repro_torch.obs import metrics  # noqa: F401
from repro_torch.obs.compare import (ComponentDrift,  # noqa: F401
                                     DriftReport, reconcile)
from repro_torch.obs.trace import (NULL_SPAN, CounterEvent, Span,  # noqa: F401
                                   SpanEvent, Tracer, counter,
                                   counter_records, get_tracer, load_trace,
                                   set_tracer, span, span_records,
                                   summarize_spans, use_tracer, write_trace)
