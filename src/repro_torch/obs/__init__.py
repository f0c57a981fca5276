"""repro_torch.obs — spans and metrics for the port (stdlib only).

Own copies of ``repro.obs.trace`` and ``repro.obs.metrics`` with the same
span and counter names; the port imports nothing of ``repro``.
"""
from repro_torch.obs import metrics  # noqa: F401
from repro_torch.obs.trace import (NULL_SPAN, CounterEvent, Span,  # noqa: F401
                                   SpanEvent, Tracer, counter,
                                   counter_records, get_tracer, load_trace,
                                   set_tracer, span, span_records,
                                   summarize_spans, use_tracer, write_trace)
