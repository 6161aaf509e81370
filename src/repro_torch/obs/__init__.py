"""Observability layer: spans, metrics, timeline export.

The execution-time counterpart of ``repro_torch.telemetry`` (which measures
joules): request-lifecycle and engine-step spans (:mod:`~repro_torch.obs.spans`),
a labeled Counter/Gauge/Histogram registry (:mod:`~repro_torch.obs.metrics`),
the typed telemetry-event schema (:mod:`~repro_torch.obs.events`), and
Chrome-trace/Perfetto export that merges spans with ``MonitorSession``
energy windows so every span carries attributed joules
(:mod:`~repro_torch.obs.export`).
"""
from repro_torch.obs.events import (TelemetryEvent, coerce_event,
                                    events_from_meta, events_to_meta,
                                    window_of)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.spans import NULL_SPAN, Span, SpanRecord, Tracer, span_tree
from repro_torch.obs.export import (chrome_trace, parse_chrome_trace,
                                    session_energies, timeline_from_trace,
                                    validate_chrome_trace, write_chrome_trace)

__all__ = [
    "TelemetryEvent", "coerce_event", "events_to_meta", "events_from_meta",
    "window_of",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "Span", "SpanRecord", "NULL_SPAN", "span_tree",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "parse_chrome_trace", "timeline_from_trace", "session_energies",
]
