"""Observability layer: spans, metrics and the typed telemetry-event schema.

The execution-time counterpart of ``repro_torch.telemetry`` (which measures
joules): request-lifecycle and engine-step spans (:mod:`~repro_torch.obs.spans`),
a labeled Counter/Gauge/Histogram registry (:mod:`~repro_torch.obs.metrics`)
and the typed telemetry-event schema (:mod:`~repro_torch.obs.events`). The
timeline exporter (``obs/export.py``) is not ported yet.
"""
from repro_torch.obs.events import (TelemetryEvent, coerce_event,
                                    events_from_meta, events_to_meta,
                                    window_of)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.spans import NULL_SPAN, Span, SpanRecord, Tracer, span_tree

__all__ = [
    "TelemetryEvent", "coerce_event", "events_to_meta", "events_from_meta",
    "window_of",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "Span", "SpanRecord", "NULL_SPAN", "span_tree",
]
