"""Observability for the port: the counter registry and the span tracer,
whose spans share a clock with the device trace (``tracing.py``)."""
from .registry import Registry, get_registry, inc, set_gauge
from .tracing import (NULL_SPAN, Span, Tracer, anchors, get_tracer,
                      set_tracer, span, to_trace_us, trace_event)

__all__ = [
    "NULL_SPAN", "Registry", "Span", "Tracer", "anchors", "get_registry",
    "get_tracer", "inc", "set_gauge", "set_tracer", "span",
    "to_trace_us", "trace_event",
]
