"""Observability for the port: the counter registry and span tracer,
copied verbatim from the reference package."""
from .registry import Registry, get_registry, inc, set_gauge
from .tracing import (NULL_SPAN, Span, Tracer, get_tracer, set_tracer,
                      span, trace_event)

__all__ = [
    "NULL_SPAN", "Registry", "Span", "Tracer", "get_registry",
    "get_tracer", "inc", "set_gauge", "set_tracer", "span",
    "trace_event",
]
