"""Span tracer, under the reference's span names (metrics, progress and
report are still to port)."""
from repro_torch.obs.trace import (NULL_SPAN, SCHEMA, Span, Tracer, active,
                                   event, span, tracing)

__all__ = ["NULL_SPAN", "SCHEMA", "Span", "Tracer", "active", "event",
           "span", "tracing"]
