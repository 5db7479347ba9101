"""Solve-wide observability (port of `repro.obs`): the span tracer under
the reference's span names, the pull-based metrics registry, convergence
tracking with an ETA, and the trace report (`python -m
repro_torch.obs.report TRACE --validate`).

Entry point: `core.solve(op, nev, method=..., trace=...)` installs a
tracer for the solve's duration. With tracing disabled every
instrumentation point is a no-op guard (a module-global None check).
"""
from repro_torch.obs.trace import (NULL_SPAN, SCHEMA, Span, Tracer, active,
                                   event, span, tracing)
from repro_torch.obs.metrics import (MetricsRegistry, delta, derive, gauges,
                                     snapshot_counters, snapshot_store)
from repro_torch.obs.progress import ConvergenceTracker

__all__ = [
    "NULL_SPAN", "SCHEMA", "Span", "Tracer", "active", "event", "span",
    "tracing",
    "MetricsRegistry", "delta", "derive", "gauges", "snapshot_counters",
    "snapshot_store",
    "ConvergenceTracker",
]
