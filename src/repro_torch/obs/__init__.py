"""Telemetry of the port: the metrics registry (:mod:`.metrics`), the span
tracer (:mod:`.trace`, ``torch.profiler`` windows included) and the
analog-health counters (:mod:`.health`); :mod:`.http` serves the first two
over HTTP (``launch/serve.py --metrics-port``)."""

from . import health
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .trace import SpanTracer, configure, get_tracer, profile_window

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanTracer",
    "configure",
    "get_registry",
    "get_tracer",
    "health",
    "profile_window",
]
