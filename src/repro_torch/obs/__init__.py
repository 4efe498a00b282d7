"""Telemetry of the port: the metrics registry (the span tracer, HTTP
exporter and analog-health counters wait in ROADMAP.md queue 1, slice 7)."""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
