"""Telemetry of the port: the metrics registry and the analog-health
counters (:mod:`.health`); the span tracer and the HTTP exporter wait in
ROADMAP.md queue 1, slice 7."""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
