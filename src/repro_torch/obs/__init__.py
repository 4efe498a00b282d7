"""Telemetry of the port: the metrics registry, the span tracer
(:mod:`.trace`) and the analog-health counters (:mod:`.health`); the HTTP
exporter waits in ROADMAP.md queue 1, slice 7."""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
