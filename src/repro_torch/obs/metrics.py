"""Low-overhead metrics registry: counters / gauges / histograms with labels.

A copy of the JAX package's stdlib-only ``repro.obs.metrics`` (the port
imports nothing of ``repro``); the serving Scheduler needs it.

The serving engine, trainer and benchmarks record into ONE
:class:`MetricsRegistry` per component (the engine's Scheduler owns one by
default; pass a shared registry to aggregate several components). Design
constraints, in order:

  * **hot-path cost**: a counter increment is one dict-free attribute add
    under a lock (label resolution is cached on first use, so steady-state
    ``labels()`` is a tuple-keyed dict hit). Nothing allocates per
    observation except the histogram's bucket index.
  * **snapshot while writing**: every read path (``snapshot()``,
    ``prometheus_text()``) takes the same per-instrument lock as the
    writers, so a scrape during a decode tick sees a consistent value —
    never a torn histogram (property-tested with writer threads).
  * **pull, not push**: values that are derived state (queue depth, block
    pool occupancy, device-side analog-health counters) register as
    callback gauges / collectors and are evaluated lazily at scrape time —
    the analog-health collector is what keeps the device→host transfer at
    one per SNAPSHOT instead of one per tick.

Exposition: :meth:`MetricsRegistry.snapshot` returns a plain JSON-able
dict; :meth:`MetricsRegistry.prometheus_text` renders the text exposition
format (``# HELP`` / ``# TYPE`` / ``name{label="v"} value``, histograms as
cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``). The HTTP exporter
that serves it is not ported yet (ROADMAP.md queue 1, slice 7).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# Label-cardinality guard: a mistyped high-cardinality label (request id,
# token value, ...) silently eats memory and makes scrapes quadratic; fail
# loudly instead. Generous enough for every legitimate use here (slots,
# moduli channels, buckets).
MAX_LABEL_SETS = 1024

# Default latency buckets (seconds): 1ms .. ~120s, x2 per step — wide
# enough for CPU-interpret serving ticks and TPU microseconds alike.
DEFAULT_BUCKETS = tuple(0.001 * 2 ** i for i in range(18))


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class _Instrument:
    """Common parent/child machinery for labelled instruments.

    A metric created with ``label_names`` is a PARENT: observations go
    through ``labels(v1, v2, ...)`` which returns (and caches) the child
    bound to those label values. A metric without labels is its own child.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Instrument"] = {}
        if not self.label_names:
            self._children[()] = self

    def labels(self, *values) -> "_Instrument":
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"values {self.label_names}, got {values!r}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= MAX_LABEL_SETS:
                        raise ValueError(
                            f"{self.name}: label cardinality exceeded "
                            f"{MAX_LABEL_SETS} distinct label sets — a "
                            f"high-cardinality label leaked into a metric")
                    child = self._make_child()
                    self._children[key] = child
        return child

    def _make_child(self) -> "_Instrument":
        child = type(self)(self.name, self.help)
        child._lock = self._lock  # one lock per metric family
        return child

    def _series(self) -> Iterable[Tuple[Tuple[str, ...], "_Instrument"]]:
        with self._lock:
            return list(self._children.items())


class Counter(_Instrument):
    """Monotonic counter. ``inc(n)`` only; ``set`` exists for the legacy
    Scheduler dict view (internal use — Prometheus semantics still hold as
    long as callers only ever move it forward)."""

    kind = "counter"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Point-in-time value. Either set directly (``set``/``inc``/``dec``)
    or backed by a zero-argument callable evaluated at scrape time."""

    kind = "gauge"

    def __init__(self, name, help="", label_names=(),
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, label_names)
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative ``le`` semantics on exposition).

    ``buckets`` are the UPPER edges of the non-overflow buckets, strictly
    increasing; an implicit +Inf bucket catches the rest. ``observe`` costs
    one bisect + two adds. ``percentile(q)`` interpolates linearly inside
    the winning bucket (the +Inf bucket reports the largest finite edge) —
    an estimate for dashboards; exact tails come from raw samples where the
    caller keeps them (``Scheduler.latency_summary``).
    """

    kind = "histogram"

    def __init__(self, name, help="", label_names=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(set(b)):
            raise ValueError(f"{name}: bucket edges must be strictly "
                             f"increasing, got {buckets!r}")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)
        self._sum = 0.0
        self._count = 0

    def _make_child(self):
        child = Histogram(self.name, self.help, buckets=self.buckets)
        child._lock = self._lock
        return child

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) by linear interpolation
        within the winning bucket."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1] if self.buckets else 0.0)
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1] if self.buckets else 0.0


class MetricsRegistry:
    """Named instruments + scrape-time collectors.

    ``counter/gauge/histogram`` get-or-create by name (re-registration with
    a different kind raises — that is always a bug). ``add_collector``
    registers a pre-scrape hook, called ONCE per ``snapshot()`` /
    ``prometheus_text()``; the serving engine's analog-health collector
    uses it to fetch the device-side counters with a single host transfer
    per scrape.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # -- registration --------------------------------------------------

    def _get_or_make(self, cls, name, help, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, label_names)

    def gauge_fn(self, name: str, fn: Callable[[], float],
                 help: str = "") -> Gauge:
        g = self._get_or_make(Gauge, name, help, ())
        g.set_fn(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, label_names,
                                 buckets=buckets)

    def add_collector(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    # -- exposition ----------------------------------------------------

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:
                pass  # a broken collector must never kill a scrape

    def snapshot(self) -> Dict:
        """JSON-able dict of every series: counters/gauges as numbers,
        histograms as {buckets, counts, sum, count, p50/p95/p99}."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.items())
        out: Dict = {}
        for name, m in metrics:
            series = {}
            for key, child in m._series():
                label = _label_str(m.label_names, key) or "_"
                if isinstance(child, Histogram):
                    with child._lock:
                        series[label] = {
                            "buckets": list(child.buckets),
                            "counts": list(child._counts),
                            "sum": child._sum,
                            "count": child._count,
                        }
                    series[label].update(
                        {f"p{int(q * 100)}": child.percentile(q)
                         for q in (0.5, 0.95, 0.99)})
                else:
                    series[label] = child.value
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.items())
        lines: List[str] = []
        for name, m in sorted(metrics):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, child in m._series():
                ls = _label_str(m.label_names, key)
                if isinstance(child, Histogram):
                    with child._lock:
                        counts = list(child._counts)
                        total, s = child._count, child._sum
                    cum = 0
                    for i, edge in enumerate(
                            list(child.buckets) + [math.inf]):
                        cum += counts[i]
                        le = _label_str(
                            m.label_names + ("le",),
                            key + (_fmt_value(edge),))
                        lines.append(f"{name}_bucket{le} {cum}")
                    lines.append(f"{name}_sum{ls} {_fmt_value(s)}")
                    lines.append(f"{name}_count{ls} {total}")
                else:
                    lines.append(f"{name}{ls} {_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """Process-wide default registry (launchers/benchmarks convenience;
    the serving engine defaults to a private registry per Scheduler)."""
    return _default
