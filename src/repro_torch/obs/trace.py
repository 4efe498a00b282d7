"""Span tracer: a thread-safe ring buffer of timed spans, ~zero cost off.

Port of ``repro.obs.trace``. The serving tick (``serve.tick`` around
``serve.admit``, ``serve.prefill_batch`` / ``serve.prefill_scatter`` /
``serve.chunk``, ``serve.decode`` or ``serve.verify``, and
``serve.host_sync``), the trainer's steps (``train.data_next`` /
``train.step`` / ``train.host_sync``) and the GEMM backend dispatch
(``gemm.<mode>``) are instrumented with :meth:`SpanTracer.span`;
:meth:`SpanTracer.instant` records a marker. Design:

  * **disabled is the default and costs one attribute check**: ``span()``
    on a disabled tracer returns a shared no-op context manager — no
    generator frame, no clock read, no allocation. The <2% instrumented-on
    overhead of the ENABLED path is a clock read and a locked list write
    per span.
  * **bounded memory**: spans land in a preallocated ring buffer
    (``capacity`` spans, default 64k); wraparound keeps the most recent
    spans. A long soak never grows the tracer.
  * **Chrome-trace export**: :meth:`chrome_trace` renders the ring as a
    ``traceEvents`` JSON object (``ph: "X"`` complete events, ``ph: "i"``
    markers, microsecond timestamps) loadable in ``chrome://tracing`` /
    Perfetto; :meth:`export` writes it to a file (``launch/train.py`` and
    ``launch/serve.py --trace-export``).
  * **torch.profiler composition**: with ``annotate=True`` every span also
    opens a ``torch.profiler.record_function`` range (the JAX package's
    ``TraceAnnotation``), so host spans line up with the card's kernels
    inside a ``torch.profiler`` capture (:func:`profile_window`,
    ``launch/serve.py --profile-window``). PyTorch runs
    eagerly and returns before the device finishes, so a span measures
    host dispatch unless it ends in a synchronize (``train.host_sync``
    does); device-side truth comes from the profiler capture.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

_NULL = contextlib.nullcontext()


class _SpanCM:
    """Reusable-per-call context manager recording one span on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str,
                 args: Optional[Dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        if self._tracer.annotate and self._tracer._annotation is not None:
            self._ann = self._tracer._annotation(self._name)
            self._ann.__enter__()
        else:
            self._ann = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._t0, dur, self._args)
        return False


class SpanTracer:
    """Ring-buffer span recorder; see module docstring."""

    def __init__(self, capacity: int = 65536, enabled: bool = False,
                 annotate: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._head = 0          # next write index
        self._total = 0         # spans ever recorded (wraparound counter)
        self._t_origin = time.perf_counter_ns()
        self._annotation = None
        if annotate:
            self._load_annotation()

    def _load_annotation(self):
        from torch.profiler import record_function
        self._annotation = record_function

    def configure(self, enabled: Optional[bool] = None,
                  annotate: Optional[bool] = None) -> "SpanTracer":
        if enabled is not None:
            self.enabled = bool(enabled)
        if annotate is not None:
            self.annotate = bool(annotate)
            if self.annotate and self._annotation is None:
                self._load_annotation()
        return self

    # -- recording -----------------------------------------------------

    def span(self, name: str, args: Optional[Dict] = None):
        """Context manager timing the enclosed block. No-op when disabled."""
        if not self.enabled:
            return _NULL
        return _SpanCM(self, name, args)

    def instant(self, name: str, args: Optional[Dict] = None) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        self._record(name, time.perf_counter_ns(), 0, args, ph="i")

    def _record(self, name, t0_ns, dur_ns, args, ph="X"):
        tid = threading.get_ident()
        with self._lock:
            self._ring[self._head] = (name, t0_ns, dur_ns, tid, args, ph)
            self._head = (self._head + 1) % self.capacity
            self._total += 1

    # -- export --------------------------------------------------------

    def spans(self) -> List[Dict]:
        """Recorded spans, oldest first (at most ``capacity``)."""
        with self._lock:
            n = min(self._total, self.capacity)
            start = (self._head - n) % self.capacity
            raw = [self._ring[(start + i) % self.capacity] for i in range(n)]
        return [{"name": s[0], "t0_ns": s[1], "dur_ns": s[2], "tid": s[3],
                 "args": s[4] or {}, "ph": s[5]} for s in raw
                if s is not None]

    @property
    def n_recorded(self) -> int:
        """Spans ever recorded (including those evicted by wraparound)."""
        with self._lock:
            return self._total

    @property
    def n_dropped(self) -> int:
        with self._lock:
            return max(0, self._total - self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._head = 0
            self._total = 0

    def chrome_trace(self) -> Dict:
        """Chrome-trace / Perfetto ``traceEvents`` JSON object."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            ev = {"name": s["name"], "ph": s["ph"],
                  "ts": (s["t0_ns"] - self._t_origin) / 1e3,   # µs
                  "pid": pid, "tid": s["tid"], "args": s["args"]}
            if s["ph"] == "X":
                ev["dur"] = s["dur_ns"] / 1e3
            else:
                ev["s"] = "t"  # instant event scope: thread
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.n_dropped}}

    def export(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_default = SpanTracer()


def get_tracer() -> SpanTracer:
    """Process-wide default tracer. Disabled by default: library code calls
    ``get_tracer().span(...)`` freely; only an entry point (launcher,
    benchmark, test) flips it on via :func:`configure`."""
    return _default


def configure(enabled: Optional[bool] = None,
              annotate: Optional[bool] = None,
              capacity: Optional[int] = None) -> SpanTracer:
    """Configure the default tracer. Changing ``capacity`` clears it."""
    global _default
    if capacity is not None and capacity != _default.capacity:
        _default = SpanTracer(capacity=capacity, enabled=_default.enabled,
                              annotate=_default.annotate)
    return _default.configure(enabled=enabled, annotate=annotate)



@contextlib.contextmanager
def profile_window(logdir: str, tracer: Optional[SpanTracer] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir`` (``trace.json``, Chrome-trace JSON: the host's operators
    and, on the card, its kernels), with the span tracer's annotations on
    (spans appear as named ranges beside the kernels). Degrades to a
    warning where the profiler cannot start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prev = None
    if tracer is not None:
        prev = (tracer.enabled, tracer.annotate)
        tracer.configure(enabled=True, annotate=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as e:  # pragma: no cover - env dependent
            print(f"# profile window unavailable: {e}")
            prof = None
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception as e:  # pragma: no cover
                print(f"# profile stop failed: {e}")
        if tracer is not None and prev is not None:
            tracer.configure(enabled=prev[0], annotate=prev[1])
