"""Analog-health telemetry: device-side fault counters of the RRNS path
(port of ``repro.obs.health``).

RRNS corrections happen inside every GEMM of every layer, so the host cannot
see them, and reading them back per tick would add a device->host transfer
to the hot loop. Instead:

  * the serving engine opens :func:`collect` around each step's model call;
  * instrumented code (``analog/rrns.py`` decode, ``analog/channel.py``
    stages, the ``mirage_rrns`` backend's fused-readout route) calls
    :func:`record` with small device tensors (scalar fault counts,
    per-channel flip vectors), and computes them only when :func:`active`;
  * the engine adds the collected values into device accumulators
    (:func:`fold`, in place), which are read back only by
    ``LMServer.health_snapshot`` in one transfer.

The JAX package's ``lifted``/``lifting_scan`` have no counterpart: the
port's layers are a Python loop, so a record made in any layer reaches the
open scope directly. :func:`suppressed` is ported: the JAX package runs the
hybrid family's shared block under it (a ``lax.cond`` branch has no channel
to carry records out), so its GEMMs go uncounted there, and the port
suppresses the same GEMMs to report the same integers. Counters are int64
(the JAX package's are int32). Recording never feeds back into the value
path.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch

_SCOPE = threading.local()


class HealthCollector:
    """Accumulates the values recorded while its scope is open."""

    def __init__(self):
        self.values: Dict[str, torch.Tensor] = {}

    def add(self, name: str, value: torch.Tensor) -> None:
        v = value.to(torch.int64)
        cur = self.values.get(name)
        self.values[name] = v if cur is None else cur + v


def _stack():
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    return stack


def active() -> bool:
    """True when a :func:`collect` scope is open on this thread and no
    :func:`suppressed` block sits inside it; record sites guard their
    summaries on it."""
    stack = _stack()
    return bool(stack) and stack[-1] is not None


def record(name: str, value: torch.Tensor) -> None:
    """Add ``value`` into the innermost open scope; no-op without one or
    inside a :func:`suppressed` block."""
    if active():
        _stack()[-1].add(name, value)


@contextlib.contextmanager
def collect():
    """Open a collection scope; yields the :class:`HealthCollector`."""
    stack = _stack()
    c = HealthCollector()
    stack.append(c)
    try:
        yield c
    finally:
        stack.pop()


@contextlib.contextmanager
def suppressed():
    """Record nothing inside the block, even under an open
    :func:`collect` scope (the JAX package's ``suppressed``)."""
    stack = _stack()
    stack.append(None)
    try:
        yield
    finally:
        stack.pop()


def spec(policy) -> Dict[str, Tuple[int, ...]]:
    """Accumulator shapes a policy's serving path can record.

      rrns_corrected     decodes whose winner is inside the correction
                         radius but where >= 1 residue disagreed (repaired)
      rrns_uncorrected   decodes whose winner is beyond the radius (or has
                         no legal reconstruction): untrustworthy outputs
      detector_flips     per-channel residues moved by detector noise
      drift_flips        per-channel residues moved by programming drift
      burst_hits         correlated burst events

    Empty for backends that are deterministic and non-correcting."""
    from repro_torch.analog import rrns as rrns_mod
    from repro_torch.analog.channel import AnalogChannelConfig
    from repro_torch.core import backends

    try:
        backend = backends.resolve(policy)
    except (KeyError, NotImplementedError):
        return {}
    if not backend.supports_noise:
        return {}
    correct = policy.mode in ("mirage_rrns", "mirage_rrns_ref")
    moduli = (rrns_mod.rrns_moduli(policy) if correct
              else tuple(policy.moduli))
    cfg = AnalogChannelConfig.from_policy(policy)
    out: Dict[str, Tuple[int, ...]] = {}
    if correct:
        out["rrns_corrected"] = ()
        out["rrns_uncorrected"] = ()
    if any(s > 0 for s in cfg.detector_sigmas(moduli)):
        out["detector_flips"] = (len(moduli),)
    if cfg.phase_drift_sigma > 0:
        out["drift_flips"] = (len(moduli),)
    if cfg.burst_rate > 0:
        out["burst_hits"] = ()
    return out


def init(spec_: Dict[str, Tuple[int, ...]],
         device=None) -> Dict[str, torch.Tensor]:
    """Zeroed device accumulators for a spec."""
    return {k: torch.zeros(shape, dtype=torch.int64, device=device)
            for k, shape in sorted(spec_.items())}


def fold(health: Dict[str, torch.Tensor],
         collected: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add a step's collected values into the accumulators, in place.
    Spec'd keys nothing recorded stay; recorded keys outside the spec are
    dropped (the spec is what a policy can report)."""
    for k, v in health.items():
        c = collected.get(k)
        if c is not None:
            v.add_(c)
    return health
