"""Deterministic fault injection for the serving runtime (chaos): the
port's own copy of ``repro.runtime.faults`` (numpy only, the same code, so
one schedule and seed give both packages the same faults bit for bit).

Mirage's premise is surviving analog imperfection; proving the runtime
*reacts* correctly needs reproducible imperfection. This module gives the
serving engine named **fault sites** driven by a seeded per-tick
:class:`FaultSchedule`, so a chaos run replays bit-identically:

  device-side (enter the engine's steps as device control tensors through
  ``analog.channel.fault_scope``; a step captured as a CUDA graph reads
  them at fixed addresses, so one capture serves every fault value):
    ``snr_drop``       scale the detector noise sigma (an SNR collapse of
                       ``20*log10(scale)`` dB; needs a stochastic base
                       channel, i.e. ``policy.snr_db`` set)
    ``burst_storm``    add correlated burst errors at ``rate``/``width``
                       on top of the configured channel
    ``stuck_channel``  clamp residue channel ``channel`` to ``level``
                       after the detector stage (a dead/pegged detector)

  host-side (applied between ticks, never inside a step):
    ``pool_exhaustion``  quarantine ``blocks`` free KV blocks
                         (:meth:`BlockAllocator.quarantine`) so admission
                         and decode growth hit the real exhaustion paths
    ``worker_crash``     make the prefill pipeline worker raise on the
                         next job it picks up (once per scheduled tick)
    ``host_corruption``  flip sampled tokens in the device->host payload
                         to out-of-vocab garbage at ``rate`` (a corrupted
                         transfer the engine must detect and retry)

A schedule is a list of :class:`FaultEvent` windows ``[start, stop)`` in
engine decode-tick units, or the compact string form used by the CLI::

    snr_drop@4:12:scale=30;worker_crash@2;pool_exhaustion@3:9:blocks=16

Overlapping channel events compose: sigma scales multiply, burst rates
add (width takes the max), stuck masks union. Everything host-side draws
from ``numpy`` generators seeded by ``(seed, site, tick)``, independent
of the engine's device generators, which stay untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

SITES = ("snr_drop", "burst_storm", "stuck_channel",
         "pool_exhaustion", "worker_crash", "host_corruption")

# per-site recognized params and their defaults
_PARAMS = {
    "snr_drop": {"scale": 10.0},
    "burst_storm": {"rate": 0.05, "width": 2},
    "stuck_channel": {"channel": 0, "level": 0},
    "pool_exhaustion": {"blocks": 8},
    "worker_crash": {},
    "host_corruption": {"rate": 0.25},
}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault window: ``site`` active on ticks ``[start, stop)``."""

    site: str
    start: int
    stop: int
    params: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        if not 0 <= self.start < self.stop:
            raise ValueError(f"bad window [{self.start}, {self.stop}) "
                             f"for {self.site}")
        unknown = set(self.params) - set(_PARAMS[self.site])
        if unknown:
            raise ValueError(f"{self.site}: unknown params {sorted(unknown)} "
                             f"(expected {sorted(_PARAMS[self.site])})")

    def active(self, tick: int) -> bool:
        return self.start <= tick < self.stop

    def get(self, name: str):
        return self.params.get(name, _PARAMS[self.site][name])


class FaultSchedule:
    """An ordered set of fault windows, parseable from the compact CLI
    string (see module docstring). Empty schedules are valid (a chaos
    harness that injects nothing is the identity engine)."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = list(events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def horizon(self) -> int:
        """First tick with no scheduled fault at or after it."""
        return max((e.stop for e in self.events), default=0)

    def sites(self) -> set:
        return {e.site for e in self.events}

    def active(self, site: str, tick: int) -> List[FaultEvent]:
        return [e for e in self.events
                if e.site == site and e.active(tick)]

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """``site@start[:stop][:k=v[,k=v...]][;...]`` — stop defaults to
        ``start + 1`` (a one-tick event)."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if "@" not in part:
                raise ValueError(f"bad fault spec {part!r}: expected "
                                 f"site@start[:stop][:k=v,...]")
            site, rest = part.split("@", 1)
            fields = rest.split(":")
            start = int(fields[0])
            stop, params = start + 1, {}
            for f in fields[1:]:
                if "=" in f:
                    for kv in filter(None, f.split(",")):
                        k, v = kv.split("=")
                        params[k.strip()] = float(v)
                else:
                    stop = int(f)
            events.append(FaultEvent(site=site.strip(), start=start,
                                     stop=stop, params=params))
        return cls(events)

    def describe(self) -> str:
        return "; ".join(
            f"{e.site}@[{e.start},{e.stop})"
            + (f" {e.params}" if e.params else "")
            for e in self.events) or "(empty)"


class FaultInjector:
    """Evaluates a :class:`FaultSchedule` against the engine's decode-tick
    clock and hands each fault site its per-tick controls.

    The engine (``LMServer(..., fault_injector=...)``) owns the clock and
    calls:

      * :meth:`controls` once per tick while a channel site is scheduled
        and the backend runs the channel: the channel-control values
        (identity when no channel fault is active this tick), which the
        engine copies into its device control tensors;
      * :meth:`pool_squeeze` / :meth:`worker_crash` between ticks;
      * :meth:`corrupt_tokens` on every device->host token payload.

    ``log`` accumulates one line per state change so chaos runs are
    auditable; deterministic for a given (schedule, seed).
    """

    def __init__(self, schedule: FaultSchedule, seed: int = 0):
        self.schedule = schedule
        self.seed = int(seed)
        self.log: List[str] = []
        self._crashed_at: set = set()
        self._last_active: Dict[str, bool] = {s: False for s in SITES}

    # -- bookkeeping -----------------------------------------------------

    def _note_transitions(self, tick: int) -> None:
        for site in SITES:
            now = bool(self.schedule.active(site, tick))
            if now != self._last_active[site]:
                self.log.append(
                    f"tick {tick}: {site} "
                    f"{'enters' if now else 'leaves'} window")
                self._last_active[site] = now

    def _rng(self, site: str, tick: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 0x9E3779B1 + SITES.index(site) * 7919 + tick)
            % (2 ** 63))

    # -- device-side (channel) sites -------------------------------------

    def channel_faults_scheduled(self) -> bool:
        return bool(self.schedule.sites()
                    & {"snr_drop", "burst_storm", "stuck_channel"})

    def controls(self, tick: int, n_moduli: int) -> Dict[str, np.ndarray]:
        """The channel fault-control values for ``tick``: identity values
        when nothing is active, under which the channel computes what the
        unfaulted engine does, bit for bit."""
        self._note_transitions(tick)
        sigma_scale = 1.0
        for e in self.schedule.active("snr_drop", tick):
            sigma_scale *= float(e.get("scale"))
        burst_rate, burst_width = 0.0, 1
        for e in self.schedule.active("burst_storm", tick):
            burst_rate += float(e.get("rate"))
            burst_width = max(burst_width, int(e.get("width")))
        stuck_mask = np.zeros((n_moduli,), np.bool_)
        stuck_level = np.zeros((n_moduli,), np.int32)
        for e in self.schedule.active("stuck_channel", tick):
            ch = int(e.get("channel"))
            if 0 <= ch < n_moduli:
                stuck_mask[ch] = True
                stuck_level[ch] = int(e.get("level"))
        return {
            "sigma_scale": np.float32(sigma_scale),
            "burst_rate": np.float32(burst_rate),
            "burst_width": np.int32(burst_width),
            "stuck_mask": stuck_mask,
            "stuck_level": stuck_level,
        }

    # -- host-side sites -------------------------------------------------

    def pool_squeeze(self, tick: int) -> int:
        """Number of KV blocks that should be held in quarantine at
        ``tick`` (the engine applies the delta vs its current hold)."""
        return sum(int(e.get("blocks"))
                   for e in self.schedule.active("pool_exhaustion", tick))

    def worker_crash(self, tick: int) -> bool:
        """True exactly once per scheduled crash tick: the next prefill
        job the pipeline worker picks up must raise."""
        for e in self.schedule.active("worker_crash", tick):
            if e.start not in self._crashed_at:
                self._crashed_at.add(e.start)
                self.log.append(f"tick {tick}: worker_crash fired")
                return True
        return False

    def corrupt_tokens(self, tick: int, tokens: np.ndarray,
                       vocab_size: int) -> np.ndarray:
        """Maybe corrupt a device->host sampled-token payload: each entry
        flips to out-of-vocab garbage with the scheduled rate (seeded by
        (seed, tick) — replays identically). Returns ``tokens`` untouched
        when no window is active."""
        rate = sum(float(e.get("rate"))
                   for e in self.schedule.active("host_corruption", tick))
        if rate <= 0 or tokens.size == 0:
            return tokens
        rng = self._rng("host_corruption", tick)
        hit = rng.random(tokens.shape) < min(rate, 1.0)
        if not hit.any():
            return tokens
        out = tokens.copy()
        out[hit] = vocab_size + rng.integers(1, 2 ** 20, int(hit.sum()))
        self.log.append(
            f"tick {tick}: host_corruption flipped {int(hit.sum())} token(s)")
        return out
