"""SNR-adaptive degradation: a health-driven guardian over the serving engine
(port of ``repro.runtime.resilience``).

Mirage's RRNS redundancy buys a fixed correction radius (``r`` redundant
moduli correct ``floor(r/2)`` residue errors per output). When the analog
channel degrades past that radius — an SNR collapse, a burst storm, a
stuck detector — the winning reconstruction is no longer certified by
enough consistent moduli, and the analog-health counters
(``rrns_uncorrected``: winners beyond the correction radius) say so in
real time. This module turns those counters into an automatic response:

  **verify-before-commit windows.** The guardian advances the engine in
  windows of ``window`` ticks. Before each window it takes a
  crash-consistent :meth:`LMServer.snapshot` and silences token streaming;
  after the window it reads the uncorrected-fault delta. A clean window
  (delta <= ``threshold``) COMMITS: the buffered tokens stream out and the
  engine keeps its state. A dirty window ROLLS BACK to the snapshot,
  escalates one rung on the degradation ladder and REPLAYS the same
  window under the stronger code — so no token produced by an
  uncorrectable computation is ever streamed. ``rrns_uncorrected == 0``
  over a window is a certificate that every decode in it was consistent
  with at least ``n_total - floor(r/2)`` moduli — inside the correction
  radius, hence exactly repaired — which is why committed streams under
  a mid-run SNR collapse are exactly the clean-backend streams.

  **the degradation ladder.** Escalation reprograms the engine via
  :meth:`LMServer.switch_backend`: stationary residues are re-encoded
  from the raw fp32 weights under the new policy:

      mirage_rrns r=2  ->  mirage_rrns r=4  ->  fp32 (hard fallback)

  (``r`` = redundant moduli; ``default_redundant_moduli(k, r)`` picks the
  first ``r`` primes above ``2^k + 1``.) The fp32 rung has no analog
  channel, so its windows are always clean — the ladder terminates.

  **cooldown recovery.** After ``cooldown`` consecutive committed windows
  above the base rung, the guardian probes one rung DOWN. A premature
  probe is safe: the probe window verifies like any other, so a
  still-degraded channel just rolls the probe back and re-escalates —
  no unverified token escapes during recovery either.

Requirements: a ``mirage_rrns`` base policy, ``instrument=True`` (the
health counters drive everything) and no pipelined prefill (each window
boundary needs a quiescent, snapshottable engine).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.runtime.server import LMServer, Request


def degradation_ladder(policy, max_r: int = 4) -> List:
    """Escalation rungs for ``policy`` (mode ``mirage_rrns``): the policy
    itself, stronger-RRNS variants stepping the redundant-moduli count by
    2 (each step buys one more correctable error per output) up to
    ``max_r``, then the fp32 hard fallback."""
    if policy.mode != "mirage_rrns":
        raise ValueError(
            f"the degradation ladder starts from mode='mirage_rrns' "
            f"(got {policy.mode!r}); other modes have no redundancy to "
            f"escalate")
    from repro_torch.analog.rrns import default_redundant_moduli
    rungs = [policy]
    r = len(policy.redundant_moduli) or 2
    while r < max_r:
        r = min(max_r, r + 2)
        rungs.append(dataclasses.replace(
            policy,
            redundant_moduli=default_redundant_moduli(policy.k, r)))
    rungs.append(dataclasses.replace(policy, mode="fp32"))
    return rungs


def _rung_name(policy) -> str:
    if policy.mode == "fp32":
        return "fp32"
    return f"{policy.mode}[r={len(policy.redundant_moduli) or 2}]"


class SNRGuardian:
    """Drives an :class:`LMServer` through verify-before-commit windows
    (see module docstring). Use :meth:`run_until_drained` in place of the
    engine's own, or :meth:`run_window` from a custom serving loop.

    ``transitions`` logs every escalation / recovery probe (one line
    each); ``level`` is the current ladder rung (0 = base policy).
    """

    def __init__(self, server: LMServer, window: int = 4,
                 threshold: int = 0, cooldown: int = 3, max_r: int = 4):
        if server._pipe is not None:
            raise ValueError(
                "the guardian snapshots at window boundaries; pipelined "
                "prefill keeps compute in flight across them — run with "
                "pipeline_depth=0")
        if not server.instrument:
            raise ValueError("the guardian is driven by the analog-health "
                             "counters; build the engine with "
                             "instrument=True")
        self.server = server
        self.ladder = degradation_ladder(server.model.policy, max_r=max_r)
        self.level = 0
        self.window = int(window)
        self.threshold = int(threshold)
        self.cooldown = int(cooldown)
        self.transitions: List[str] = []
        self._clean_windows = 0

    # -- health reading --------------------------------------------------

    def _uncorrected(self) -> int:
        v = self.server.health_snapshot().get("rrns_uncorrected", 0)
        return int(sum(v)) if isinstance(v, list) else int(v)

    def _live_requests(self) -> Dict[int, Request]:
        srv = self.server
        live: Dict[int, Request] = {}
        for r in list(srv.scheduler.waiting) + \
                [e["req"] for e in srv.prefilling] + \
                [x for x in srv.slot_req if x is not None]:
            live[r.rid] = r
        return live

    # -- the verify-before-commit window ---------------------------------

    def run_window(self) -> List[Request]:
        """One guarded window: snapshot, run ``window`` ticks with token
        streaming held back, then commit (stream + return retirements) or
        roll back + escalate (returns [] — the same work replays under
        the stronger rung on the next call)."""
        srv = self.server
        sched = srv.scheduler
        live = self._live_requests()
        snap = srv.snapshot()
        pre_lens = {rid: len(d["tokens_out"])
                    for rid, d in snap["requests"].items()}
        pre_unc = self._uncorrected()
        on_token = sched.on_token
        sched.on_token = None
        retired: List[Request] = []
        try:
            for _ in range(self.window):
                retired.extend(srv.tick())
                if not sched.waiting and \
                        all(r is None for r in srv.slot_req):
                    break
        finally:
            sched.on_token = on_token
        delta = self._uncorrected() - pre_unc
        if delta > self.threshold and self.level + 1 < len(self.ladder):
            srv.restore(snap, requests=live)
            self.level += 1
            srv.switch_backend(self.ladder[self.level])
            self.transitions.append(
                f"tick {snap['counters']['tick']}: {delta} uncorrected in "
                f"window -> escalate to {_rung_name(self.ladder[self.level])}")
            self._clean_windows = 0
            return []
        # commit: release the window's tokens in emission order
        if on_token is not None:
            for rid, n0 in pre_lens.items():
                r = live[rid]
                for tok in r.tokens_out[n0:]:
                    on_token(r, tok)
        if delta > self.threshold:
            # already at the last rung (fp32 never gets here: it has no
            # channel): nothing stronger exists, so the window stands
            self.transitions.append(
                f"tick {snap['counters']['tick']}: {delta} uncorrected at "
                f"final rung {_rung_name(self.ladder[self.level])} — "
                f"committing anyway")
            self._clean_windows = 0
            return retired
        self._clean_windows += 1
        if self.level > 0 and self._clean_windows >= self.cooldown:
            self.level -= 1
            srv.switch_backend(self.ladder[self.level])
            self.transitions.append(
                f"tick {srv._tick_count}: {self._clean_windows} clean "
                f"windows -> probe down to "
                f"{_rung_name(self.ladder[self.level])}")
            self._clean_windows = 0
        return retired

    def run_until_drained(self, max_windows: int = 2_500) -> List[Request]:
        """Drain the engine under guardianship. Progress is guaranteed:
        the ladder is finite and its last rung (fp32) always verifies, so
        every window eventually commits."""
        srv = self.server
        out: List[Request] = []
        for _ in range(max_windows):
            if not srv.scheduler.waiting and \
                    all(r is None for r in srv.slot_req):
                break
            out.extend(self.run_window())
        return out
