"""Serving runtime: a continuous-batching engine over a stacked slot cache.

Port of ``repro.runtime.server`` on its default path: the dense cache
layout, synchronous bucketed admission, greedy or sampled decode. The
engine keeps the JAX engine's invariants:

  * **one decode step per tick** over a stacked ``(slots, ...)`` cache with
    a per-slot position vector (``cache["idx"]``) and an active-slot mask;
  * **device-side selection and retirement**: next tokens, EOS and
    max-token masks are computed on the device; exactly ONE device->host
    transfer per tick (a packed ``(slots, 2)`` token/done array), and TTFT
    is stamped only after the bytes reach the host;
  * **bucketed batched prefill**: prompts are right-padded to power-of-two
    length buckets, admission groups padded to power-of-two batch sizes,
    and the resulting cache is scattered into the live cache
    (:func:`repro_torch.models.lm.cache_insert`).

Every step runs under ``torch.inference_mode()``. Sampled decode draws from a
``torch.Generator`` seeded with ``sample_seed`` (deterministic per seed; the
numbers differ from the JAX engine's threefry draws).

Under the RNS-family backends the engine also:

  * programs every ``Dense`` weight into **stationary residues** once, at
    construction (:func:`repro_torch.core.stationary.encode_stationary_params`),
    and installs them on the model; the tied head stays raw;
  * draws the **analog noise** of each decode tick and each prefill batch
    from one of two device generators seeded from ``policy.noise_seed`` (0
    when unset), opened as the GEMMs' ambient
    :func:`repro_torch.core.gemm.noise_scope`: fresh noise every step,
    deterministic per seed (the numbers differ from the JAX engine's);
  * folds the **analog-health** counters (:mod:`repro_torch.obs.health`)
    into device accumulators every step, read back only by
    :meth:`LMServer.health_snapshot`.

The JAX engine's other options (paged KV, chunked prefill, prefix cache,
speculative decoding, pipelined prefill, meshes, fault injection, deadlines,
retries and admission caps) are not ported yet: passing one raises
``NotImplementedError`` naming the ROADMAP slice where it waits.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analog.channel import seeded_generator
from repro_torch.core import backends, gemm, stationary
from repro_torch.models import lm as lm_helpers
from repro_torch.obs import health as obs_health
from repro_torch.obs.metrics import MetricsRegistry


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` when the engine refuses a request instead of
    queueing it unboundedly (queue-depth cap hit). Carries
    ``retry_after_s``, the backoff hint a load balancer would surface."""

    def __init__(self, msg: str, retry_after_s: float = 0.1):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


#: terminal request statuses of the ported engine (the JAX engine's
#: deadlines and fault retries add "timed_out" and "failed")
TERMINAL_STATUSES = ("completed", "rejected")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_tokens: int = 32
    eos_id: Optional[int] = None
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    status: str = "queued"        # queued -> active -> completed | rejected
    error: Optional[str] = None   # why a request was rejected

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    @property
    def queue_time(self) -> float:
        return self.t_admit - self.t_enqueue

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_enqueue

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first."""
        n = len(self.tokens_out)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)


def default_buckets(cache_len: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to the cache capacity."""
    out, b = [], min_bucket
    while b < cache_len:
        out.append(b)
        b *= 2
    out.append(cache_len)
    return tuple(out)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{buckets[-1]}")


class _SchedulerMetrics(collections.abc.MutableMapping):
    """Dict-shaped view over registry-backed counters (``serve_<x>_total``),
    so the host loop, the JSON snapshot and the Prometheus text share one
    source of truth."""

    _COUNTERS = (
        ("completed", "requests retired"),
        ("tokens", "tokens emitted by retired requests"),
        ("ticks", "engine ticks run"),
        ("admitted", "requests admitted into slots"),
        ("prefill_batches", "bucketed prefill batches launched"),
        ("decode_steps", "batched decode steps run"),
        ("rejected", "requests refused at admission (queue cap)"),
    )

    def __init__(self, registry: MetricsRegistry):
        self._counters = {
            name: registry.counter(f"serve_{name}_total", help=help_)
            for name, help_ in self._COUNTERS}

    def __getitem__(self, key: str) -> int:
        return int(self._counters[key].value)

    def __setitem__(self, key: str, value: int) -> None:
        self._counters[key].set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("scheduler metrics keys are fixed")

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)


class Scheduler:
    """FCFS admission + retirement bookkeeping + per-request latency metrics.

    The scheduler owns the waiting deque and the host-visible request
    lifecycle (enqueue -> admit -> stream tokens -> retire); the engine owns
    the device state. ``on_token`` is the streaming hook: called once per
    materialized token, in emission order.
    """

    def __init__(self, on_token: Optional[Callable[[Request, int], None]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 max_queue_depth: Optional[int] = None):
        self.waiting: collections.deque[Request] = collections.deque()
        self.finished: List[Request] = []
        self.on_token = on_token
        self.max_queue_depth = max_queue_depth
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics: _SchedulerMetrics = _SchedulerMetrics(self.registry)
        self._h_ttft = self.registry.histogram(
            "serve_ttft_seconds", help="time to first token (enqueue→host)")
        self._h_tpot = self.registry.histogram(
            "serve_tpot_seconds", help="mean time per output token after "
                                       "the first, per retired request")
        self._h_queue = self.registry.histogram(
            "serve_queue_seconds", help="enqueue→admission wait")
        self.registry.gauge_fn(
            "serve_queue_depth", lambda: len(self.waiting),
            help="requests waiting for admission")

    def submit(self, req: Request) -> None:
        if self.max_queue_depth is not None and \
                len(self.waiting) >= self.max_queue_depth:
            req.status = "rejected"
            req.error = "queue full"
            self.metrics["rejected"] += 1
            raise AdmissionRejected(
                f"request {req.rid}: queue at max depth "
                f"{self.max_queue_depth}",
                retry_after_s=0.05 * len(self.waiting))
        req.t_enqueue = time.perf_counter()
        req.status = "queued"
        self.waiting.append(req)

    def take(self, n: int) -> List[Request]:
        """Pop up to ``n`` requests in FCFS order for admission."""
        out = []
        while self.waiting and len(out) < n:
            out.append(self.waiting.popleft())
        return out

    def record_admit(self, reqs: Sequence[Request]) -> None:
        t = time.perf_counter()
        for r in reqs:
            r.t_admit = t
            r.status = "active"
        self.metrics["admitted"] += len(reqs)
        self.metrics["prefill_batches"] += 1

    def emit(self, req: Request, tok: int) -> None:
        req.tokens_out.append(tok)
        if self.on_token is not None:
            self.on_token(req, tok)

    def retire(self, req: Request) -> Request:
        """Move a request that emitted its last token to ``finished``."""
        req.t_done = time.perf_counter()
        req.status = "completed"
        self.metrics["completed"] += 1
        self.metrics["tokens"] += len(req.tokens_out)
        if req.t_first_token > 0:
            self._h_ttft.observe(req.ttft)
            self._h_tpot.observe(req.tpot)
        if req.t_admit > 0:
            self._h_queue.observe(req.queue_time)
        self.finished.append(req)
        return req

    def latency_summary(self) -> Dict[str, float]:
        """Means + exact p50/p95/p99 of TTFT and TPOT over retired requests
        (zeros for an empty drain; phases a request never reached are
        excluded from that phase's statistics)."""
        keys = [f"{m}_{s}_s" for m in ("ttft", "tpot")
                for s in ("mean", "p50", "p95", "p99")] + ["queue_mean_s"]
        out = {k: 0.0 for k in keys}
        admitted = [r for r in self.finished if r.t_admit > 0]
        if admitted:
            out["queue_mean_s"] = float(
                np.mean([r.queue_time for r in admitted]))
        streamed = [r for r in self.finished if r.t_first_token > 0]
        if not streamed:
            return out
        for name, arr in (("ttft", np.asarray([r.ttft for r in streamed])),
                          ("tpot", np.asarray([r.tpot for r in streamed]))):
            out[f"{name}_mean_s"] = float(arr.mean())
            for q in (50, 95, 99):
                out[f"{name}_p{q}_s"] = float(np.percentile(arr, q))
        return out


#: JAX-engine options that are not ported yet: (default, where they wait)
_NOT_PORTED = {
    "cache_layout": ("dense", "ROADMAP.md queue 1, slice 5 (paged KV)"),
    "block_size": (16, "ROADMAP.md queue 1, slice 5 (paged KV)"),
    "n_blocks": (None, "ROADMAP.md queue 1, slice 5 (paged KV)"),
    "prefill_chunk": (None, "ROADMAP.md queue 1, slice 5 (chunked prefill)"),
    "prefix_cache": (False, "ROADMAP.md queue 1, slice 5 (prefix cache)"),
    "spec_k": (0, "ROADMAP.md queue 1, slice 5 (speculative decoding)"),
    "pipeline_depth": (0, "ROADMAP.md queue 1, slice 5 (pipelined prefill)"),
    "mesh": (None, "ROADMAP.md queue 1, slice 8 (meshed serving)"),
    "fault_injector": (None, "ROADMAP.md queue 1, slice 7 (faults)"),
    "default_ttl_s": (None, "ROADMAP.md queue 1, slice 7 (deadlines)"),
    "default_queue_ttl_s": (None, "ROADMAP.md queue 1, slice 7 (deadlines)"),
    "max_retries": (1, "ROADMAP.md queue 1, slice 7 (fault retries)"),
    "max_queue_depth": (None, "ROADMAP.md queue 1, slice 7 (admission "
                              "caps; a Scheduler built with one works)"),
}


class LMServer:
    """Continuous-batching serving engine (the deployment path).

    Device state is one dict of tensors on the model's device::

        {"cache":   stacked dense cache, per-slot ``idx`` (LM.init_cache),
         "last_tok": (S,) int32   last emitted token per slot,
         "active":   (S,) bool    slot occupancy mask,
         "emitted":  (S,) int32   tokens emitted per slot,
         "eos":      (S,) int32   per-slot EOS id (-1 = none),
         "max_tok":  (S,) int32   per-slot token budget}

    plus ``"health"``, the analog-health accumulators, under a policy
    that reports any (:func:`repro_torch.obs.health.spec`).

    ``tick()`` = admit (bucketed batched prefill + scatter insert) then one
    decode step for every slot at once. The model owns its parameters, so
    the engine takes the model alone (the JAX engine takes ``params``
    beside it).

    ``stationary_weights``: run the GEMMs against stationary residues
    programmed once here. ``None`` turns it on exactly when the policy's
    backend ``supports_stationary_residues``; the encodings are installed
    on the model's ``Dense`` modules (``False`` clears them), so one model
    serves one engine's programming at a time.
    """

    def __init__(self, model, cap: int, batch_slots: int = 8,
                 greedy: bool = True,
                 buckets: Optional[Sequence[int]] = None,
                 on_token: Optional[Callable[[Request, int], None]] = None,
                 scheduler: Optional[Scheduler] = None,
                 sample_seed: int = 0,
                 stationary_weights: Optional[bool] = None,
                 **not_ported: Any):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"LMServer got an unexpected keyword "
                                f"argument {name!r}")
            default, where = _NOT_PORTED[name]
            if value != default:
                raise NotImplementedError(
                    f"LMServer option {name}={value!r} is not ported to "
                    f"repro_torch yet; it waits in {where}")
        self.model = model
        self.cap = cap
        self.greedy = greedy
        self.n_slots = batch_slots
        self.device = model.device
        self.cache_len = model.cache_len(cap)
        self.buckets = tuple(sorted(buckets)) if buckets else \
            default_buckets(self.cache_len)
        if self.buckets[-1] > self.cache_len:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds cache "
                             f"capacity {self.cache_len}")
        self.scheduler = scheduler or Scheduler(on_token=on_token)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(sample_seed)

        policy = model.policy
        backend = backends.resolve(policy)
        # one generator per noise stream: decode ticks and prefill batches
        seed = policy.noise_seed if policy.noise_seed is not None else 0
        self._noise_gens = {
            stream: seeded_generator(self.device, "serve", seed, stream)
            for stream in ("decode", "prefill")}
        self._health_spec = obs_health.spec(policy)
        if stationary_weights is None:
            stationary_weights = backend.supports_stationary_residues
        if stationary_weights and not backend.supports_stationary_residues:
            raise ValueError(
                f"stationary_weights=True needs a backend that supports "
                f"stationary residues; {policy.mode!r} does not")
        self.stationary_weights = bool(stationary_weights)
        stationary.install(model, stationary.encode_stationary_params(
            model, policy) if self.stationary_weights else None)

        self.state = self._init_state(batch_slots)
        reg = self.scheduler.registry
        reg.gauge_fn("serve_slots_active",
                     lambda: sum(r is not None for r in self.slot_req),
                     help="slots holding a live request")
        self._h_tick = reg.histogram(
            "serve_tick_seconds", help="engine tick walltime (admit + "
                                       "decode + host sync)")

    # ------------------------------------------------------------------
    # device-side steps
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _init_state(self, n_slots: int) -> Dict[str, Any]:
        def full(value, dtype):
            return torch.full((n_slots,), value, dtype=dtype,
                              device=self.device)
        state = {
            "cache": self.model.init_cache(n_slots, self.cap,
                                           per_slot_idx=True),
            "last_tok": full(0, torch.int32),
            "active": full(False, torch.bool),
            "emitted": full(0, torch.int32),
            "eos": full(-1, torch.int32),
            "max_tok": full(0, torch.int32),
        }
        if self._health_spec:
            state["health"] = obs_health.init(self._health_spec, self.device)
        return state

    @contextlib.contextmanager
    def _step_scope(self, stream: str):
        """Ambient noise of one step (its stream's generator) and, under a
        policy with health counters, their collection and fold."""
        with gemm.noise_scope(self._noise_gens[stream]):
            if not self._health_spec:
                yield
                return
            with obs_health.collect() as hc:
                yield
            obs_health.fold(self.state["health"], hc.values)

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        """Next token per row of (B, V) logits: greedy argmax (first max on
        ties, as jnp.argmax) or a categorical draw from the engine's
        generator."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=self._sample_gen
                                 )[:, 0].to(torch.int32)

    @torch.inference_mode()
    def _decode_tick(self) -> torch.Tensor:
        """One decode step for every slot; returns the (S, 2) payload
        [token | -1, done] still on the device."""
        state = self.state
        cache0 = state["cache"]
        idx0 = cache0["idx"]
        with self._step_scope("decode"):
            logits, cache = self.model.decode_step(
                cache0, state["last_tok"][:, None])
        tok = self._select(logits[:, -1, :])
        active = state["active"]
        emitted = state["emitted"] + active.to(torch.int32)
        hit_eos = (state["eos"] >= 0) & (tok == state["eos"])
        done = active & (hit_eos | (emitted >= state["max_tok"]))
        # inactive slots don't advance their position (their k/v writes land
        # on a frozen slot position and are overwritten on reuse)
        cache["idx"] = torch.where(active, cache["idx"], idx0)
        state.update(cache=cache,
                     last_tok=torch.where(active, tok, state["last_tok"]),
                     active=active & ~done, emitted=emitted)
        return torch.stack([torch.where(active, tok, -1),
                            done.to(torch.int32)], dim=-1)

    @torch.inference_mode()
    def _prefill_insert(self, tokens: np.ndarray, lens: np.ndarray,
                        slots: np.ndarray, eos: np.ndarray,
                        max_tok: np.ndarray) -> torch.Tensor:
        """Bucketed prefill of one admission group + scatter into the live
        state; returns the (B, 2) payload [token, done] on the device.
        Rows whose slot is the ``n_slots`` sentinel (batch padding) are
        computed and then dropped."""
        dev = self.device
        with self._step_scope("prefill"):
            logits, new_cache = self.model.prefill(
                torch.from_numpy(tokens).to(dev), self.cap,
                lens=torch.from_numpy(lens).to(dev))
        tok = self._select(logits[:, -1, :])
        eos_d = torch.from_numpy(eos).to(dev)
        max_d = torch.from_numpy(max_tok).to(dev)
        # instant retirement: the prefill token already hit EOS or the
        # whole budget was one token — never occupy a slot
        done0 = ((eos_d >= 0) & (tok == eos_d)) | (max_d <= 1)
        slots_t = torch.from_numpy(slots)
        state = self.state
        lm_helpers.cache_insert(state["cache"], new_cache, slots_t)
        rows = torch.nonzero(slots_t < self.n_slots)[:, 0]  # host-side mask
        dst, src = slots_t[rows].to(dev), rows.to(dev)
        for name, val in (("last_tok", tok), ("active", ~done0),
                          ("emitted", torch.ones_like(tok)),
                          ("eos", eos_d), ("max_tok", max_d)):
            state[name][dst] = val[src].to(state[name].dtype)
        return torch.stack([tok, done0.to(torch.int32)], dim=-1)

    @staticmethod
    def _to_host(payload: torch.Tensor) -> np.ndarray:
        """The device->host transfer of a step's packed payload."""
        return payload.cpu().numpy()

    # ------------------------------------------------------------------
    # host-side loop
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} exceeds "
                f"largest bucket {self.buckets[-1]}")
        self.scheduler.submit(req)

    def _admit(self) -> List[Request]:
        """Admit waiting requests into free slots with bucketed batched
        prefill. Returns requests retired AT admission (prefill token was
        EOS / one-token budget); their slots are immediately reusable, so
        the loop keeps admitting while slots free up and work waits."""
        retired: List[Request] = []
        while True:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free or not self.scheduler.waiting:
                return retired
            reqs = self.scheduler.take(len(free))
            groups: Dict[int, List[Request]] = {}
            for r in reqs:
                groups.setdefault(pick_bucket(len(r.prompt), self.buckets),
                                  []).append(r)
            for Lb, group in sorted(groups.items()):
                B = len(group)
                Bp = 1 << (B - 1).bit_length()      # pad batch to a pow2
                tokens = np.zeros((Bp, Lb), np.int32)
                lens = np.ones((Bp,), np.int32)
                slots = np.full((Bp,), self.n_slots, np.int64)  # OOB = drop
                eos = np.full((Bp,), -1, np.int32)
                max_tok = np.ones((Bp,), np.int32)
                for j, r in enumerate(group):
                    tokens[j, :len(r.prompt)] = r.prompt
                    lens[j] = len(r.prompt)
                    slots[j] = free.pop(0)
                    eos[j] = -1 if r.eos_id is None else r.eos_id
                    max_tok[j] = r.max_tokens
                self.scheduler.record_admit(group)
                payload = self._to_host(self._prefill_insert(
                    tokens, lens, slots, eos, max_tok))
                # TTFT is stamped only once the token bytes are on the host
                t_host = time.perf_counter()
                for j, r in enumerate(group):
                    r.t_first_token = t_host
                    self.scheduler.emit(r, int(payload[j, 0]))
                    if payload[j, 1]:
                        retired.append(self.scheduler.retire(r))
                    else:
                        self.slot_req[int(slots[j])] = r

    def tick(self) -> List[Request]:
        """Admit waiting requests, then decode one token for EVERY active
        slot in a single step with a single device->host transfer."""
        t_tick = time.perf_counter()
        done: List[Request] = list(self._admit())
        if any(r is not None for r in self.slot_req):
            payload = self._to_host(self._decode_tick())   # the ONE transfer
            self.scheduler.metrics["decode_steps"] += 1
            for i, (tok, is_done) in enumerate(payload):
                req = self.slot_req[i]
                if req is None or tok < 0:
                    continue
                self.scheduler.emit(req, int(tok))
                if is_done:
                    self.slot_req[i] = None
                    done.append(self.scheduler.retire(req))
        self.scheduler.metrics["ticks"] += 1
        self._h_tick.observe(time.perf_counter() - t_tick)
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_ticks):
            if not self.scheduler.waiting and \
                    all(r is None for r in self.slot_req):
                break
            finished.extend(self.tick())
        return finished

    def health_snapshot(self) -> Dict[str, Any]:
        """The analog-health counters as plain ints (per-channel ones as
        lists), in ONE device->host transfer; never called on a tick.
        Empty for policies without counters."""
        h = self.state.get("health")
        if not h:
            return {}
        names = list(h)
        flat = torch.cat([h[k].reshape(-1) for k in names]).cpu().tolist()
        out, i = {}, 0
        for k in names:
            n = h[k].numel()
            out[k] = flat[i] if h[k].dim() == 0 else flat[i:i + n]
            i += n
        return out

    @property
    def metrics(self) -> Dict[str, Any]:
        return self.scheduler.metrics
