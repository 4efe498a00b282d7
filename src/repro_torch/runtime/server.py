"""Serving runtime: a continuous-batching engine over a stacked slot cache.

Port of ``repro.runtime.server``: the dense and paged cache layouts,
bucketed and chunked prefill, the prefix cache, speculative decoding,
greedy or sampled decode, and the per-slot parity oracle. The engine keeps
the JAX engine's invariants:

  * **one decode step per tick** over a stacked ``(slots, ...)`` cache with
    a per-slot position vector (``cache["idx"]``) and an active-slot mask;
  * **device-side selection and retirement**: next tokens, EOS and
    max-token masks are computed on the device; exactly ONE device->host
    transfer per tick (a packed ``(slots, 2)`` token/done array, ``(slots,
    k+2)`` under speculative decoding), and TTFT is stamped only after the
    bytes reach the host;
  * **bucketed batched prefill**: prompts are right-padded to power-of-two
    length buckets, admission groups padded to power-of-two batch sizes,
    and the resulting cache is scattered into the live cache
    (:func:`repro_torch.models.lm.cache_insert`).

**Paged KV** (``cache_layout="paged"``): KV lives in one pool of fixed-size
blocks addressed through per-slot block tables; the host-side allocator
(:mod:`repro_torch.runtime.paging`) maps blocks at admission and as decode
grows, reserves each request's lifetime budget (a tight pool queues
admissions head of line instead of running dry mid-decode), and frees them
at retirement. The table reaches the device only when the allocator has
changed it. **Chunked prefill** (``prefill_chunk=N``, paged only) streams
prompts through the decode loop N tokens a tick. **Prefix caching**
(``prefix_cache=True``, paged only) maps matched full prompt blocks
read-only into a new slot and prefills only the rest; a write into a
shared block forks a private copy first. **Speculative decoding**
(``spec_k=k``, paged and greedy only) drafts k tokens a slot on the host
(prompt lookup), verifies them in ONE step and accepts on the device:
token for token what greedy decode emits. :class:`PerSlotLMServer` is the
slot-at-a-time loop, kept as the parity oracle.

**The SSM family** (mamba2) keeps the JAX engine's rules for a recurrent
state that cannot be skipped or padded: no page pool under the paged
layout (its ``ssm``/``conv`` state is O(1) per slot and stays dense), the
prefix flag inert, prefill batched by EXACT prompt length (still across
same-length prompts) and chunked prefill with exact-length final chunks,
inactive slots' state frozen in the tick, the speculative verify rolled
back to each slot's accepted token, and stationary weights by default.
**The hybrid family** (zamba2) keeps those rules, but its shared block's
KV is paged like an attention layer's: a paged hybrid engine builds the
pool and its allocator (the prefix flag stays inert all the same), and
the verify tick rolls back only ``ssm``/``conv`` (the next tick rewrites
the rejected tail's shared KV before any read).

Every step runs under ``torch.inference_mode()``. Sampled decode draws from
``torch.Generator``s seeded from ``sample_seed``, one for decode ticks, one
for prefill batches and one for prefill chunks, so the prefill worker and
the decode loop never share one (deterministic per seed; a pipelined
engine's decode draws follow which tick a token lands in, as the JAX
engine's per-tick keys do; the numbers differ from the JAX engine's
threefry draws).

Under the RNS-family backends the engine also:

  * programs every ``Dense`` weight into **stationary residues** once, at
    construction (:func:`repro_torch.core.stationary.encode_stationary_params`),
    and installs them on the model; the tied head stays raw;
  * draws the **analog noise** of each decode tick (and verify tick), each
    prefill batch and each prefill chunk from one of three device
    generators seeded from ``policy.noise_seed`` (0 when unset), opened as
    the GEMMs' ambient :func:`repro_torch.core.gemm.noise_scope`: fresh
    noise every step, deterministic per seed (the numbers differ from the
    JAX engine's);
  * folds the **analog-health** counters (:mod:`repro_torch.obs.health`)
    into device accumulators every step, read back only by
    :meth:`LMServer.health_snapshot`.

**Pipelined prefill** (``pipeline_depth=N``) runs the bucketed prefill's
forward pass on a worker thread, on a CUDA stream of its own, while the
decode loop keeps ticking; the decode thread scatters each finished
prefill in submission order. A job that fails returns its requests to the
queue head for up to ``max_retries`` retries, then retires them as
``"failed"`` with the error. **Warmup** (:meth:`LMServer.warmup`) runs
every serving shape once before traffic and, on the card, captures the
tick as a CUDA graph that every later tick replays. The engine resizes its
slots and its block pool mid-flight (:meth:`LMServer.resize_slots`,
:meth:`LMServer.resize_block_pool`) and switches its numeric backend
(:meth:`LMServer.switch_backend`).

**Robustness** (the JAX engine's, slice 7): requests carry deadlines
(``ttl_s``, ``queue_ttl_s``; the engine-wide ``default_ttl_s`` and
``default_queue_ttl_s``) and retire ``"timed_out"`` past them; admission
caps at ``max_queue_depth`` (:class:`AdmissionRejected` with a
``retry_after_s`` hint); :meth:`LMServer.drain` and
:meth:`LMServer.shutdown` stop admission; a ``fault_injector``
(:mod:`repro_torch.runtime.faults`) drives a seeded chaos schedule: its
channel sites enter every step as device control tensors through
:func:`repro_torch.analog.channel.fault_scope`, rewritten in place before
each tick (so a captured tick reads the live values), and its host sites
squeeze the block pool, crash the prefill worker and corrupt the decode
payload, which the engine detects and retries. :meth:`LMServer.snapshot`
and :meth:`LMServer.restore` carry the whole engine (device state,
allocator, prefix index, queues, generator states) through one picklable
host tree, which :mod:`repro_torch.runtime.resilience`'s guardian rolls
back to.

The metrics count what ran on the device: ``prefill_batches`` the bucketed
batches, ``prefill_chunks`` every chunk step (also the one that prefills a
prefix-cache admission's unmatched suffix), ``decode_steps`` the plain
decode ticks and ``spec_ticks`` the verify ticks. The JAX engine's meshed
serving is not ported yet: passing ``mesh`` raises
``NotImplementedError`` naming the ROADMAP slice where it waits.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import copy
import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analog import channel as analog_channel
from repro_torch.analog.channel import seeded_generator
from repro_torch.core import backends, gemm, stationary
from repro_torch.kernels import ops
from repro_torch.models import lm as lm_helpers
from repro_torch.obs import health as obs_health
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.paging import BlockAllocator, PrefixIndex, blocks_for


@dataclasses.dataclass(frozen=True)
class _PrefixMatch:
    """Admission-time prefix-index lookup result."""
    block_ids: Tuple[int, ...] = ()
    m: int = 0              # positions covered by shared blocks
    full_hit: bool = False  # whole prompt minus last token is shared
    fork_extra: int = 0     # 1 extra block reserved for the deferred fork


_NO_MATCH = _PrefixMatch()


def _lookup_draft(ctx: np.ndarray, k: int, n: int = 3) -> np.ndarray:
    """Prompt-lookup drafting (self-drafting speculative decoding): find
    the most recent earlier occurrence of the context's trailing n-gram
    and propose the tokens that followed it, falling back to shorter
    n-grams and finally to repeating the last token. Host-side and
    deterministic; the verify step makes ANY draft exact under greedy —
    a bad draft just yields the single bonus token (= plain decode)."""
    L = len(ctx)
    out = np.full((k,), ctx[-1] if L else 0, np.int32)
    for nn in range(min(n, L - 1), 0, -1):
        key = ctx[L - nn:]
        for s in range(L - nn - 1, -1, -1):
            if np.array_equal(ctx[s:s + nn], key):
                take = ctx[s + nn:s + nn + k]
                out[:len(take)] = take
                return out
    return out


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` when the engine refuses a request instead of
    queueing it unboundedly (queue-depth cap hit, or the engine is
    draining). Carries ``retry_after_s``, the backoff hint a load balancer
    would surface as HTTP 429 Retry-After."""

    def __init__(self, msg: str, retry_after_s: float = 0.1):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


#: terminal request statuses: every submitted request ends in exactly one
TERMINAL_STATUSES = ("completed", "timed_out", "rejected", "failed")


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
    # queued -> active -> completed | timed_out | failed; rejected at
    # submit. A fault-aborted request goes active -> queued again (bounded
    # by retries), restarting its stream from scratch.
    status: str = "queued"
    ttl_s: Optional[float] = None        # total deadline from enqueue
    queue_ttl_s: Optional[float] = None  # admission deadline from enqueue
    max_retries: int = 0          # 0 = use the engine default
    retries: int = 0
    error: Optional[str] = None   # why a request was rejected or failed

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    def deadline(self, now: float) -> bool:
        """Total-TTL expiry at wall time ``now``."""
        return self.ttl_s is not None and now - self.t_enqueue > self.ttl_s

    def queue_deadline(self, now: float) -> bool:
        """Queue-TTL (or total-TTL) expiry while still waiting."""
        if self.queue_ttl_s is not None and \
                now - self.t_enqueue > self.queue_ttl_s:
            return True
        return self.deadline(now)

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
    source of truth.

    ``prefilling`` is not a counter: it is derived from the engine's
    in-flight chunked-prefill list through a callback bound by
    :class:`LMServer` (0 with no engine bound); writes to it are
    ignored."""

    _COUNTERS = (
        ("completed", "requests retired"),
        ("tokens", "tokens emitted by retired requests"),
        ("ticks", "engine ticks run"),
        ("admitted", "requests admitted into slots"),
        ("prefill_batches", "bucketed prefill batches launched"),
        ("prefill_chunks", "chunked-prefill steps run"),
        ("decode_steps", "batched decode steps run"),
        ("prefix_hits", "admissions that mapped shared prefix blocks"),
        ("prefix_full_hits", "admissions that skipped prefill entirely"),
        ("prefix_shared_blocks", "blocks mapped read-only at admission"),
        ("cow_forks", "copy-on-write block forks"),
        ("spec_ticks", "speculative verify ticks run"),
        ("spec_slot_ticks", "per-slot speculative verify steps"),
        ("spec_accepted", "draft tokens accepted"),
        ("timed_out", "requests retired by queue/decode deadline"),
        ("rejected", "requests refused at admission (queue cap/drain)"),
        ("failed", "requests terminally failed (retries exhausted)"),
        ("retried", "fault-aborted requests returned to the queue"),
    )

    def __init__(self, registry: MetricsRegistry):
        self._counters = {
            name: registry.counter(f"serve_{name}_total", help=help_)
            for name, help_ in self._COUNTERS}
        self._prefilling_fn: Optional[Callable[[], int]] = None

    def bind_prefilling(self, fn: Callable[[], int]) -> None:
        self._prefilling_fn = fn

    def __getitem__(self, key: str) -> int:
        if key == "prefilling":
            fn = self._prefilling_fn
            return int(fn()) if fn is not None else 0
        return int(self._counters[key].value)

    def __setitem__(self, key: str, value: int) -> None:
        if key == "prefilling":
            return
        self._counters[key].set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("scheduler metrics keys are fixed")

    def __iter__(self):
        yield from self._counters
        yield "prefilling"

    def __len__(self) -> int:
        return len(self._counters) + 1


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

    def record_admit(self, reqs: Sequence[Request],
                     prefill_batch: bool = True) -> None:
        """Mark ``reqs`` admitted; ``prefill_batch`` counts one bucketed
        prefill batch for them (chunked and prefix admissions count their
        chunk steps instead)."""
        t = time.perf_counter()
        for r in reqs:
            r.t_admit = t
            r.status = "active"
        self.metrics["admitted"] += len(reqs)
        if prefill_batch:
            self.metrics["prefill_batches"] += 1

    def emit(self, req: Request, tok: int) -> None:
        req.tokens_out.append(tok)
        if self.on_token is not None:
            self.on_token(req, tok)

    def retire(self, req: Request, status: str = "completed") -> Request:
        """Move ``req`` to ``finished`` with a terminal ``status``. The
        latency histograms observe only phases the request reached."""
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"non-terminal retirement status {status!r}")
        req.t_done = time.perf_counter()
        req.status = status
        self.metrics[status] += 1
        self.metrics["tokens"] += len(req.tokens_out)
        if req.t_first_token > 0:
            self._h_ttft.observe(req.ttft)
            self._h_tpot.observe(req.tpot)
        if req.t_admit > 0:
            self._h_queue.observe(req.queue_time)
        self.finished.append(req)
        return req

    def expire_queued(self, now: Optional[float] = None) -> List[Request]:
        """Retire waiting requests whose queue (or total) deadline passed;
        FCFS order of the survivors is preserved."""
        now = time.perf_counter() if now is None else now
        if not any(r.queue_ttl_s is not None or r.ttl_s is not None
                   for r in self.waiting):
            return []
        expired, kept = [], collections.deque()
        for r in self.waiting:
            if r.queue_deadline(now):
                r.error = "deadline exceeded in queue"
                expired.append(self.retire(r, status="timed_out"))
            else:
                kept.append(r)
        self.waiting = kept
        return expired

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
    "mesh": (None, "ROADMAP.md queue 1, slice 8b (meshed serving)"),
}


class _PrefillPipeline:
    """Prefill/decode overlap for :class:`LMServer` (``pipeline_depth``).

    A daemon worker thread runs the slot-independent half of bucketed
    prefill (``LMServer._prefill_compute``: the forward pass and the token
    selection, reading only the parameters and the prompt tokens) while
    the decode loop keeps ticking; the decode thread applies the scatter
    when a compute lands. On the card the worker enqueues on a CUDA stream
    of its own: a job first waits for the decode stream's work enqueued
    before it was submitted (weights re-encoded by ``switch_backend``, for
    one), and records an event behind its compute, on which the decode
    stream waits before the scatter. Backpressure is the ``depth`` bound
    on jobs in flight. Single producer, single worker, FIFO queues: jobs
    complete and scatter in submission order, so the prefill noise and
    sampling generators draw in the synchronous engine's order. A job
    carries its own copy of the fault controls of the tick that submitted
    it (the decode thread rewrites the engine's between ticks)."""

    _STALL_S = 300.0

    def __init__(self, server: "LMServer", depth: int):
        self.server = server
        self.depth = int(depth)
        self.inflight = 0      # submitted, not yet collected (decode thread)
        # chaos hook (runtime.faults ``worker_crash``): fail the NEXT job
        # the worker picks up, as a real compute crash would, exercising
        # the release/requeue recovery path
        self.crash_next = False
        dev = server.device
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._worker, name="lmserver-prefill", daemon=True)
        self._thread.start()

    @property
    def full(self) -> bool:
        return self.inflight >= self.depth

    def submit(self, job: Dict[str, Any]) -> None:
        if self.stream is not None:
            job["ready"] = torch.cuda.current_stream(
                self.server.device).record_event()
        self.inflight += 1
        self._in.put(job)

    def _compute(self, job: Dict[str, Any]):
        """(tok, new_cache, health values) of one job and, on the card, the
        event recorded behind them on the worker's stream."""
        srv = self.server
        # the job's fault controls, where the engine runs under them
        args = (job["tokens"], job["lens"]) + \
            (() if job.get("ctl") is None else (job["ctl"],))
        if self.stream is None:
            return srv._prefill_compute(*args), None
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(job["ready"])
            out = srv._prefill_compute(*args)
            return out, self.stream.record_event()

    def _worker(self) -> None:
        while True:
            job = self._in.get()
            if job is None:
                return
            if self.crash_next:
                self.crash_next = False
                self._out.put((job, None, RuntimeError(
                    "injected prefill worker crash")))
                continue
            try:
                self._out.put((job, self._compute(job), None))
            except Exception as e:   # the decode thread retires the job
                self._out.put((job, None, e))

    def collect(self, block: bool) -> List[Tuple[Dict[str, Any], Any, Any]]:
        """Finished jobs, oldest first: everything already done, plus, when
        ``block`` (nothing else can make progress), wait for at least
        one."""
        items: List[Tuple[Dict[str, Any], Any, Any]] = []
        while True:
            try:
                if block and not items:
                    items.append(self._out.get(timeout=self._STALL_S))
                else:
                    items.append(self._out.get_nowait())
            except queue.Empty:
                if block and not items:
                    raise RuntimeError(
                        f"prefill pipeline made no progress for "
                        f"{self._STALL_S:.0f}s (worker dead?)")
                break
        self.inflight -= len(items)
        return items

    def close(self) -> None:
        self._in.put(None)
        self._thread.join(timeout=10.0)


class _StepGraph:
    """A tick step captured as a CUDA graph: the graph, the payload tensor
    it writes, and the kernel launches one replay makes (the wrappers count
    their launches in Python, which a replay does not run)."""

    def __init__(self, graph, payload: torch.Tensor,
                 launches: Dict[str, int]):
        self.graph = graph
        self.payload = payload
        self.launches = launches

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.payload


#: the engine's generator streams: decode (and verify) ticks, prefill
#: batches, prefill chunks
_STREAMS = ("decode", "prefill", "chunk")


def _readout_moduli(policy) -> Tuple[int, ...]:
    """The moduli a policy's readout runs over: the RRNS set under the
    correcting modes, the base moduli otherwise."""
    from repro_torch.analog import rrns
    if policy.mode in ("mirage_rrns", "mirage_rrns_ref"):
        return rrns.rrns_moduli(policy)
    return tuple(policy.moduli)


def _tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict (the engine's state)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _load_tree(dst, src) -> bool:
    """Copy the host tree ``src`` into the tensors of ``dst`` in place when
    both have the same keys, shapes and dtypes; False (nothing written)
    otherwise."""
    def same(d, s):
        if isinstance(d, dict) or isinstance(s, dict):
            return isinstance(d, dict) and isinstance(s, dict) and \
                d.keys() == s.keys() and all(same(d[k], s[k]) for k in d)
        return d.shape == s.shape and d.dtype == s.dtype

    def load(d, s):
        if isinstance(d, dict):
            for k in d:
                load(d[k], s[k])
        else:
            d.copy_(s)

    if not same(dst, src):
        return False
    load(dst, src)
    return True


class LMServer:
    """Continuous-batching serving engine (the deployment path).

    Device state is one dict of tensors on the model's device::

        {"cache":   stacked cache, per-slot ``idx`` (LM.cache_spec),
         "last_tok": (S,) int32   last emitted token per slot,
         "active":   (S,) bool    slot occupancy mask,
         "emitted":  (S,) int32   tokens emitted per slot,
         "eos":      (S,) int32   per-slot EOS id (-1 = none),
         "max_tok":  (S,) int32   per-slot token budget}

    plus ``"health"``, the analog-health accumulators, under a policy
    that reports any (:func:`repro_torch.obs.health.spec`).

    ``tick()`` = admit (bucketed batched prefill + scatter insert, or one
    prefill chunk) then one decode step for every slot at once (a verify
    step under ``spec_k``). The model owns its parameters, so the engine
    takes the model alone (the JAX engine takes ``params`` beside it).

    ``stationary_weights``: run the GEMMs against stationary residues
    programmed once here. ``None`` follows the JAX engine's rule: on where
    the policy's backend ``supports_stationary_residues`` and the model is
    of the dense or SSM family (its MoE layers encode per call, as the JAX
    engine's do; ``True`` programs the expert stacks too). The encodings
    are installed on the model's ``Dense`` and MoE modules (``False``
    clears them), so one model serves one engine's programming at a time.

    ``cache_layout``, ``block_size``, ``n_blocks``, ``prefill_chunk``,
    ``prefix_cache``, ``spec_k``, ``block_placement``, ``pipeline_depth``,
    ``max_retries``, ``instrument``, ``fault_injector``,
    ``max_queue_depth``, ``default_ttl_s`` and ``default_queue_ttl_s`` are
    the JAX engine's options with its checks (see the module docstring).
    ``instrument=False`` builds the engine without the analog-health
    counters. An engine with ``pipeline_depth`` owns a worker thread:
    :meth:`close` stops it.

    Every step writes the state's tensors in place, so a tick captured as
    a CUDA graph (:meth:`warmup`) reads and writes them at the addresses
    it captured; only :meth:`resize_slots`, :meth:`resize_block_pool` and
    :meth:`switch_backend` replace tensors, and they drop the graphs.
    """

    def __init__(self, model, cap: int, batch_slots: int = 8,
                 greedy: bool = True,
                 buckets: Optional[Sequence[int]] = None,
                 on_token: Optional[Callable[[Request, int], None]] = None,
                 scheduler: Optional[Scheduler] = None,
                 sample_seed: int = 0,
                 stationary_weights: Optional[bool] = None,
                 cache_layout: str = "dense",
                 block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec_k: int = 0,
                 block_placement: str = "locality",
                 pipeline_depth: int = 0,
                 max_retries: int = 1,
                 instrument: bool = True,
                 fault_injector=None,
                 max_queue_depth: Optional[int] = None,
                 default_ttl_s: Optional[float] = None,
                 default_queue_ttl_s: Optional[float] = None,
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
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got "
                             f"{pipeline_depth}")
        if pipeline_depth and (prefill_chunk is not None or prefix_cache):
            raise ValueError(
                "pipeline_depth overlaps whole-prompt bucketed prefill with "
                "decode; chunked prefill already interleaves by construction "
                "and prefix matching is ordered host state — combine with "
                "neither")
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout {cache_layout!r}")
        if prefill_chunk is not None and cache_layout != "paged":
            raise ValueError(
                "prefill_chunk requires cache_layout='paged' (chunk steps "
                "scatter through block tables with linear addressing; the "
                "dense ring keeps whole-prompt bucketed prefill)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefix_cache and cache_layout != "paged":
            raise ValueError(
                "prefix_cache requires cache_layout='paged' (blocks are the "
                "sharing unit; the dense rings have nothing to share)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k:
            if cache_layout != "paged":
                raise ValueError(
                    "spec_k requires cache_layout='paged' (the verify step "
                    "writes k+1 positions through block tables; the dense "
                    "ring is single-token)")
            if not greedy:
                raise ValueError(
                    "spec_k requires greedy=True (verify-then-accept is "
                    "exact under greedy sampling only)")
        self.model = model
        self.cap = cap
        self.greedy = greedy
        self.n_slots = batch_slots
        self.device = model.device
        self.cache_len = model.cache_len(cap)
        self.cache_layout = cache_layout
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.spec_k = int(spec_k)
        # pure-SSM models have no KV to page (their recurrent state is O(1)
        # per slot and stays dense under both layouts): no pool, no tables;
        # the hybrid family pages its shared block's KV
        has_pages = not (model.kind == "mamba" and not model.cfg.attn_every)
        if cache_layout == "paged" and has_pages:
            mb = blocks_for(cap, block_size)
            # default pool = slots * ceil(cap/bs): no memory saving but never
            # exhausts; a smaller n_blocks sized to the live-token budget
            # realizes the paged win
            nb = n_blocks if n_blocks is not None else batch_slots * mb
            self.alloc: Optional[BlockAllocator] = BlockAllocator(
                nb, block_size, batch_slots, mb, placement=block_placement)
        else:
            self.alloc = None
        # prefix caching needs pages to share AND skippable prefill: an SSM
        # state at the match point cannot be rebuilt from blocks, so the
        # flag is inert for the mamba kind, the hybrid's pool notwithstanding
        # (the engine never shares)
        self.prefix_cache = bool(prefix_cache) and self.alloc is not None \
            and model.kind != "mamba"
        self.prefix_index: Optional[PrefixIndex] = \
            PrefixIndex(block_size) if self.prefix_cache else None
        # chunked-prefill in-flight entries: {"req", "slot", "pos"}
        self.prefilling: List[Dict[str, Any]] = []
        self._slot_pos = [0] * batch_slots   # host mirror of each slot's idx
        # lifetime block reservation per occupied slot (see _free_budget)
        self._slot_budget = [0] * batch_slots
        # linear position cap per occupied slot (prompt + max_tokens): the
        # speculative ensure() clamps here so draft positions past the
        # request's own budget never allocate past its reservation
        self._slot_poscap = [0] * batch_slots
        # full-prefix-hit slots owe one deferred copy-on-write fork when
        # their first decode write lands inside a shared block; the free
        # block for it is reserved until the guard resolves it
        self._fork_pending = [0] * batch_slots
        # SSM recurrences carry state through padded steps, so that family
        # batches prefill by EXACT prompt length (still batched across
        # same-length prompts); attention families right-pad to buckets
        self.pad_prefill = model.kind != "mamba"
        self.buckets = tuple(sorted(buckets)) if buckets else \
            default_buckets(self.cache_len)
        if self.buckets[-1] > self.cache_len:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds cache "
                             f"capacity {self.cache_len}")
        self.scheduler = scheduler or Scheduler(on_token=on_token)
        if max_queue_depth is not None:
            self.scheduler.max_queue_depth = int(max_queue_depth)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        # request-level robustness: per-request deadlines default to these
        # engine-wide TTLs at submit; fault-aborted requests retry up to
        # ``max_retries`` times (per request: ``Request.max_retries``)
        # before failing terminally
        self.default_ttl_s = default_ttl_s
        self.default_queue_ttl_s = default_queue_ttl_s
        self.max_retries = int(max_retries)
        self._draining = False
        self.last_prefill_error: Optional[BaseException] = None
        # chaos harness (runtime.faults): host sites apply between ticks;
        # channel sites enter every step through the device control
        # tensors ``_ctl_dev`` (see _compute_fault_ctl)
        self._injector = fault_injector
        self._chaos_tick = 0
        # decode and verify steps run: the guardian's clock
        self._tick_count = 0
        # one sampling generator per stream: the prefill worker and the
        # decode loop never draw from one generator at once
        self._sample_gens = {
            stream: seeded_generator(self.device, "sample", sample_seed,
                                     stream) for stream in _STREAMS}

        policy = model.policy
        lm_helpers.check_policy(model.cfg, policy)
        backend = backends.resolve(policy)
        self._reseed_noise(policy)
        self.instrument = bool(instrument)
        self._set_health_spec(policy)
        self._compute_fault_ctl()
        if stationary_weights and not backend.supports_stationary_residues:
            raise ValueError(
                f"stationary_weights=True needs a backend that supports "
                f"stationary residues; {policy.mode!r} does not")
        # None follows the backend and the family, also across
        # switch_backend
        self._stationary_auto = stationary_weights is None
        self.stationary_weights = self._auto_stationary(backend) \
            if stationary_weights is None else bool(stationary_weights)
        stationary.install(model, stationary.encode_stationary_params(
            model, policy) if self.stationary_weights else None)

        self.state = self._init_state(batch_slots)
        self._drafts = self._init_drafts(batch_slots)
        # shapes each step has run (compile_counts) and the captured ticks
        self._shapes: Dict[str, set] = collections.defaultdict(set)
        self._graphs: Dict[str, _StepGraph] = {}
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self._bound_registry: Optional[MetricsRegistry] = None
        self._bind_observability()
        self.pipeline_depth = int(pipeline_depth)
        self._pipe: Optional[_PrefillPipeline] = \
            _PrefillPipeline(self, self.pipeline_depth) \
            if self.pipeline_depth else None

    def _auto_stationary(self, backend) -> bool:
        """The JAX engine's rule for ``stationary_weights=None``: program
        once where the backend can and every GEMM weight of the family
        flows through ``dense`` (``attn_mlp``, the vlm's projector too, and
        ``mamba``: its in/out projections and head); the MoE family's
        expert stacks encode per call, and so does a model whose options
        merge the parallel block's projections (the merged GEMM
        concatenates the raw weights)."""
        return backend.supports_stationary_residues and \
            self.model.kind in ("attn_mlp", "mamba") and \
            not self.model.opt.merge_parallel_proj

    # ------------------------------------------------------------------
    # device-side steps
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _init_state(self, n_slots: int) -> Dict[str, Any]:
        def full(value, dtype):
            return torch.full((n_slots,), value, dtype=dtype,
                              device=self.device)
        if self.alloc is not None:
            cache = self.model.init_cache(
                n_slots, self.cap, per_slot_idx=True, layout="paged",
                block_size=self.block_size, n_blocks=self.alloc.n_blocks)
        else:
            cache = self.model.init_cache(n_slots, self.cap,
                                          per_slot_idx=True)
        state = {
            "cache": cache,
            "last_tok": full(0, torch.int32),
            "active": full(False, torch.bool),
            "emitted": full(0, torch.int32),
            "eos": full(-1, torch.int32),
            "max_tok": full(0, torch.int32),
        }
        if self._health_spec:
            state["health"] = obs_health.init(self._health_spec, self.device)
        return state

    @torch.inference_mode()
    def _sync_tables(self) -> None:
        """Copy the allocator's block tables to the device's ``bt`` leaf,
        only when alloc/free/share/fork changed them."""
        if self.alloc is not None and self.alloc.dirty:
            self.state["cache"]["bt"].copy_(
                torch.from_numpy(self.alloc.tables))
            self.alloc.dirty = False

    def _init_drafts(self, n_slots: int) -> Optional[torch.Tensor]:
        """The verify tick's draft tokens, (S, k) on the device: the host
        copies each tick's drafts into this one tensor, which a captured
        verify tick reads."""
        if not self.spec_k:
            return None
        return torch.zeros((n_slots, self.spec_k), dtype=torch.int32,
                           device=self.device)

    def _reseed_noise(self, policy) -> None:
        """One noise generator per stream, seeded from ``policy.noise_seed``
        (0 when unset), and one per stream for the bursts drawn under a
        fault scope."""
        seed = policy.noise_seed if policy.noise_seed is not None else 0
        self._noise_gens = {
            stream: seeded_generator(self.device, "serve", seed, stream)
            for stream in _STREAMS}
        self._burst_gens = {
            stream: seeded_generator(self.device, "serve", seed, stream,
                                     "burst") for stream in _STREAMS}

    def _set_health_spec(self, policy) -> None:
        """The analog-health accumulators' spec (none when the engine is
        not instrumented) and the moduli its per-channel counters run
        over."""
        self._health_spec = obs_health.spec(policy) if self.instrument \
            else {}
        self._health_moduli = _readout_moduli(policy) \
            if self._health_spec else ()

    def _compute_fault_ctl(self) -> None:
        """Whether the steps run under the channel fault controls: only
        when an injector schedules a channel fault AND the current backend
        routes through the analog channel. Re-run by :meth:`switch_backend`
        (the fp32 fallback has no channel to fault). The controls live in
        ``_ctl_dev``, device tensors a captured step reads at their
        addresses: :meth:`_load_controls` rewrites them in place."""
        pol = self.model.policy
        self._ctl_n_moduli = len(_readout_moduli(pol)) \
            if backends.resolve(pol).supports_noise else 0
        self._use_fault_ctl = (
            self._injector is not None and self._ctl_n_moduli > 0
            and self._injector.channel_faults_scheduled())
        self._ctl_dev = analog_channel.identity_fault_controls(
            self._ctl_n_moduli, self.device) if self._use_fault_ctl else None
        self._ctl_loaded = None       # the host values _ctl_dev holds

    def _load_controls(self, values) -> None:
        """Write the injector's control values for this tick into the
        device control tensors, in place (only when they changed)."""
        key = tuple(np.asarray(values[k]).tobytes()
                    for k in analog_channel.FAULT_CONTROL_DTYPES)
        if key == self._ctl_loaded:
            return
        for k, v in analog_channel.fault_control_tensors(values).items():
            self._ctl_dev[k].copy_(v)
        self._ctl_loaded = key

    def _seen(self, step: str, shape) -> None:
        """Record a shape ``step`` ran at (:meth:`compile_counts`)."""
        self._shapes[step].add(shape)

    @contextlib.contextmanager
    def _step_scope(self, stream: str, ctl=None):
        """Ambient noise of one step (its stream's generators), the fault
        controls (``ctl``, else the engine's, where channel faults are
        scheduled) and, under a policy with health counters, their
        collection: yields the dict the step's records land in, for
        :meth:`_fold`."""
        bursts = self._burst_gens[stream] if self._use_fault_ctl else None
        ctl = ctl if ctl is not None else self._ctl_dev
        with gemm.noise_scope(self._noise_gens[stream], bursts), \
                analog_channel.fault_scope(ctl):
            if not self._health_spec:
                yield {}
                return
            with obs_health.collect() as hc:
                yield hc.values

    def _fold(self, hvals: Dict[str, torch.Tensor]) -> None:
        """Add a step's health records into the accumulators, in place."""
        if self._health_spec:
            obs_health.fold(self.state["health"], hvals)

    def _select(self, logits: torch.Tensor, stream: str) -> torch.Tensor:
        """Next token per row of (B, V) logits: greedy argmax (first max on
        ties, as jnp.argmax) or a categorical draw from the stream's
        sampling generator (``torch.multinomial``'s one-sample draw,
        argmin of Exp(1) / p, without its validity check, which reads the
        device from the host)."""
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits, dim=-1)
        q = torch.empty_like(probs).exponential_(
            1.0, generator=self._sample_gens[stream])
        return torch.argmin(q / probs, dim=-1).to(torch.int32)

    @torch.inference_mode()
    def _decode_tick(self) -> torch.Tensor:
        """One decode step for every slot, written into the state in place;
        returns the (S, 2) payload [token | -1, done] still on the
        device."""
        state = self.state
        idx0 = state["cache"]["idx"]
        # the SSM family's inactive slots keep their recurrent state: a
        # slot mid-chunked-prefill carries real state between its chunks
        with self._step_scope("decode") as hvals:
            logits, stepped = self.model.decode_step(
                state["cache"], state["last_tok"][:, None],
                active=state["active"])
        self._fold(hvals)
        tok = self._select(logits[:, -1, :], "decode")
        active = state["active"]
        emitted = state["emitted"] + active.to(torch.int32)
        hit_eos = (state["eos"] >= 0) & (tok == state["eos"])
        done = active & (hit_eos | (emitted >= state["max_tok"]))
        payload = torch.stack([torch.where(active, tok, -1),
                               done.to(torch.int32)], dim=-1)
        # inactive slots don't advance their position (their k/v writes land
        # on a frozen slot position or a dropped page and are overwritten on
        # reuse)
        idx0.copy_(torch.where(active, stepped["idx"], idx0))
        state["last_tok"].copy_(torch.where(active, tok, state["last_tok"]))
        state["emitted"].copy_(emitted)
        active.copy_(active & ~done)
        return payload

    @torch.inference_mode()
    def _prefill_compute(self, tokens: np.ndarray, lens: np.ndarray,
                         ctl=None):
        """The slot-independent half of bucketed prefill: the forward pass
        and the token selection, from the parameters and the prompt tokens
        alone. Nothing it reads or writes belongs to the live state, which
        is what lets the pipeline's worker run it beside the decode loop
        (with the fault controls ``ctl`` its job carries). Returns (tok,
        dense prefill cache, health records)."""
        dev = self.device
        with self._step_scope("prefill", ctl) as hvals:
            logits, new_cache = self.model.prefill(
                torch.from_numpy(tokens).to(dev), self.cap,
                lens=torch.from_numpy(lens).to(dev))
        return self._select(logits[:, -1, :], "prefill"), new_cache, hvals

    @torch.inference_mode()
    def _prefill_scatter(self, tok: torch.Tensor,
                         new_cache: Dict[str, torch.Tensor],
                         hvals: Dict[str, torch.Tensor], slots: np.ndarray,
                         eos: np.ndarray, max_tok: np.ndarray
                         ) -> torch.Tensor:
        """The state half: insert a computed prefill into the live state
        and return the (B, 2) payload [token, done] on the device. Rows
        whose slot is the ``n_slots`` sentinel (batch padding) are
        dropped."""
        dev = self.device
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
        self._fold(hvals)
        return torch.stack([tok, done0.to(torch.int32)], dim=-1)

    def _prefill_insert(self, tokens: np.ndarray, lens: np.ndarray,
                        slots: np.ndarray, eos: np.ndarray,
                        max_tok: np.ndarray) -> torch.Tensor:
        """Synchronous bucketed prefill of one admission group: compute,
        then scatter, on the calling thread."""
        self._seen("prefill_insert", tokens.shape)
        return self._prefill_scatter(*self._prefill_compute(tokens, lens),
                                     slots, eos, max_tok)

    @torch.inference_mode()
    def _chunk_step(self, tokens: np.ndarray, slot: int, pos0: int,
                    true_len: int, final: Optional[Tuple[int, int]] = None
                    ) -> Optional[torch.Tensor]:
        """One prefill chunk of ``slot`` (``tokens`` (1, C) from position
        ``pos0``, ``true_len`` of them real). A middle chunk returns None;
        the final one (``final`` = (eos, max_tokens)) selects the first
        token, arms the slot and returns the (1, 2) payload [token, done]
        on the device."""
        self._seen("chunk_mid" if final is None else "chunk_last",
                   tokens.shape)
        with self._step_scope("chunk") as hvals:
            logits, _ = self.model.prefill_chunk(
                self.state["cache"], torch.from_numpy(tokens).to(self.device),
                slot, pos0, true_len)
        self._fold(hvals)
        if final is None:
            return None
        eos, max_tok = final
        tok = self._select(logits[:, -1, :], "chunk")         # (1,)
        done0 = (tok == eos) if eos >= 0 else torch.zeros_like(
            tok, dtype=torch.bool)
        if max_tok <= 1:
            done0 = torch.ones_like(done0)
        state = self.state
        state["last_tok"][slot] = tok[0]
        state["active"][slot] = ~done0[0]
        state["emitted"][slot] = 1
        state["eos"][slot] = eos
        state["max_tok"][slot] = max_tok
        return torch.stack([tok, done0.to(torch.int32)], dim=-1)

    @torch.inference_mode()
    def _attach(self, slot: int, last_tok: int, idx: int, eos: int,
                max_tok: int) -> None:
        """Full-prefix-hit admission: the whole prompt minus its last token
        is already in shared blocks, so the slot attaches with NO prefill —
        ``idx = L-1``, ``last_tok = prompt[-1]``, ``emitted = 0`` (the next
        decode tick produces the request's FIRST token)."""
        self._seen("attach", ())
        state = self.state
        state["cache"]["idx"][slot] = idx
        state["last_tok"][slot] = last_tok
        state["active"][slot] = True
        state["emitted"][slot] = 0
        state["eos"][slot] = eos
        state["max_tok"][slot] = max_tok

    @torch.inference_mode()
    def _verify_tick(self) -> torch.Tensor:
        """Speculative verify tick: score the ``k`` drafts in
        ``self._drafts`` + 1 bonus position per slot in one step and accept
        on the device, writing the state in place. Exactly greedy: a token
        is accepted iff every draft before it equals the verified argmax.
        Returns the (S, k+2) payload [tokens | -1 ..., done]."""
        k = self.spec_k
        state = self.state
        idx0 = state["cache"]["idx"]
        S = idx0.shape[0]
        dev = self.device
        drafts_d = self._drafts
        tokens = torch.cat([state["last_tok"][:, None], drafts_d], dim=1)
        with self._step_scope("decode") as hvals:
            logits, _, steps = self.model.verify_step(state["cache"], tokens)
        self._fold(hvals)
        g = torch.argmax(logits, dim=-1).to(torch.int32)       # (S, k+1)
        active = state["active"]
        i32 = torch.int32
        # leading-ones acceptance: position j is kept iff all drafts
        # before it matched greedy, it fits the remaining budget, and
        # no earlier kept token was EOS (the EOS itself is kept)
        lead = torch.cumprod((drafts_d == g[:, :-1]).to(i32), dim=1)
        ok = torch.cat([torch.ones((S, 1), dtype=i32, device=dev),
                        lead.to(i32)], dim=1)
        rem = state["max_tok"] - state["emitted"]
        j = torch.arange(k + 1, device=dev)[None, :]
        is_eos = (state["eos"][:, None] >= 0) & (g == state["eos"][:, None])
        eos_before = torch.cat(
            [torch.zeros((S, 1), dtype=i32, device=dev),
             torch.cumsum(is_eos.to(i32), dim=1)[:, :-1].to(i32)], dim=1)
        keep = torch.cumprod(ok * (j < rem[:, None]).to(i32) *
                             (eos_before == 0).to(i32), dim=1)
        a = torch.clamp_min(torch.sum(keep, dim=1), 1)        # (S,)
        last = torch.gather(g, 1, (a - 1)[:, None].long())[:, 0]
        emitted = state["emitted"] + torch.where(active, a, 0).to(i32)
        kept_eos = torch.any((keep > 0) & is_eos, dim=1)
        done = active & (kept_eos | (emitted >= state["max_tok"]))
        toks = torch.where(active[:, None] & (keep > 0), g, -1)
        payload = torch.cat([toks.to(i32), done.to(i32)[:, None]], dim=1)
        # rejected-tail KV needs no rollback (the next tick writes
        # positions idx..idx+k before gathering); idx advances by the
        # accepted count. Inactive slots stay frozen.
        idx0.copy_(torch.where(active, idx0 + a, idx0).to(i32))
        if steps is not None:
            # recurrent rollback: each slot's state after token a-1
            rows = torch.arange(S, device=dev)
            for name in ("ssm", "conv"):
                leaf = state["cache"][name]
                sel = steps[name][:, (a - 1).long(), rows]    # (nl, S, ...)
                m = active.reshape((1, -1) + (1,) * (sel.dim() - 2))
                leaf.copy_(torch.where(m, sel, leaf))
        state["last_tok"].copy_(torch.where(active, last, state["last_tok"]))
        state["emitted"].copy_(emitted)
        active.copy_(active & ~done)
        return payload

    def _tick_step(self, name: str, step: Callable[[], torch.Tensor]
                   ) -> torch.Tensor:
        """Run a tick step: its captured graph when there is one, else the
        step itself."""
        graph = self._graphs.get(name)
        if graph is not None:
            return graph.replay()
        self._seen(name, self.n_slots)
        return step()

    @staticmethod
    def _to_host(payload: torch.Tensor) -> np.ndarray:
        """The device->host transfer of a step's packed payload."""
        return payload.cpu().numpy()

    # ------------------------------------------------------------------
    # host-side loop
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if self._draining:
            req.status = "rejected"
            req.error = "server draining"
            self.scheduler.metrics["rejected"] += 1
            raise AdmissionRejected(
                f"request {req.rid}: server is draining")
        if req.ttl_s is None:
            req.ttl_s = self.default_ttl_s
        if req.queue_ttl_s is None:
            req.queue_ttl_s = self.default_queue_ttl_s
        # chunked prefill streams prompts up to the paged cache's linear
        # capacity; bucketed prefill is bounded by the largest bucket
        limit = self.cap if self.prefill_chunk else self.buckets[-1]
        if len(req.prompt) > limit:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} exceeds "
                + (f"cache capacity {limit}" if self.prefill_chunk else
                   f"largest bucket {limit}"))
        if self.alloc is not None:
            # paged addressing is linear — it cannot ring-wrap like the
            # dense layout, so a lifetime that outgrows the table capacity
            # would silently drop its own recent KV. Reject loudly.
            capacity = self.alloc.max_blocks_per_slot * self.block_size
            if len(req.prompt) + req.max_tokens > capacity:
                raise ValueError(
                    f"request {req.rid}: prompt {len(req.prompt)} + "
                    f"max_tokens {req.max_tokens} exceeds the paged cache's "
                    f"linear capacity {capacity}; raise cap or lower "
                    f"max_tokens")
            # and a lifetime block budget exceeding the whole pool could
            # never be admitted — reject instead of livelocking the FCFS
            # queue behind an unsatisfiable head-of-line wait
            if self._block_budget(req) > self.alloc.n_blocks:
                raise ValueError(
                    f"request {req.rid}: prompt {len(req.prompt)} + "
                    f"max_tokens {req.max_tokens} needs "
                    f"{self._block_budget(req)} blocks of {self.block_size} "
                    f"but the pool holds {self.alloc.n_blocks}; grow "
                    f"n_blocks")
        self.scheduler.submit(req)

    def _bucket(self, length: int) -> int:
        """The prefill length of a prompt: its bucket, or the exact length
        for the SSM family."""
        return pick_bucket(length, self.buckets) if self.pad_prefill \
            else length

    def _block_budget(self, req: Request) -> int:
        """Blocks a request needs over its whole lifetime: prompt plus
        decode growth up to ``max_tokens`` (``submit`` bounds this by the
        per-slot table capacity)."""
        return blocks_for(len(req.prompt) + req.max_tokens, self.block_size)

    def _free_budget(self) -> int:
        """Pool blocks neither allocated nor RESERVED for the future decode
        growth of already-admitted requests. Admission gates on this — not
        on the raw free count — so a tight pool serializes admissions
        instead of exhausting mid-decode."""
        reserved = sum(
            max(0, self._slot_budget[i] - int(self.alloc.n_owned[i]))
            + self._fork_pending[i]
            for i, r in enumerate(self.slot_req) if r is not None)
        return self.alloc.free_count - reserved

    # -- prefix caching (copy-on-write shared blocks) -------------------

    def _match_prefix(self, prompt) -> _PrefixMatch:
        """Look the prompt up in the prefix index. A FULL hit means shared
        blocks cover positions ``0..L-2`` (``ceil((L-1)/bs)`` blocks):
        prefill is skipped entirely and the first decode tick emits the
        first token, writing position ``L-1`` itself (forking the last
        shared block first when ``L-1`` falls inside it). A partial hit
        covers ``m = K*bs`` positions; the suffix prefills as one chunk."""
        if not self.prefix_cache:
            return _NO_MATCH
        L = len(prompt)
        if L < 2:
            return _NO_MATCH
        ids = self.prefix_index.match(np.asarray(prompt, np.int32))
        if not ids:
            return _NO_MATCH
        bs = self.block_size
        need_full = blocks_for(L - 1, bs)
        if len(ids) >= need_full:
            return _PrefixMatch(tuple(ids[:need_full]), L - 1, True,
                                1 if (L - 1) % bs else 0)
        return _PrefixMatch(tuple(ids), len(ids) * bs, False, 0)

    def _register_prefix(self, slot: int, req: Request) -> None:
        """Index the slot's full prompt blocks so later admissions can map
        them read-only. Decode writes never land in them (generated tokens
        start at position L >= full-block end); a full-hit sharer's write
        at L-1 forks first (copy-on-write guard)."""
        if self.prefix_index is None:
            return
        n_full = len(req.prompt) // self.block_size
        if n_full == 0 or int(self.alloc.lo[slot]) > 0:
            return
        ids = [int(b) for b in self.alloc.tables[slot, :n_full]]
        if any(b == self.alloc.sentinel for b in ids):
            return
        self.prefix_index.insert_chain(np.asarray(req.prompt, np.int32),
                                       ids)

    def _release_slot(self, slot: int) -> None:
        freed = self.alloc.release(slot) if self.alloc is not None else []
        self._fork_pending[slot] = 0
        if freed and self.prefix_index is not None:
            self.prefix_index.evict_blocks(freed)

    @torch.inference_mode()
    def _copy_block(self, src: int, dst: int) -> None:
        """Device-side page copy for a copy-on-write fork (every pool
        leaf; layer dim leads, block dim is axis 1)."""
        cache = self.state["cache"]
        for leaf in lm_helpers.pool_keys(cache):
            cache[leaf][:, dst] = cache[leaf][:, src]

    def _cow_guard(self, slot: int, pos_lo: int, pos_hi: int) -> None:
        """Before device writes at positions ``[pos_lo, pos_hi)`` of a
        slot: fork shared blocks (the sharer gets a private copy — other
        holders keep the original) and evict solely-owned but still-indexed
        blocks from the prefix index (their content is about to diverge
        from the indexed token chain)."""
        if self.prefix_index is None or self.alloc is None:
            return
        bs = self.block_size
        hi = max(pos_hi, pos_lo + 1)
        for j in range(pos_lo // bs, (hi - 1) // bs + 1):
            if j >= int(self.alloc.n_owned[slot]):
                break
            b = int(self.alloc.tables[slot, j])
            if b == self.alloc.sentinel:
                continue
            if self.alloc.is_shared(b):
                src, dst = self.alloc.fork_cow(slot, j)
                self._copy_block(src, dst)
                self.scheduler.metrics["cow_forks"] += 1
            elif self.prefix_index.contains_block(b):
                self.prefix_index.evict_blocks([b])
        self._fork_pending[slot] = 0

    def _maybe_trim(self, slot: int) -> None:
        """Sliding-window models: free blocks wholly behind the attention
        window mid-flight (the validity mask already hides them). Refcount-
        aware — a shared prefix block outlives one slot's trim."""
        w = self.model.cfg.sliding_window
        if self.alloc is None or not w:
            return
        freed = self.alloc.trim_below(slot, self._slot_pos[slot] - w + 1)
        if freed and self.prefix_index is not None:
            self.prefix_index.evict_blocks(freed)

    def _take_admissible(self, n: int) -> List[Request]:
        """Pop up to ``n`` waiting requests FCFS. Under the paged layout,
        stop at the first whose lifetime block budget cannot be reserved
        (head-of-line admission keeps FCFS order; blocked work waits for
        retirements to free blocks)."""
        if self.alloc is None:
            return self.scheduler.take(n)
        out, budget = [], self._free_budget()
        while self.scheduler.waiting and len(out) < n:
            need = self._block_budget(self.scheduler.waiting[0])
            if need > budget:
                break
            budget -= need
            out.append(self.scheduler.waiting.popleft())
        return out

    def _admit(self) -> List[Request]:
        """Admit waiting requests into free slots (bucketed batched
        prefill, chunked prefill when ``prefill_chunk`` is set, or one at
        a time through the prefix index). Returns requests retired AT
        admission (prefill token was EOS / one-token budget); their slots
        are immediately reusable, so the loop keeps admitting while slots
        free up and work waits."""
        if self.prefill_chunk is not None:
            return self._admit_chunked()
        if self.prefix_cache:
            return self._admit_prefix()
        if self._pipe is not None:
            return self._admit_pipelined()
        retired: List[Request] = []
        while True:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free or not self.scheduler.waiting:
                return retired
            reqs = self._take_admissible(len(free))
            if not reqs:
                return retired
            groups: Dict[int, List[Request]] = {}
            for r in reqs:
                groups.setdefault(self._bucket(len(r.prompt)), []).append(r)
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
                    slot = int(slots[j])
                    if self.alloc is not None:
                        # reserved by _take_admissible: cannot fail
                        self.alloc.ensure(slot, len(r.prompt))
                        self._slot_budget[slot] = self._block_budget(r)
                    self._slot_poscap[slot] = len(r.prompt) + r.max_tokens
                self.scheduler.record_admit(group)
                self._sync_tables()
                with obs_trace.get_tracer().span(
                        "serve.prefill_batch", {"bucket": Lb, "batch": B}):
                    payload = self._to_host(self._prefill_insert(
                        tokens, lens, slots, eos, max_tok))
                # TTFT is stamped only once the token bytes are on the host
                t_host = time.perf_counter()
                for j, r in enumerate(group):
                    slot = int(slots[j])
                    r.t_first_token = t_host
                    self.scheduler.emit(r, int(payload[j, 0]))
                    if payload[j, 1]:
                        self._release_slot(slot)
                        retired.append(self.scheduler.retire(r))
                    else:
                        self.slot_req[slot] = r
                        self._slot_pos[slot] = len(r.prompt)

    def _admit_pipelined(self) -> List[Request]:
        """Pipelined whole-prompt admission: claim slots and blocks and hand
        the bucketed prefill's compute to the worker; apply finished
        scatters here. Slots claimed at submission sit in
        ``self.prefilling`` (decode skips them, the gauge counts them, the
        drain waits on them). Backpressure: stop claiming once
        ``pipeline_depth`` jobs are in flight."""
        retired: List[Request] = []
        pipe = self._pipe
        while not pipe.full:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free or not self.scheduler.waiting:
                break
            reqs = self._take_admissible(len(free))
            if not reqs:
                break
            groups: Dict[int, List[Request]] = {}
            for r in reqs:
                groups.setdefault(self._bucket(len(r.prompt)), []).append(r)
            # one take may submit a few groups past the depth bound; the
            # outer loop re-checks before claiming any further requests
            for Lb, group in sorted(groups.items()):
                B = len(group)
                Bp = 1 << (B - 1).bit_length()
                tokens = np.zeros((Bp, Lb), np.int32)
                lens = np.ones((Bp,), np.int32)
                slots = np.full((Bp,), self.n_slots, np.int64)
                eos = np.full((Bp,), -1, np.int32)
                max_tok = np.ones((Bp,), np.int32)
                my_slots = []
                for j, r in enumerate(group):
                    tokens[j, :len(r.prompt)] = r.prompt
                    lens[j] = len(r.prompt)
                    slots[j] = free.pop(0)
                    my_slots.append(int(slots[j]))
                    eos[j] = -1 if r.eos_id is None else r.eos_id
                    max_tok[j] = r.max_tokens
                    if self.alloc is not None:
                        self.alloc.ensure(my_slots[j], len(r.prompt))
                        self._slot_budget[my_slots[j]] = \
                            self._block_budget(r)
                    self._slot_poscap[my_slots[j]] = \
                        len(r.prompt) + r.max_tokens
                    # claim the slot now; decode skips it via prefilling
                    self.slot_req[my_slots[j]] = r
                self.scheduler.record_admit(group)
                self._seen("prefill_compute", tokens.shape)
                job = {"group": group, "my_slots": my_slots,
                       "tokens": tokens, "lens": lens, "slots": slots,
                       "eos": eos, "max_tok": max_tok,
                       "ctl": None if self._ctl_dev is None else
                       {k: v.clone() for k, v in self._ctl_dev.items()}}
                for j, r in enumerate(group):
                    self.prefilling.append(
                        {"req": r, "slot": my_slots[j], "pos": 0,
                         "job": job})
                pipe.submit(job)
        # apply finished computes; block for one when nothing else can
        # make progress (no decodable slot) and work is in flight
        mid = {e["slot"] for e in self.prefilling}
        can_decode = any(r is not None and i not in mid
                         for i, r in enumerate(self.slot_req))
        block = not can_decode and pipe.inflight > 0
        for job, out, err in pipe.collect(block=block):
            self.prefilling = [e for e in self.prefilling
                               if e["job"] is not job]
            if err is not None:
                retired.extend(self._fail_job(job, err))
                continue
            (tok, new_cache, hvals), ready = out
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                # the worker's stream made these; the decode stream reads
                # them, so their memory is not reused before it has
                for t in (tok, *new_cache.values(), *hvals.values()):
                    t.record_stream(stream)
            self._sync_tables()
            self._seen("prefill_scatter", job["slots"].shape)
            with obs_trace.get_tracer().span(
                    "serve.prefill_scatter", {"batch": len(job["group"])}):
                payload = self._to_host(self._prefill_scatter(
                    tok, new_cache, hvals, job["slots"], job["eos"],
                    job["max_tok"]))
            t_host = time.perf_counter()
            for j, r in enumerate(job["group"]):
                s = job["my_slots"][j]
                r.t_first_token = t_host
                self.scheduler.emit(r, int(payload[j, 0]))
                if payload[j, 1]:
                    self.slot_req[s] = None
                    self._release_slot(s)
                    retired.append(self.scheduler.retire(r))
                else:
                    self._slot_pos[s] = len(r.prompt)
        return retired

    def _fail_job(self, job: Dict[str, Any],
                  err: BaseException) -> List[Request]:
        """A prefill job that raised on the worker: the live state is
        untouched (the compute reads only parameters and prompt tokens, and
        the scatter never ran). Release the claimed slots and blocks and
        hand each request to :meth:`_retry_or_fail`; returns those that
        retired."""
        self.last_prefill_error = err
        retired: List[Request] = []
        for j in reversed(range(len(job["group"]))):
            r, s = job["group"][j], job["my_slots"][j]
            if self.slot_req[s] is r:
                self.slot_req[s] = None
                self._release_slot(s)
                self._slot_pos[s] = 0
                self._slot_budget[s] = 0
                self._slot_poscap[s] = 0
            t = self._retry_or_fail(r, f"prefill worker crash: {err!r}")
            if t is not None:
                retired.append(t)
        return retired

    def _retry_or_fail(self, req: Request,
                       reason: str) -> Optional[Request]:
        """Within the retry budget the request returns to the QUEUE HEAD
        with its stream reset (it restarts from scratch: emitted tokens are
        withdrawn, so a streaming consumer sees the retry as a new stream);
        past it the request retires with status ``failed`` and ``error``
        set. Returns the retired request, or None when requeued."""
        limit = req.max_retries if req.max_retries > 0 else self.max_retries
        if req.retries < limit:
            req.retries += 1
            req.tokens_out = []
            req.t_first_token = 0.0
            req.t_admit = 0.0
            req.status = "queued"
            self.scheduler.metrics["retried"] += 1
            self.scheduler.waiting.appendleft(req)
            return None
        req.error = reason
        return self.scheduler.retire(req, status="failed")

    def _share_prefix(self, slot: int, m: _PrefixMatch) -> None:
        if m.block_ids:
            self.alloc.share(slot, m.block_ids)
            self.scheduler.metrics["prefix_hits"] += 1
            self.scheduler.metrics["prefix_shared_blocks"] += \
                len(m.block_ids)

    def _attach_full_hit(self, slot: int, req: Request,
                         m: _PrefixMatch) -> None:
        """No prefill at all: idx = L-1, emitted = 0; the next decode tick
        writes position L-1 (forking its shared block first) and emits the
        FIRST token — TTFT stamps there, on the host."""
        self.scheduler.metrics["prefix_full_hits"] += 1
        self._fork_pending[slot] = m.fork_extra
        L = len(req.prompt)
        self._slot_pos[slot] = L - 1
        self._sync_tables()
        self._attach(slot, int(req.prompt[L - 1]), L - 1,
                     -1 if req.eos_id is None else req.eos_id,
                     req.max_tokens)

    def _admit_prefix(self) -> List[Request]:
        """Admission with prefix caching: requests are admitted ONE at a
        time (each admission registers its prompt blocks before the next
        is matched, so a wave of same-prefix arrivals shares within the
        wave). Misses and partial hits prefill their unmatched suffix as a
        single chunk step at ``pos0 = matched``; full hits attach with no
        prefill. The head-of-line budget gate reserves the request's
        lifetime budget MINUS its shared blocks (plus one block for a
        deferred copy-on-write fork)."""
        retired: List[Request] = []
        while True:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free or not self.scheduler.waiting:
                return retired
            head = self.scheduler.waiting[0]
            m = self._match_prefix(head.prompt)
            need = self._block_budget(head) - len(m.block_ids) + m.fork_extra
            if need > self._free_budget():
                return retired
            req = self.scheduler.waiting.popleft()
            retired.extend(self._admit_one(req, free[0], m))

    def _admit_one(self, req: Request, slot: int,
                   m: _PrefixMatch) -> List[Request]:
        L = len(req.prompt)
        self._slot_budget[slot] = self._block_budget(req)
        self._slot_poscap[slot] = L + req.max_tokens
        self._fork_pending[slot] = 0
        self._share_prefix(slot, m)
        self.scheduler.record_admit([req], prefill_batch=False)
        if m.full_hit:
            self.slot_req[slot] = req
            self._attach_full_hit(slot, req, m)
            return []
        # miss (m.m == 0) or partial hit: one chunk step over the suffix,
        # starting at the matched block boundary, right-padded to a power
        # of two
        self.alloc.ensure(slot, L)
        self._sync_tables()
        suffix = np.asarray(req.prompt[m.m:], np.int32)[None, :]
        C = L - m.m
        if C > 1:
            Cp = 1 << (C - 1).bit_length()
            if Cp > C:
                suffix = np.pad(suffix, ((0, 0), (0, Cp - C)))
        eos = -1 if req.eos_id is None else req.eos_id
        payload = self._to_host(self._chunk_step(
            suffix, slot, m.m, C, final=(eos, req.max_tokens)))
        self.scheduler.metrics["prefill_chunks"] += 1
        req.t_first_token = time.perf_counter()
        self._slot_pos[slot] = L
        self.scheduler.emit(req, int(payload[0, 0]))
        if payload[0, 1]:
            self._release_slot(slot)
            return [self.scheduler.retire(req)]
        self.slot_req[slot] = req
        self._register_prefix(slot, req)
        return []

    def _admit_chunked(self) -> List[Request]:
        """Chunked (piggybacked) prefill: waiting prompts claim a slot and
        their lifetime block budget up front, then stream through the
        decode loop ONE fixed-size chunk per tick — a long arrival adds one
        bounded chunk step to each tick instead of a whole-prompt prefill
        stall. The final chunk selects the first token on the device; TTFT
        is stamped only when that token reaches the host. Requests retired
        at the final chunk (EOS / one-token budget) free their slot
        immediately."""
        retired: List[Request] = []
        # claim slots for as many waiting prompts as fit
        while self.scheduler.waiting:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free:
                break
            head = self.scheduler.waiting[0]
            m = self._match_prefix(head.prompt)
            if self.alloc is not None and \
                    self._block_budget(head) - len(m.block_ids) + \
                    m.fork_extra > self._free_budget():
                break
            req = self.scheduler.waiting.popleft()
            slot = free[0]
            if self.alloc is not None:
                # reserve the lifetime budget but allocate lazily, one
                # chunk's worth at a time — queued prompts must not pin
                # pool blocks they won't write for many ticks
                self._slot_budget[slot] = self._block_budget(req)
            self._slot_poscap[slot] = len(req.prompt) + req.max_tokens
            self._fork_pending[slot] = 0
            self.slot_req[slot] = req
            self.scheduler.record_admit([req], prefill_batch=False)
            self._share_prefix(slot, m)
            if m.full_hit:
                self._attach_full_hit(slot, req, m)
            else:
                # chunks resume AFTER the shared prefix (pos0 = m.m)
                self.prefilling.append(
                    {"req": req, "slot": slot, "pos": m.m})
        # late prefix re-match: a request claimed while its prefix donor
        # was still mid-chunk finds the donor's blocks registered by the
        # time its own FIRST chunk runs — match then, not just at claim
        while self.prefilling:
            e = self.prefilling[0]
            req, slot = e["req"], e["slot"]
            if not (self.prefix_cache and e["pos"] == 0
                    and int(self.alloc.n_owned[slot]) == 0):
                break
            m = self._match_prefix(req.prompt)
            self._share_prefix(slot, m)
            if not m.full_hit:
                e["pos"] = m.m
                break
            self._attach_full_hit(slot, req, m)
            self.prefilling.pop(0)
        if not self.prefilling:
            return retired
        # one chunk per tick, FCFS entry first (bounded per-tick latency)
        e = self.prefilling[0]
        req, slot, pos = e["req"], e["slot"], e["pos"]
        C = self.prefill_chunk
        take = min(C, len(req.prompt) - pos)
        last = pos + take >= len(req.prompt)
        toks = np.asarray(req.prompt[pos:pos + take], np.int32)[None, :]
        if self.pad_prefill and take < C:
            # attention families right-pad (masked); the SSM recurrence
            # needs exact-length chunks, one shape a distinct final length
            toks = np.pad(toks, ((0, 0), (0, C - take)))
        if self.alloc is not None:
            self.alloc.ensure(slot, pos + take)   # reserved: cannot fail
        self._sync_tables()
        tr = obs_trace.get_tracer()
        if not last:
            with tr.span("serve.chunk", {"take": take}):
                self._chunk_step(toks, slot, pos, take)
            e["pos"] = pos + take
        else:
            eos = -1 if req.eos_id is None else req.eos_id
            with tr.span("serve.chunk", {"take": take, "last": True}):
                payload = self._to_host(self._chunk_step(
                    toks, slot, pos, take, final=(eos, req.max_tokens)))
            req.t_first_token = time.perf_counter()
            self.prefilling.pop(0)
            self._slot_pos[slot] = len(req.prompt)
            self.scheduler.emit(req, int(payload[0, 0]))
            if payload[0, 1]:
                self.slot_req[slot] = None
                self._release_slot(slot)
                retired.append(self.scheduler.retire(req))
            else:
                self._register_prefix(slot, req)
        self.scheduler.metrics["prefill_chunks"] += 1
        return retired

    def tick(self) -> List[Request]:
        """Admit waiting requests (piggybacking one prefill chunk when
        chunked prefill is on), then decode one token for EVERY active slot
        in a single step with a single device->host transfer — or, with
        ``spec_k``, verify ``k`` drafted tokens per slot in one step.

        Robustness hooks run first: the scheduled chaos faults apply for
        this tick, then queue and decode deadlines retire expired requests,
        so every path out of the engine leaves a terminal status."""
        if self.scheduler.registry is not self._bound_registry:
            self._bind_observability()
        tr = obs_trace.get_tracer()
        t_tick = time.perf_counter()
        if self._injector is not None:
            self._apply_host_faults()
        with tr.span("serve.tick"):
            done = self._expire_deadlines()
            with tr.span("serve.admit"):
                done.extend(self._admit())
            mid_prefill = {e["slot"] for e in self.prefilling}
            decode_slots = [i for i, r in enumerate(self.slot_req)
                            if r is not None and i not in mid_prefill]
            if decode_slots and self.spec_k:
                done.extend(self._spec_tick(decode_slots))
            elif decode_slots:
                done.extend(self._plain_tick(decode_slots))
        self.scheduler.metrics["ticks"] += 1
        self._chaos_tick += 1
        self._h_tick.observe(time.perf_counter() - t_tick)
        return done

    def _apply_host_faults(self) -> None:
        """Evaluate the fault schedule at this engine tick: load the
        channel controls into the device control tensors and apply the
        host sites (block-pool squeeze, prefill-worker crash). The squeeze
        only ever takes blocks from the FREE budget, so blocks reserved for
        admitted requests stay allocatable and the decode and chunk paths'
        ``reserved: cannot fail`` invariants survive any schedule."""
        inj, t = self._injector, self._chaos_tick
        if self._use_fault_ctl:
            self._load_controls(inj.controls(t, self._ctl_n_moduli))
        if self.alloc is not None:
            want = inj.pool_squeeze(t)
            have = len(self.alloc.quarantined)
            if want > have:
                take = min(want - have, max(0, self._free_budget()))
                if take > 0:
                    self.alloc.quarantine(take)
            elif want < have:
                self.alloc.unquarantine(
                    sorted(self.alloc.quarantined)[:have - want])
        if self._pipe is not None and inj.worker_crash(t):
            self._pipe.crash_next = True

    def _expire_deadlines(self) -> List[Request]:
        """Retire queued requests past their queue or total TTL and abort
        active slots past their total TTL (terminal status ``timed_out``:
        deadlines are final, never retried). Slots mid-PIPELINED-prefill
        are skipped until their scatter lands (the worker's job still
        holds them); they expire on the next tick."""
        now = time.perf_counter()
        done: List[Request] = list(self.scheduler.expire_queued(now))
        pipe_mid = {e["slot"] for e in self.prefilling} \
            if self._pipe is not None else set()
        for i, req in enumerate(self.slot_req):
            if req is None or i in pipe_mid:
                continue
            if req.deadline(now):
                req.error = "deadline exceeded mid-flight"
                self._abort_slot(i)
                done.append(self.scheduler.retire(req, status="timed_out"))
        return done

    @torch.inference_mode()
    def _abort_slot(self, slot: int) -> None:
        """Tear a live slot down outside the normal retirement path
        (deadline or fault abort): drop the host bookkeeping, release its
        blocks, and clear its device active bit in place, so the next tick
        freezes the slot instead of emitting for it."""
        self.slot_req[slot] = None
        self.prefilling = [e for e in self.prefilling if e["slot"] != slot]
        self._release_slot(slot)
        self._slot_pos[slot] = 0
        self._slot_budget[slot] = 0
        self._slot_poscap[slot] = 0
        self.state["active"][slot] = False

    def _corrupt(self, payload: np.ndarray, cols) -> np.ndarray:
        """The host payload after the chaos site ``host_corruption`` (a
        copy; unchanged without an injector)."""
        if self._injector is None:
            return payload
        payload = payload.copy()
        payload[:, cols] = self._injector.corrupt_tokens(
            self._chaos_tick, payload[:, cols], self.model.cfg.vocab_size)
        return payload

    def _plain_tick(self, decode_slots: List[int]) -> List[Request]:
        if self.alloc is not None:
            cap_pos = self.alloc.max_blocks_per_slot * self.block_size
            for i in decode_slots:
                # this tick writes each slot's token at position
                # _slot_pos[i]: fork/unindex a shared block there, then grow
                # the table on block boundaries (reserved at admission —
                # cannot exhaust; writes past the linear capacity drop on
                # the device, hence the clamp)
                self._cow_guard(i, self._slot_pos[i], self._slot_pos[i] + 1)
                self.alloc.ensure(i, min(self._slot_pos[i] + 1, cap_pos))
            self._sync_tables()
        tr = obs_trace.get_tracer()
        self._tick_count += 1
        with tr.span("serve.decode", {"slots": len(decode_slots)}):
            payload = self._tick_step("decode_tick", self._decode_tick)
        with tr.span("serve.host_sync"):
            payload = self._to_host(payload)      # the ONE transfer
        self.scheduler.metrics["decode_steps"] += 1
        vocab = self.model.cfg.vocab_size
        payload = self._corrupt(payload, 0)
        t_host = time.perf_counter()
        done: List[Request] = []
        for i, (tok, is_done) in enumerate(payload):
            req = self.slot_req[i]
            if req is None or tok < 0:
                continue
            if tok >= vocab:
                # an out-of-vocab token is a corrupted device->host
                # transfer: the stream can no longer be trusted, so abort
                # the slot and retry the request from scratch (bounded)
                self._abort_slot(i)
                t = self._retry_or_fail(req, "corrupted host transfer")
                if t is not None:
                    done.append(t)
                continue
            self._slot_pos[i] += 1
            if req.t_first_token == 0.0:
                # full-prefix-hit admissions skip prefill entirely — their
                # FIRST token is this tick's, so TTFT stamps at its host
                # materialization, not at admission
                req.t_first_token = t_host
            self.scheduler.emit(req, int(tok))
            if is_done:
                self.slot_req[i] = None
                self._release_slot(i)
                done.append(self.scheduler.retire(req))
            else:
                self._maybe_trim(i)
        return done

    def _spec_tick(self, decode_slots: List[int]) -> List[Request]:
        """One speculative tick: host-side prompt-lookup drafts for every
        decoding slot, ONE verify step over all ``k+1`` positions,
        leading-ones acceptance on the device (token-identical to greedy
        decode). Still exactly one device->host transfer per tick — now
        ``(S, k+2)``."""
        k = self.spec_k
        drafts = np.zeros((self.n_slots, k), np.int32)
        for i in decode_slots:
            req = self.slot_req[i]
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.tokens_out, np.int32)])
            drafts[i] = _lookup_draft(ctx, k)
        if self.alloc is not None:
            cap_pos = self.alloc.max_blocks_per_slot * self.block_size
            for i in decode_slots:
                p0 = self._slot_pos[i]
                # the verify writes positions [p0, p0+k]: fork/unindex
                # shared blocks in that range, then map blocks up to the
                # request's own position cap — accepted tokens always fit
                # under it (the budget mask caps acceptance first), so
                # drafted positions past it may drop on the device, never
                # KV the request will read
                self._cow_guard(i, p0, p0 + k + 1)
                self.alloc.ensure(i, min(
                    p0 + 1 + k, max(self._slot_poscap[i], p0 + 1), cap_pos))
            self._sync_tables()
        self._drafts.copy_(torch.from_numpy(drafts))
        tr = obs_trace.get_tracer()
        self._tick_count += 1
        with tr.span("serve.verify", {"slots": len(decode_slots), "k": k}):
            payload = self._tick_step("verify_tick", self._verify_tick)
        with tr.span("serve.host_sync"):
            payload = self._to_host(payload)      # the ONE transfer
        vocab = self.model.cfg.vocab_size
        payload = self._corrupt(payload, slice(0, k + 1))
        t_host = time.perf_counter()
        done: List[Request] = []
        self.scheduler.metrics["spec_ticks"] += 1
        for i in decode_slots:
            req = self.slot_req[i]
            if np.any(payload[i, :k + 1] >= vocab):
                # a corrupted transfer (see _plain_tick): abort and retry
                self._abort_slot(i)
                t = self._retry_or_fail(req, "corrupted host transfer")
                if t is not None:
                    done.append(t)
                continue
            is_done = payload[i, k + 1]
            n_acc = 0
            for t in payload[i, :k + 1]:
                if t < 0:
                    break
                n_acc += 1
                self._slot_pos[i] += 1
                if req.t_first_token == 0.0:
                    req.t_first_token = t_host
                self.scheduler.emit(req, int(t))
            self.scheduler.metrics["spec_slot_ticks"] += 1
            self.scheduler.metrics["spec_accepted"] += n_acc
            if is_done:
                self.slot_req[i] = None
                self._release_slot(i)
                done.append(self.scheduler.retire(req))
            else:
                self._maybe_trim(i)
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_ticks):
            if not self.scheduler.waiting and \
                    all(r is None for r in self.slot_req):
                break
            finished.extend(self.tick())
        return finished

    def drain(self, max_ticks: int = 10_000) -> List[Request]:
        """Graceful drain: stop admitting NEW work (``submit`` raises
        :class:`AdmissionRejected` while draining) but run every queued
        and in-flight request to a terminal status."""
        self._draining = True
        try:
            return self.run_until_drained(max_ticks)
        finally:
            self._draining = False

    def shutdown(self, max_ticks: int = 10_000) -> List[Request]:
        """Teardown: reject everything still WAITING (terminal status
        ``rejected``), drain the in-flight slots to completion, stop the
        pipeline worker. Returns every request retired here; the engine
        admits nothing afterwards."""
        self._draining = True
        out: List[Request] = []
        while self.scheduler.waiting:
            r = self.scheduler.waiting.popleft()
            r.error = "server shutting down"
            out.append(self.scheduler.retire(r, status="rejected"))
        out.extend(self.run_until_drained(max_ticks))
        self.close()
        return out

    # ------------------------------------------------------------------
    # warmup, CUDA graphs
    # ------------------------------------------------------------------

    def compile_counts(self) -> Dict[str, int]:
        """Shapes each step has run or been captured at (the JAX engine's
        jit-cache sizes, under the same keys): snapshot after
        :meth:`warmup`, drain traffic, snapshot again; equal dicts mean
        the drain ran only warmed shapes."""
        names = ["decode_tick", "prefill_insert", "prefill_compute",
                 "prefill_scatter"]
        if self.prefill_chunk is not None or self.prefix_cache:
            names += ["chunk_mid", "chunk_last"]
        if self.prefix_cache:
            names.append("attach")
        if self.spec_k:
            names.append("verify_tick")
        return {n: len(self._shapes[n]) for n in names}

    def warmup(self) -> Dict[str, float]:
        """Run every serving shape once before traffic, then, on the card,
        capture the tick as a CUDA graph that every later tick replays.

        Against the idle state: every (bucket, batch) prefill shape with
        out-of-bounds slot ids (every row drops), the decode tick (and the
        verify tick under ``spec_k``) on the all-inactive state (the active
        mask freezes every slot; garbage KV lands where admission
        overwrites it), the chunk shapes of ``prefill_chunk`` and the
        prefix cache's padded suffixes, and the prefix cache's attach, on
        slot 0. The control leaves, ``idx``, the SSM family's recurrent
        state and the health accumulators are saved before and restored
        after, which is why warmup requires an IDLE engine. The SSM
        family's exact-length prefill is warmed at the bucket lengths
        only, as in the JAX engine: other prompt lengths first run on
        arrival. Its noise and sampling come from warmup generators
        of its own: the real ones are left where they were, so a warmed
        engine emits the exact token streams of a cold one, including
        under per-tick analog noise.

        On the card the tick that the engine runs (the verify tick under
        ``spec_k``, else the decode tick) is then captured with the real
        generators registered on the graph, so each replay draws the
        numbers the eager tick would. A capture that fails raises.
        :meth:`resize_slots`, :meth:`resize_block_pool` and
        :meth:`switch_backend` drop the graph; the engine then ticks
        eagerly, with the same streams, until the next ``warmup()``.

        Records ``serve_warmup_seconds`` / ``serve_warmup_compiled`` gauges
        and returns ``{"seconds", "compiled", "graphs"}``."""
        if self.scheduler.waiting or self.prefilling or \
                any(r is not None for r in self.slot_req):
            raise RuntimeError(
                "warmup requires an idle engine — run it before traffic")
        t0 = time.perf_counter()
        before = sum(self.compile_counts().values())
        self._graphs.clear()
        on_card = self.device.type == "cuda"
        if on_card and self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        saved = self._save_leaves()
        real = (self._noise_gens, self._sample_gens, self._burst_gens)
        self._noise_gens, self._sample_gens, self._burst_gens = (
            {s: seeded_generator(self.device, "warmup", kind, s)
             for s in _STREAMS} for kind in ("noise", "sample", "burst"))
        if self._use_fault_ctl:
            # warm (and capture) with identity controls, as the JAX engine
            # warms its fault-wrapped steps; the next tick loads its own
            for k, v in analog_channel.identity_fault_controls(
                    self._ctl_n_moduli).items():
                self._ctl_dev[k].copy_(v)
            self._ctl_loaded = None
        try:
            self._warm_prefill_and_chunks()
            # the tick steps on the stream that captures them, so whatever
            # a library sets up per stream exists before the capture
            with self._on_capture_stream():
                self._warm_ticks()
        finally:
            self._noise_gens, self._sample_gens, self._burst_gens = real
            self._restore_leaves(saved)
        if on_card:
            if self.spec_k:
                self._capture("verify_tick", self._verify_tick)
            else:
                self._capture("decode_tick", self._decode_tick)
        dt = time.perf_counter() - t0
        compiled = sum(self.compile_counts().values()) - before
        reg = self.scheduler.registry
        reg.gauge("serve_warmup_seconds",
                  help="warmup walltime (every serving shape run once, "
                       "the tick captured on the card)").set(dt)
        reg.gauge("serve_warmup_compiled",
                  help="step shapes first run by warmup").set(compiled)
        return {"seconds": dt, "compiled": float(compiled),
                "graphs": float(len(self._graphs))}

    @contextlib.contextmanager
    def _on_capture_stream(self):
        if self._capture_stream is None:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self._capture_stream.wait_stream(cur)
        with torch.cuda.stream(self._capture_stream):
            yield
        cur.wait_stream(self._capture_stream)

    def _save_leaves(self) -> Dict[str, Any]:
        """Copies of the leaves warmup's steps write outside the KV: the
        control leaves, ``idx``, the SSM family's recurrent state (a warm
        chunk writes slot 0's) and the health accumulators."""
        st = self.state
        out = {k: v.clone() for k, v in st.items()
               if k not in ("cache", "health")}
        out["cache"] = {k: st["cache"][k].clone()
                        for k in ("idx", "ssm", "conv") if k in st["cache"]}
        if "health" in st:
            out["health"] = {k: v.clone() for k, v in st["health"].items()}
        return out

    @torch.inference_mode()
    def _restore_leaves(self, saved: Dict[str, Any]) -> None:
        """Write :meth:`_save_leaves`' copies back, in place."""
        st = self.state
        for k, v in saved.items():
            if k == "cache":
                for c, cv in v.items():
                    st["cache"][c].copy_(cv)
            elif k == "health":
                for h, hv in v.items():
                    st["health"][h].copy_(hv)
            else:
                st[k].copy_(v)

    def _warm_prefill_and_chunks(self) -> None:
        # every (bucket, batch) prefill shape admission can produce:
        # batches pad to powers of two up to the first pow2 >= n_slots
        batches, b = [], 1
        while b < self.n_slots:
            batches.append(b)
            b <<= 1
        batches.append(b)
        for Lb in self.buckets:
            for B in batches:
                args = (np.zeros((B, Lb), np.int32), np.ones((B,), np.int32))
                rest = (np.full((B,), self.n_slots, np.int64),
                        np.full((B,), -1, np.int32), np.ones((B,), np.int32))
                if self._pipe is not None:
                    self._seen("prefill_compute", args[0].shape)
                    self._seen("prefill_scatter", rest[0].shape)
                    self._prefill_scatter(*self._prefill_compute(*args),
                                          *rest)
                else:
                    self._prefill_insert(*args, *rest)
        sizes = set()
        if self.prefill_chunk is not None:
            sizes.add(self.prefill_chunk)
        if self.prefix_cache:
            # _admit_one pads the unmatched suffix to a power of two
            c = 1
            while c < self.buckets[-1]:
                sizes.add(c)
                c <<= 1
            sizes.add(c)
        for C in sorted(sizes):
            toks = np.zeros((1, C), np.int32)
            if C == self.prefill_chunk:
                self._chunk_step(toks, 0, 0, C)
            self._chunk_step(toks, 0, 0, C, final=(-1, 1))
        if self.prefix_cache:
            self._attach(0, 0, 0, -1, 1)

    def _warm_ticks(self) -> None:
        self._seen("decode_tick", self.n_slots)
        self._decode_tick()
        if self.spec_k:
            self._seen("verify_tick", self.n_slots)
            self._verify_tick()

    def _capture(self, name: str, step: Callable[[], torch.Tensor]) -> None:
        """Capture ``step`` as a CUDA graph on the capture stream, with the
        decode stream's noise and sampling generators (and, under channel
        faults, its burst generator) registered, so a replay advances them
        as the eager step does; the captured step reads the fault controls
        from ``_ctl_dev``. The capture
        launches nothing, so the launch counts it adds are taken back and
        kept as the graph's per-replay counts; the generators' states are
        restored."""
        gens = (self._noise_gens["decode"], self._sample_gens["decode"]) + \
            ((self._burst_gens["decode"],) if self._use_fault_ctl else ())
        states = [g.get_state() for g in gens]
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        before = dict(ops.LAUNCHES)
        try:
            with torch.cuda.graph(graph, stream=self._capture_stream):
                payload = step()
        finally:
            launches = {k: v - before[k] for k, v in ops.LAUNCHES.items()
                        if v != before[k]}
            ops.add_launch_counts({k: -v for k, v in launches.items()})
            for g, st in zip(gens, states):
                g.set_state(st)
        self._graphs[name] = _StepGraph(graph, payload, launches)

    def close(self) -> None:
        """Stop the prefill pipeline's worker thread (idempotent; the
        engine itself needs no teardown)."""
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None

    # ------------------------------------------------------------------
    # elastic resize
    # ------------------------------------------------------------------

    def resize_slots(self, new_slots: int) -> None:
        """Elastic slot-count change mid-flight (scale with offered load).
        Active slots are compacted to the front of the new stacked cache;
        under the paged layout the page POOL is untouched (block ids are
        stable), only the table rows and allocator bookkeeping move. Drops
        the captured graphs (see :meth:`warmup`)."""
        from repro_torch.runtime.elastic import resize_serving_state
        if self.prefilling:
            raise RuntimeError(
                "cannot resize slots while a prefill is in flight")
        keep = [i for i, r in enumerate(self.slot_req) if r is not None]
        if len(keep) > new_slots:
            raise ValueError(
                f"cannot shrink to {new_slots} slots with {len(keep)} active")
        self._graphs.clear()
        with torch.inference_mode():
            self.state = resize_serving_state(self.model, self.state,
                                              self.cap, new_slots, keep)
        if self.alloc is not None:
            freed = self.alloc.remap_slots(keep, new_slots)
            if freed and self.prefix_index is not None:
                self.prefix_index.evict_blocks(freed)
            self._sync_tables()
        pad = new_slots - len(keep)
        self.slot_req = [self.slot_req[i] for i in keep] + [None] * pad
        self._slot_pos = [self._slot_pos[i] for i in keep] + [0] * pad
        self._slot_budget = [self._slot_budget[i] for i in keep] + [0] * pad
        self._slot_poscap = [self._slot_poscap[i] for i in keep] + [0] * pad
        self._fork_pending = [self._fork_pending[i] for i in keep] + \
            [0] * pad
        self.n_slots = new_slots
        self._drafts = self._init_drafts(new_slots)

    def resize_block_pool(self, new_n_blocks: int) -> None:
        """Elastic block-pool resize (grow under admission pressure, shrink
        after a long-context burst retires). Live blocks are compacted to
        the front of the new pool, the pages move with them, and every
        block table is rewritten: live requests keep decoding their exact
        continuations. Raises ``ValueError`` when the live blocks do not
        fit. Drops the captured graphs (see :meth:`warmup`)."""
        if self.alloc is None:
            raise RuntimeError(
                "block pool resize requires cache_layout='paged'")
        from repro_torch.runtime.elastic import resize_block_pool
        with torch.inference_mode():
            state, old_ids, new_ids = resize_block_pool(
                self.state, self.alloc, new_n_blocks)
        self._graphs.clear()
        self.state = state
        if self.prefix_index is not None:
            self.prefix_index.remap(
                {int(o): int(n) for o, n in zip(old_ids, new_ids)})

    # ------------------------------------------------------------------
    # crash-consistent snapshots
    # ------------------------------------------------------------------

    _SNAP_VERSION = 1

    @staticmethod
    def _req_to_dict(r: Request) -> Dict[str, Any]:
        return {"rid": r.rid, "prompt": np.asarray(r.prompt, np.int32),
                "max_tokens": int(r.max_tokens), "eos_id": r.eos_id,
                "tokens_out": list(r.tokens_out),
                "t_enqueue": r.t_enqueue, "t_admit": r.t_admit,
                "t_first_token": r.t_first_token, "t_done": r.t_done,
                "status": r.status, "ttl_s": r.ttl_s,
                "queue_ttl_s": r.queue_ttl_s,
                "max_retries": int(r.max_retries),
                "retries": int(r.retries), "error": r.error}

    def _generators(self) -> Dict[str, Dict[str, torch.Generator]]:
        return {"noise": self._noise_gens, "burst": self._burst_gens,
                "sample": self._sample_gens}

    def snapshot(self) -> Dict[str, Any]:
        """Crash-consistent engine snapshot: ONE picklable host tree
        holding the device state (as CPU tensors), the allocator tables,
        the prefix index, the request queues, the states of the engine's
        noise, burst and sampling generators (those a captured tick
        advances included: a replay moves its registered generators'
        states) and its clocks. Restoring it, into this engine or an
        identically configured one in a fresh process, resumes
        token-identical streams, per-tick analog noise included. Requires
        a quiescent prefill pipeline (in-flight worker compute is thread
        state that cannot be captured consistently): tick until no prefill
        is in flight first."""
        if self._pipe is not None and self._pipe.inflight:
            raise RuntimeError(
                "snapshot requires a quiescent prefill pipeline (tick "
                "until no prefill is in flight)")
        live: Dict[int, Request] = {}
        for r in list(self.scheduler.waiting) + \
                [e["req"] for e in self.prefilling] + \
                [x for x in self.slot_req if x is not None]:
            live[r.rid] = r
        return {
            "version": self._SNAP_VERSION,
            "n_slots": self.n_slots,
            "state": _tree_map(lambda t: t.detach().to("cpu", copy=True),
                               self.state),
            "alloc": copy.deepcopy(self.alloc.__dict__)
            if self.alloc is not None else None,
            "prefix": copy.deepcopy(self.prefix_index.__dict__)
            if self.prefix_index is not None else None,
            "requests": {rid: self._req_to_dict(r)
                         for rid, r in live.items()},
            "waiting": [r.rid for r in self.scheduler.waiting],
            "slot_req": [r.rid if r is not None else None
                         for r in self.slot_req],
            "prefilling": [{"rid": e["req"].rid, "slot": e["slot"],
                            "pos": e["pos"]} for e in self.prefilling],
            "slot_pos": list(self._slot_pos),
            "slot_budget": list(self._slot_budget),
            "slot_poscap": list(self._slot_poscap),
            "fork_pending": list(self._fork_pending),
            "counters": {"tick": self._tick_count,
                         "chaos": self._chaos_tick},
            "generators": {kind: {s: g.get_state() for s, g in gens.items()}
                           for kind, gens in self._generators().items()},
            "metrics": {k: int(v)
                        for k, v in self.scheduler.metrics.items()
                        if k != "prefilling"},
            "finished_rids": [r.rid for r in self.scheduler.finished],
        }

    def restore(self, snap: Dict[str, Any],
                requests: Optional[Dict[int, Request]] = None) -> None:
        """Load a :meth:`snapshot` back into this engine (same model,
        policy and layout). The device state is written in place where its
        tensors match the snapshot's (a captured tick keeps reading them);
        otherwise they are replaced and the graphs dropped. ``requests``
        optionally maps rid -> live ``Request`` objects to update in place
        (the guardian's rollback, which keeps object identity); without
        it, requests are rebuilt from the snapshot (the fresh-process
        recovery path; requests already finished at snapshot time are not
        rebuilt: their streams were delivered before the crash)."""
        if snap.get("version") != self._SNAP_VERSION:
            raise ValueError(f"snapshot version {snap.get('version')!r} != "
                             f"engine version {self._SNAP_VERSION}")
        if snap["n_slots"] != self.n_slots:
            raise ValueError(f"snapshot has {snap['n_slots']} slots, "
                             f"engine has {self.n_slots}")
        if self._pipe is not None and self._pipe.inflight:
            raise RuntimeError("cannot restore over in-flight prefills")
        with torch.inference_mode():
            if not _load_tree(self.state, snap["state"]):
                self._graphs.clear()
                self.state = _tree_map(
                    lambda t: t.to(self.device, copy=True), snap["state"])
        if self.alloc is not None and snap["alloc"] is not None:
            self.alloc.__dict__.clear()
            self.alloc.__dict__.update(copy.deepcopy(snap["alloc"]))
            self.alloc.dirty = True
            self._sync_tables()
        if self.prefix_index is not None and snap["prefix"] is not None:
            self.prefix_index.__dict__.clear()
            self.prefix_index.__dict__.update(copy.deepcopy(snap["prefix"]))
        pool: Dict[int, Request] = {
            r.rid: r for r in self.scheduler.finished}
        for r in list(self.scheduler.waiting) + \
                [x for x in self.slot_req if x is not None] + \
                [e["req"] for e in self.prefilling]:
            pool[r.rid] = r
        if requests:
            pool.update(requests)

        def revive(rid: int) -> Request:
            d = snap["requests"][rid]
            r = pool.get(rid)
            if r is None:
                r = Request(rid=d["rid"],
                            prompt=np.asarray(d["prompt"], np.int32),
                            max_tokens=d["max_tokens"], eos_id=d["eos_id"])
                pool[rid] = r
            for k in ("t_enqueue", "t_admit", "t_first_token", "t_done",
                      "status", "ttl_s", "queue_ttl_s", "max_retries",
                      "retries", "error"):
                setattr(r, k, d[k])
            r.tokens_out = list(d["tokens_out"])
            return r

        self.scheduler.waiting = collections.deque(
            revive(rid) for rid in snap["waiting"])
        self.slot_req = [revive(rid) if rid is not None else None
                         for rid in snap["slot_req"]]
        self.prefilling = [{"req": revive(e["rid"]), "slot": e["slot"],
                            "pos": e["pos"]} for e in snap["prefilling"]]
        self._slot_pos = list(snap["slot_pos"])
        self._slot_budget = list(snap["slot_budget"])
        self._slot_poscap = list(snap["slot_poscap"])
        self._fork_pending = list(snap["fork_pending"])
        self._tick_count = snap["counters"]["tick"]
        self._chaos_tick = snap["counters"]["chaos"]
        for kind, gens in self._generators().items():
            for stream, st in snap["generators"][kind].items():
                gens[stream].set_state(st)
        for k, v in snap["metrics"].items():
            self.scheduler.metrics[k] = v
        self.scheduler.finished = [
            pool[rid] for rid in snap["finished_rids"] if rid in pool]

    # ------------------------------------------------------------------
    # backend switch
    # ------------------------------------------------------------------

    def switch_backend(self, new_policy) -> None:
        """Reprogram the engine's numeric backend mid-flight (the
        SNR-adaptive degradation path of the JAX package's resilience
        controller): set ``new_policy`` on the model (which owns its
        parameters and reads its policy at call time), re-encode the
        stationary residues from the raw weights under it or clear them
        (residue coding is policy-specific; an engine built with
        ``stationary_weights=None`` follows the new backend's capability),
        swap the health accumulators to the new policy's spec, reseed the
        noise generators from its ``noise_seed``, decide afresh whether
        the steps run under the channel fault controls (the fp32 fallback
        has no channel), and drop the captured graphs (see
        :meth:`warmup`). In-flight KV is plain numeric state, not
        policy-coded: live streams continue under the new backend from
        their current positions."""
        if self._pipe is not None and self._pipe.inflight:
            raise RuntimeError(
                "cannot switch backends with pipelined prefills in flight")
        lm_helpers.check_policy(self.model.cfg, new_policy)  # before any change
        backend = backends.resolve(new_policy)
        self._graphs.clear()
        self.model.policy = new_policy
        if self._stationary_auto:
            self.stationary_weights = self._auto_stationary(backend)
        stationary.install(self.model, None)   # free the old residues first
        if self.stationary_weights and backend.supports_stationary_residues:
            stationary.install(self.model, stationary.encode_stationary_params(
                self.model, new_policy))
        self._set_health_spec(new_policy)
        self.state.pop("health", None)
        if self._health_spec:
            self.state["health"] = obs_health.init(self._health_spec,
                                                   self.device)
        self._reseed_noise(new_policy)
        self._compute_fault_ctl()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def _bind_observability(self) -> None:
        """Attach the engine's gauges and tick histogram to the CURRENT
        scheduler's registry; re-run lazily whenever ``self.scheduler`` is
        swapped for a fresh one."""
        reg = self.scheduler.registry
        self._bound_registry = reg
        m = self.scheduler.metrics
        m.bind_prefilling(lambda: len(self.prefilling))
        reg.gauge_fn("serve_prefilling", lambda: len(self.prefilling),
                     help="requests admitted but still streaming their "
                          "prompt (chunked prefill in flight)")
        reg.gauge_fn("serve_slots_active",
                     lambda: sum(r is not None for r in self.slot_req),
                     help="slots holding a live request")
        reg.gauge_fn("serve_prefix_hit_rate",
                     lambda: (m["prefix_hits"] / m["admitted"])
                     if m["admitted"] else 0.0,
                     help="fraction of admissions that mapped shared "
                          "prefix blocks")
        reg.gauge_fn("serve_spec_accept_per_slot_tick",
                     lambda: (m["spec_accepted"] / m["spec_slot_ticks"])
                     if m["spec_slot_ticks"] else 0.0,
                     help="mean draft tokens accepted per per-slot "
                          "verify step")
        self._h_tick = reg.histogram(
            "serve_tick_seconds", help="engine tick walltime (admit + "
                                       "decode/verify + host sync)")
        if self._health_spec:
            reg.add_collector(self._collect_health)
        if self.alloc is None:
            return
        alloc = self.alloc
        reg.gauge_fn("serve_block_pool_in_use", lambda: alloc.used_count,
                     help="page-pool blocks with refcount > 0")
        reg.gauge_fn("serve_block_pool_occupancy", lambda: alloc.occupancy,
                     help="in-use fraction of the page pool")
        reg.gauge_fn("serve_block_pool_fragmentation",
                     lambda: alloc.fragmentation,
                     help="free holes inside the live block region as a "
                          "fraction of that region (0 = compact)")
        reg.gauge_fn("serve_block_local_allocs", lambda: alloc.local_allocs,
                     help="block allocations on the owning slot's home "
                          "data-shard")
        reg.gauge_fn("serve_block_spilled_allocs",
                     lambda: alloc.spilled_allocs,
                     help="block allocations that fell to a remote shard "
                          "(home free list was dry)")
        reg.gauge_fn("serve_block_remote_fraction",
                     lambda: alloc.remote_fraction(),
                     help="fraction of live table references whose block "
                          "lives off the slot's shard")

        def _collect_shard_depth(r, _alloc=alloc):
            g = r.gauge("serve_block_free_per_shard",
                        help="free-list depth per data shard of the page "
                             "pool", label_names=("shard",))
            for k, v in enumerate(_alloc.free_by_shard()):
                g.labels(str(k)).set(v)

        reg.add_collector(_collect_shard_depth)

    def _collect_health(self, reg) -> None:
        """The analog-health counters as ``serve_health_<name>`` gauges (a
        ``channel`` label per modulus), one transfer a scrape."""
        for name, val in self.health_snapshot().items():
            if isinstance(val, list):
                g = reg.gauge(f"serve_health_{name}",
                              help="per-channel analog fault counter",
                              label_names=("channel",))
                for mod, v in zip(self._health_moduli, val):
                    g.labels(str(mod)).set(v)
            else:
                reg.gauge(f"serve_health_{name}",
                          help="analog fault counter").set(val)

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
        if self.scheduler.registry is not self._bound_registry:
            self._bind_observability()
        return self.scheduler.metrics


class PerSlotLMServer:
    """The slot-at-a-time decode loop, kept ONLY as the parity oracle of
    the batched engine (token for token under greedy decode). Each tick
    runs one batch-1 decode and one host sync per active slot. Like the
    JAX oracle, which runs the raw params, it clears any stationary
    encodings a batched engine installed on the model."""

    def __init__(self, model, cap: int, batch_slots: int = 8,
                 greedy: bool = True):
        self.model = model
        self.cap = cap
        self.greedy = greedy
        self.device = model.device
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.waiting: collections.deque[Request] = collections.deque()
        self._caches: List[Any] = [None] * batch_slots
        self.metrics = {"completed": 0, "tokens": 0, "ticks": 0}
        stationary.install(model, None)

    def submit(self, req: Request):
        req.t_enqueue = time.perf_counter()
        self.waiting.append(req)

    @torch.inference_mode()
    def _admit(self):
        done = []
        for i in range(len(self.slots)):
            while self.slots[i] is None and self.waiting:
                req = self.waiting.popleft()
                req.t_admit = time.perf_counter()
                logits, cache = self.model.prefill(
                    torch.from_numpy(np.asarray(req.prompt, np.int32)
                                     )[None].to(self.device), self.cap)
                tok = int(torch.argmax(logits[0, -1]))  # to the host
                req.t_first_token = time.perf_counter()
                req.tokens_out.append(tok)
                if (req.eos_id is not None and tok == req.eos_id) or \
                        req.max_tokens <= 1:
                    # retired at admission; the slot stays free
                    req.t_done = time.perf_counter()
                    self.metrics["completed"] += 1
                    self.metrics["tokens"] += len(req.tokens_out)
                    done.append(req)
                    continue
                self.slots[i] = req
                self._caches[i] = cache
        return done

    def _retire(self, i: int):
        req = self.slots[i]
        req.t_done = time.perf_counter()
        self.metrics["completed"] += 1
        self.metrics["tokens"] += len(req.tokens_out)
        self.slots[i] = None
        self._caches[i] = None
        return req

    @torch.inference_mode()
    def tick(self) -> List[Request]:
        """Admit waiting requests, decode one token for each active slot."""
        done = list(self._admit())
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            last = torch.tensor([[req.tokens_out[-1]]], dtype=torch.int32,
                                device=self.device)
            logits, self._caches[i] = self.model.decode_step(
                self._caches[i], last)
            tok = int(torch.argmax(logits[0, -1]))
            req.tokens_out.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.tokens_out) >= req.max_tokens:
                done.append(self._retire(i))
        self.metrics["ticks"] += 1
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        finished = []
        for _ in range(max_ticks):
            if not self.waiting and all(s is None for s in self.slots):
                break
            finished.extend(self.tick())
        return finished
