"""Preemption handling, straggler monitoring and the fault-tolerant training
loop on one device (port of the single-device part of
``repro.runtime.elastic``).

The scheduler preempts with SIGTERM: :class:`PreemptionGuard` turns it into
a flag, and :func:`fault_tolerant_train_loop` checkpoints at the next step
boundary and stops, with the data pipeline's state in the checkpoint's
metadata, so a resumed run continues on exactly the batch the stopped one
would have taken next. :func:`resize_serving_state` and
:func:`resize_block_pool` change a serving engine's slot count and page
pool mid-flight (``LMServer.resize_slots`` / ``resize_block_pool``).
:func:`elastic_restore` restores a checkpoint onto TODAY's mesh, whatever
mesh (or single device) wrote it: leaves are stored whole, and each rank
cuts its shards of them.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.interop import to_jax_train_state
from repro_torch.obs import trace as obs_trace


class PreemptionGuard:
    """SIGTERM/SIGINT -> set a flag; the train loop checkpoints and exits
    cleanly at the next step boundary instead of dying mid-write."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._orig = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._orig[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # not the main thread (tests)

    def _handler(self, signum, frame):
        self.preempted = True

    def uninstall(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)
        self._orig = {}


@dataclasses.dataclass
class ElasticConfig:
    min_devices: int = 1
    reshard_on_restore: bool = True


def resize_serving_state(model, state: Dict, cap: int, new_slots: int,
                         keep: Optional[Sequence[int]] = None) -> Dict:
    """Rebuild a continuous-batching serving state with a different slot
    count (elastic up/down scale with offered load).

    ``state`` is the :class:`repro_torch.runtime.server.LMServer` state
    ({"cache": stacked cache, per-slot vectors...}). Slots listed in
    ``keep`` are compacted to the front of the new state; everything else
    starts empty (inactive). The caller remaps its host-side slot
    bookkeeping (and, for the paged layout, the block allocator via
    ``BlockAllocator.remap_slots``) to ``range(len(keep))``.

    Dense caches (the SSM family's ``ssm``/``conv`` state among them, a
    kept slot's row gathered) move through the ``models.lm``
    gather/scatter helpers;
    paged caches (the hybrid family's shared-KV pools among them) keep
    their page POOLS (the same tensors: block ids are
    stable under slot compaction) and only gather the per-slot leaves,
    ``idx`` and the ``bt`` table rows. ``"health"``, the engine's
    pool-wide accumulators, carries over unchanged. Every other leaf is a
    new tensor."""
    from repro_torch.models import lm as lm_helpers

    keep = list(keep or [])
    if len(keep) > new_slots:
        raise ValueError(f"{len(keep)} live slots do not fit in {new_slots}")
    cache = state["cache"]
    paged = "bt" in cache
    pool = cache[lm_helpers.pool_keys(cache)[0]] if paged else None
    spec = model.cache_spec(
        new_slots, cap, per_slot_idx=True,
        **(dict(layout="paged", block_size=pool.shape[2],
                n_blocks=pool.shape[1]) if paged else {}))
    new_cache = {}
    for k, (shape, dtype) in spec.items():
        if k in lm_helpers.PAGE_POOL_LEAVES:
            new_cache[k] = cache[k]
        else:
            new_cache[k] = torch.zeros(shape, dtype=dtype,
                                       device=cache["idx"].device)
    if paged:
        new_cache["bt"].fill_(pool.shape[1])   # the sentinel
    new_state = {"cache": new_cache}
    if "health" in state:
        new_state["health"] = state["health"]
    for k, v in state.items():
        if k not in ("cache", "health"):
            new_state[k] = torch.zeros((new_slots,) + tuple(v.shape[1:]),
                                       dtype=v.dtype, device=v.device)
    if keep:
        dev = cache["idx"].device
        dst = torch.arange(len(keep), device=dev)
        src = torch.as_tensor(keep, dtype=torch.long, device=dev)
        if paged:
            for k, v in new_cache.items():
                if k in lm_helpers.PAGE_POOL_LEAVES:
                    continue
                if lm_helpers.cache_slot_axis(k) == 0:
                    v[dst] = cache[k][src]
                else:
                    v[:, dst] = cache[k][:, src]
        else:
            lm_helpers.cache_insert(new_cache,
                                    lm_helpers.cache_extract(cache, src),
                                    dst.cpu())
        for k, v in state.items():
            if k not in ("cache", "health"):
                new_state[k][dst] = v[src]
    return new_state


def resize_block_pool(state: Dict, allocator, new_n_blocks: int
                      ) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """Elastic paged-pool resize: compact live blocks to the front of a
    pool of ``new_n_blocks`` (grow under admission pressure, shrink after a
    long-context burst retires). ``allocator`` is the server's
    :class:`repro_torch.runtime.paging.BlockAllocator`: its ``resize_pool``
    renumbers the live blocks and rewrites every table; this moves the page
    tensors to match (new tensors) and uploads the tables. Refcounts move
    with the renumbering, so blocks shared across slots stay shared. The
    explicit ``(old_ids, new_ids)`` map is returned beside the new state so
    the caller can remap its prefix index by the same permutation. Raises
    ``ValueError`` if the live blocks do not fit the new pool."""
    from repro_torch.models import lm as lm_helpers

    old_ids, new_ids = allocator.resize_pool(new_n_blocks)
    cache = dict(state["cache"])
    for k in lm_helpers.PAGE_POOL_LEAVES:
        if k not in cache:
            continue
        v = cache[k]
        nv = torch.zeros(v.shape[:1] + (int(new_n_blocks),) + v.shape[2:],
                         dtype=v.dtype, device=v.device)
        if len(old_ids):
            dst = torch.as_tensor(np.asarray(new_ids, np.int64),
                                  device=v.device)
            src = torch.as_tensor(np.asarray(old_ids, np.int64),
                                  device=v.device)
            nv[:, dst] = v[:, src]
        cache[k] = nv
    cache["bt"] = torch.from_numpy(np.array(allocator.tables)).to(
        cache["bt"].device)
    allocator.dirty = False
    return dict(state, cache=cache), old_ids, new_ids


class StragglerMitigator:
    """Tracks per-step wall time; when a step exceeds ``factor`` x EMA more
    than ``patience`` consecutive times, fires ``on_straggle``. On one
    device this is monitoring; the hook is what a controller subscribes
    to."""

    def __init__(self, factor: float = 2.0, patience: int = 3,
                 on_straggle: Optional[Callable[[int, float], None]] = None):
        self.factor = factor
        self.patience = patience
        self.on_straggle = on_straggle or (lambda step, dt: None)
        self.ema = 0.0
        self.beta = 0.9
        self.consecutive = 0
        self.events = 0

    def record(self, step: int, dt: float) -> bool:
        slow = self.ema > 0 and dt > self.factor * self.ema
        if slow:
            self.consecutive += 1
            if self.consecutive >= self.patience:
                self.events += 1
                self.on_straggle(step, dt)
                self.consecutive = 0
        else:
            self.consecutive = 0
        self.ema = dt if self.ema == 0 else (self.beta * self.ema
                                             + (1 - self.beta) * dt)
        return slow


def elastic_restore(ckpt: Checkpointer, abstract_state, shardings,
                    step: Optional[int] = None):
    """Restore checkpoint ``step`` (default: the latest) onto the CURRENT
    mesh. Leaves are stored unsharded (host numpy) and cut to each rank's
    shard by today's ``shardings`` (a tree like ``abstract_state`` of
    :class:`repro_torch.parallel.shard.Placement`s), so this works across
    rank-count changes (elastic up/down scale). For a port model's train
    state, :func:`repro_torch.interop.restore_train_state` builds the
    template and the shardings from the model."""
    return ckpt.restore(abstract_state, step=step, shardings=shardings)


def fault_tolerant_train_loop(model, train_cfg, state, data, n_steps: int,
                              ckpt: Checkpointer, ckpt_every: int = 50,
                              log_fn=print,
                              guard: Optional[PreemptionGuard] = None,
                              straggler: Optional[StragglerMitigator] = None,
                              step_fn=None):
    """Training loop with preemption-safe checkpointing and the data
    state captured.

    Every ``ckpt_every`` steps the state is copied to the host and written
    on the checkpointer's writer thread (``save_async``); on preemption it
    is written synchronously and the loop stops. Checkpoints are in the
    JAX package's layout (:func:`repro_torch.interop.to_jax_train_state`).
    The step time runs to a device synchronize. ``step_fn`` defaults to
    :func:`repro_torch.runtime.trainer.make_train_step`'s."""
    from repro_torch.runtime.trainer import _sync, make_train_step

    step_fn = step_fn or make_train_step(model, train_cfg)
    guard = guard or PreemptionGuard(install=False)
    straggler = straggler or StragglerMitigator()
    metrics = {}
    tr = obs_trace.get_tracer()
    for _ in range(n_steps):
        with tr.span("train.data_next"):
            batch = next(data)
        t0 = time.perf_counter()
        with tr.span("train.step"):
            state, metrics = step_fn(state, batch)
        with tr.span("train.host_sync"):
            _sync(model.device)
        step = int(state["step"])
        straggler.record(step, time.perf_counter() - t0)
        meta = {"data": data.state()} if hasattr(data, "state") else None
        if ckpt_every and step % ckpt_every == 0:
            ckpt.save_async(to_jax_train_state(model, state), step,
                            metadata=meta)
        if guard.preempted:
            log_fn(f"preempted at step {step}: checkpointing and exiting")
            ckpt.wait()
            ckpt.save(to_jax_train_state(model, state), step, metadata=meta)
            break
    ckpt.wait()
    return state, metrics
