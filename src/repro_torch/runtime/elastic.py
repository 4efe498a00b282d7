"""Preemption handling, straggler monitoring and the fault-tolerant training
loop on one device (port of the single-device part of
``repro.runtime.elastic``).

The scheduler preempts with SIGTERM: :class:`PreemptionGuard` turns it into
a flag, and :func:`fault_tolerant_train_loop` checkpoints at the next step
boundary and stops, with the data pipeline's state in the checkpoint's
metadata, so a resumed run continues on exactly the batch the stopped one
would have taken next. Restoring on another mesh (``elastic_restore``) and
resizing a serving state or its block pool wait with the distributed and
serving slices (ROADMAP.md queue 1, slices 5 and 8).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

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
