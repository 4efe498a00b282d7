"""Training runtime (port of ``repro.runtime.trainer``): train state, step
function with microbatch accumulation, weight-stationary quantization, BFP
gradient compression with error feedback, clipping, the schedule and the
optimizer on the FP32 masters; the step timer and the training loop.

The train state is a dict as in the JAX package: ``params`` (the model's
own ``nn.Parameter``s by name: the FP32 masters), ``opt`` (the optimizer
state, dicts of tensors by the same names), ``step`` (an int32 0-d tensor)
and, under BFP gradient compression, ``err`` (the error-feedback buffer).
Unlike the JAX step, which returns a new state, :func:`make_train_step`'s
step updates the masters, the moments and the buffers IN PLACE and returns
the same dict: the masters and each moment of a full-width model are 2 GB.
Gradients come from ``torch.autograd.grad`` (the JAX ``value_and_grad``),
so no ``.grad`` field is read or left behind.

``make_train_step(..., mesh=)`` runs the step sharded over a mesh
(FSDP x TP, :mod:`repro_torch.parallel`), computing the JAX step's logical
global step as GSPMD does with the sharding rules: each rank holds its
shards of the params, moments and error buffer, as
:func:`repro_torch.parallel.sharding.train_state_shardings` places them,
and takes its rows of the global batch. Its loss is the rank's mean
scaled by 1/dp, so the gradients summed over the data ranks are the
global batch's mean: an FSDP-sharded leaf's gradient comes back
reduce-scattered from the FSDP gather's backward, a leaf replicated over
``data`` is all-reduced over the batch axes. The loss and metrics are the
global means, the clip norm counts every shard once (a replicated leaf
once), and BFP compression with error feedback runs on the reduced
gradient's shard (compression after the reduction, as in the JAX step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.interop import to_jax_train_state
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import grad_compress
from repro_torch.optim.optimizers import (clip_by_global_norm,
                                          make_optimizer,
                                          sharded_global_norm)
from repro_torch.optim.schedules import constant

Tree = Dict[str, torch.Tensor]


def init_train_state(model: nn.Module, train_cfg: TrainConfig
                     ) -> Dict[str, Any]:
    """The train state of ``model``'s current weights (the JAX
    ``init_train_state`` draws them from a key; the port's model already
    holds them: build it from a generator, or load the JAX package's with
    :func:`repro_torch.interop.load_jax_params`)."""
    params = dict(model.named_parameters())
    opt_init, _ = make_optimizer(train_cfg)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=model.device)}
    if train_cfg.grad_compression == "bfp":
        state["err"] = grad_compress.init_error_buffer(params)
    return state


_QUANT_LEAF = ("w", "emb", "gate", "up", "down")


def _quantized_names(params: Tree):
    """The GEMM weights weight-stationary quantization puts on the grid:
    leaves named as in the JAX package's ``_QUANT_LEAF``, of rank >= 2,
    except the embedding table (its gathers stay FP32; the tied head
    quantizes it per call)."""
    return [k for k, p in params.items()
            if p.dim() >= 2 and k.rsplit(".", 1)[-1] in _QUANT_LEAF
            and k.rsplit(".", 1)[-1] != "emb"]


@torch.no_grad()
def _prequantize_params(params: Tree, policy, dtype: torch.dtype) -> Tree:
    """Weight-stationary quantization: every GEMM weight on the BFP grid
    ONCE per step, grouped along its contraction dim (axis -2), as the
    photonic core programs a tile once and streams inputs against it. Each
    weight goes through the BFP quantizer (kernel #2 on the card) as one
    transposed contiguous copy, and comes back as a transposed view, which
    the GEMM kernel reads in place. BFP(b_m <= 6) grid values are
    bf16-exact, so bf16 storage is lossless. Returns ``params`` with the
    quantized weights as new leaves that require grad (their gradients are
    the masters', straight through)."""
    out = dict(params)
    for k in _quantized_names(params):
        moved = torch.movedim(params[k].detach(), -2, -1).contiguous()
        q = ops.bfp_fake_quant(moved, policy)
        out[k] = torch.movedim(q, -1, -2).to(dtype).requires_grad_(True)
    return out


class _Loss(nn.Module):
    """``model.loss`` as a module call, so ``torch.func.functional_call``
    can run it on substituted (weight-stationary) parameters."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.loss(batch)


def _to_device(batch, device) -> Tree:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _reduce_grads(grads: Tree, placements, comm) -> Tree:
    """Sum each rank's gradients over the batch axes: leaves replicated over
    ``data`` are all-reduced; FSDP leaves come reduce-scattered over
    ``data`` already (and are all-reduced over ``pod``). Without a mesh
    (``comm`` None) the gradients as they are. The step's gradients, before
    compression and clipping, are this function's result in every step."""
    if comm is None:
        return grads
    out = {}
    for k, g in grads.items():
        if placements[k].data_dim is None:
            out[k] = comm.all_reduce(g, "dp")
        elif comm.size("pod") > 1:
            out[k] = comm.all_reduce(g, "pod")
        else:
            out[k] = g
    return out


def _global_mean(t: torch.Tensor, comm) -> torch.Tensor:
    return comm.all_reduce(t, "dp") / comm.dp


def make_train_step(model: nn.Module, train_cfg: TrainConfig,
                    lr_schedule: Optional[Callable] = None, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics).

    Microbatching: the batch is split along axis 0 into ``microbatches``
    slices and their gradients are summed, then averaged. Under
    weight-stationary quantization the weights are quantized once per step,
    outside the microbatch loop, and the model runs on the quantized copies
    (``torch.func.functional_call``); their gradients update the FP32
    masters (paper Eq. 4). As in the JAX package, the GEMMs skip their own
    weight-side quantization only where the model's policy says
    ``assume_quantized_weights``. Metrics are 0-d tensors on the model's
    device (no host sync inside the step).

    With a ``mesh`` (a ``DeviceMesh`` named ``data``/``model``, or its
    :class:`repro_torch.parallel.comm.MeshComm`) the model is sharded in
    place first (:func:`repro_torch.parallel.shard.shard_model`: build the
    train state AFTER this call, from the sharded model), and the step
    takes the rank's rows of the global batch
    (:func:`repro_torch.parallel.shard.local_batch`)."""
    from repro_torch.core import backends

    _, opt_update = make_optimizer(train_cfg)
    lr_schedule = lr_schedule or constant(train_cfg.lr)
    nmb = train_cfg.microbatches
    # weight-stationary quantization applies when the GEMM backend declares
    # it honours pre-quantized weight operands (a capability flag)
    wsq = (train_cfg.weight_stationary_quant
           and backends.resolve(train_cfg.policy).supports_weight_stationary)
    qdtype = (torch.bfloat16 if train_cfg.quant_param_dtype == "bfloat16"
              else torch.float32)
    loss_module = _Loss(model)
    comm = None
    if mesh is not None:
        from repro_torch.parallel import shard

        comm = shard.shard_model(model, mesh)
        shard.check_bfp_groups(
            model, train_cfg.policy, weight_stationary=wsq,
            compress_g=(train_cfg.policy.g
                        if train_cfg.grad_compression == "bfp" else None))
    # each data rank's mean, scaled so the sum over data ranks is the
    # global batch's mean
    scale = 1.0 / comm.dp if comm is not None and comm.dp > 1 else None

    def value_and_grad(run: Tree, batch: Tree):
        names = list(run)
        if wsq:
            loss, metrics = torch.func.functional_call(
                loss_module, {f"model.{k}": v for k, v in run.items()},
                (batch,))
        else:
            loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss if scale is None else loss * scale,
                                    [run[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(run[k]) if g is None else g
                 for k, g in zip(names, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state, batch):
        params = state["params"]
        batch = _to_device(batch, model.device)
        if comm is not None and comm.dp > 1 and \
                train_cfg.policy.mode.startswith("mirage") and \
                batch["tokens"].numel() // nmb % train_cfg.policy.g:
            # the dW GEMMs group the tokens along M: a data rank's tokens
            # must hold whole groups of the global batch's
            raise ValueError(
                f"{batch['tokens'].numel() // nmb} tokens a data rank (a "
                f"microbatch) cut BFP groups of {train_cfg.policy.g}")
        run = params
        if wsq:
            # quantize once per step; grads flow straight through to the
            # FP32 master below (paper Eq. 4 semantics)
            run = _prequantize_params(params, train_cfg.policy, qdtype)
        if nmb > 1:
            # the JAX step adds every microbatch's gradients into f32
            # zeros, so bf16 gradients of the quantized copies are cast
            # before the sum, not after it
            grads, loss = None, None
            for i in range(nmb):
                mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l_i, metrics, g_i = value_and_grad(run, mb)
                g_i = {k: g.to(torch.float32) for k, g in g_i.items()}
                if grads is None:
                    grads, loss = g_i, l_i
                else:
                    grads = {k: grads[k] + g_i[k] for k in grads}
                    loss = loss + l_i
            grads = {k: g / nmb for k, g in grads.items()}
            loss = loss / nmb
        else:
            loss, metrics, grads = value_and_grad(run, batch)
            # gradients of bf16 weight copies come back in bf16, as in JAX
            grads = {k: g.to(torch.float32) for k, g in grads.items()}
        del run
        grads = _reduce_grads(grads, getattr(model, "placements", None),
                              comm)
        if comm is not None:
            loss = _global_mean(loss, comm)
            ce = _global_mean(metrics["ce"], comm)
            metrics = dict(metrics, ce=ce,
                           ppl=torch.exp(torch.clamp_max(ce, 20.0)))

        if train_cfg.grad_compression == "bfp":
            grads, state["err"] = grad_compress.compress_with_error_feedback(
                grads, state["err"], train_cfg.policy.b_m,
                train_cfg.policy.g)

        if train_cfg.grad_clip > 0:
            norm = None if comm is None else sharded_global_norm(
                grads, model.placements, comm)
            grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip,
                                               norm)
        else:
            gnorm = torch.zeros((), device=model.device)

        lr = lr_schedule(state["step"])
        # the optimizer always updates the FP32 MASTER weights (Eq. 4)
        opt_update(grads, state["opt"], params, lr)
        state["step"] += 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return state, metrics

    return train_step


@dataclasses.dataclass
class StepTimer:
    """Straggler monitor: per-step EMA + slow-step flags."""
    ema: float = 0.0
    beta: float = 0.9
    slow_factor: float = 2.0
    slow_steps: int = 0

    def record(self, dt: float) -> bool:
        slow = self.ema > 0 and dt > self.slow_factor * self.ema
        self.ema = dt if self.ema == 0 else (self.beta * self.ema
                                             + (1 - self.beta) * dt)
        if slow:
            self.slow_steps += 1
        return slow


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(model: nn.Module, train_cfg: TrainConfig, state, data_iter,
               n_steps: int, checkpointer=None, ckpt_every: int = 0,
               log_every: int = 10, log_fn=print, registry=None,
               step_fn=None):
    """Single-host training loop with straggler hooks.

    Observability: each phase of the loop opens a tracer span
    (``train.data_next`` / ``train.step`` / ``train.host_sync`` — free when
    the tracer is disabled) and step latency/count land in ``registry``
    (default: the process registry) as ``train_step_seconds`` /
    ``train_steps_total``. The step time runs to a device synchronize.
    ``step_fn`` defaults to :func:`make_train_step`'s. With a
    ``checkpointer`` (:class:`repro_torch.checkpoint.Checkpointer`) the
    state is saved synchronously, in the JAX package's layout
    (:func:`repro_torch.interop.to_jax_train_state`), after every step
    that is a multiple of ``ckpt_every``."""
    reg = registry if registry is not None else obs_metrics.get_registry()
    h_step = reg.histogram("train_step_seconds",
                           "walltime per optimizer step (dispatch + sync)")
    c_steps = reg.counter("train_steps_total", "optimizer steps completed")
    g_slow = reg.gauge("train_slow_steps", "straggler-flagged steps so far")
    tr = obs_trace.get_tracer()
    step_fn = step_fn or make_train_step(model, train_cfg)
    timer = StepTimer()
    metrics = {}
    for i in range(n_steps):
        with tr.span("train.data_next"):
            batch = next(data_iter)
        t0 = time.perf_counter()
        with tr.span("train.step", {"i": i}):
            state, metrics = step_fn(state, batch)
        with tr.span("train.host_sync"):
            _sync(model.device)
        dt = time.perf_counter() - t0
        slow = timer.record(dt)
        h_step.observe(dt)
        c_steps.inc()
        g_slow.set(timer.slow_steps)
        step = int(state["step"])
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            log_fn(f"step {step}: loss={float(metrics['loss']):.4f} "
                   f"ppl={float(metrics.get('ppl', 0)):.2f} "
                   f"gnorm={float(metrics['grad_norm']):.3f}"
                   + (" [SLOW STEP]" if slow else ""))
        if checkpointer is not None and ckpt_every and step % ckpt_every == 0:
            checkpointer.save(to_jax_train_state(model, state), step)
    return state, metrics
