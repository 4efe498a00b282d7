"""Mixture-of-Experts layer: top-k routing, capacity-bounded dispatch
(port of ``repro.models.moe``).

Dispatch is the fixed-capacity scheme of the JAX package: each expert owns a
``(C, d)`` buffer, tokens are scattered into their expert's buffer in
routing-priority order (slot-major, so every token's first choice comes
before any second choice), and tokens past capacity are dropped. The expert
FFNs run as ONE batched GEMM call per weight stack over all E experts
(:func:`repro_torch.core.gemm.mirage_matmul_auto` with an ``(E, K, N)``
weight: one launch of the GEMM kernel on the card), where the JAX package
vmaps its GEMM over the experts. The router stays f32 (TF32 off), as in the
JAX package.

Every step runs on the device without a host sync (no ``nonzero``, no
boolean-mask indexing), so a decode tick with MoE layers can be captured as
a CUDA graph. Dropped (token, slot) pairs all write the one trash row past
the buffers; the kept rows have distinct targets, so their contents do not
depend on the order in which duplicate writes land.

Training differentiates through the same calls, as the JAX package's
``jax.grad`` does: each expert stack's dX and dW are one batched GEMM call
each (:class:`repro_torch.core.gemm.MirageMatmul` over the stack); the
router's f32 matmul keeps TF32 off in the backward too (the pin is
global); the stable sort's gradient scatters the gates' gradient back to
the chosen probabilities, as ``jax.lax.top_k``'s does; the dispatch's
``index_copy_`` hands each (token, slot) pair the gradient of its buffer
row (dropped pairs read the trash row, which gets none); and the
combine's gather accumulates, in its backward, only into the zero row
of the dropped pairs, since the kept pairs' rows are distinct, so the
backward adds no float atomically on a kept row and repeats bit for bit.
The aux loss reaches the router through ``probs`` only.

On a mesh (:func:`repro_torch.parallel.shard.shard_model`) the layer runs
on the rank's tokens (its rows of the batch) and its experts, and
computes the single-device function of the whole batch, as GSPMD computes
the JAX ``moe_apply`` under the sharding rules: the capacity C comes from
the global token count, and each (token, slot)'s position is its rank
among the GLOBAL batch's picks of its expert in routing order (the
per-expert counts of the lower data ranks, all-gathered, lead the rank's
own cumulative sums). The buffers of the rank's experts (E/tp of them
where the stacks are expert-parallel over ``model``) are summed over the
data ranks, whose rows are disjoint, so every data rank runs the experts'
GEMMs on the global buffers, as the JAX rules replicate them over
``data``: each expert GEMM, and each BFP group of its dW along the
buffer's rows, is the single-device one. A token's output sums its
experts' rows over ``model``; the load-balancing means are global means.

:func:`moe_apply_ep` is the JAX package's expert-parallel ``shard_map``
body: each model rank routes its data shard's tokens to its own E/tp
experts with C from the LOCAL token count, one all-reduce over ``model``
combines the partial outputs, and the aux loss takes the means of the
router statistics over the data ranks before their product. With tokens
dropped it therefore equals :func:`moe_apply` run on each data shard
alone; dropless, it equals the single-device :func:`moe_apply`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.core.backends.baselines import _pin_full_f32
from repro_torch.core.gemm import mirage_matmul_auto
from repro_torch.core.precision import MiragePolicy
from repro_torch.models import common
from repro_torch.parallel import comm as pcomm


class MoE(nn.Module):
    """Router (f32 ``Dense``, no bias) and the stacked expert weights
    ``gate``/``up`` ``(E, d, f)`` and ``down`` ``(E, f, d)``, drawn as the
    JAX ``moe_init`` draws them (N(0, 1/d) and N(0, 1/f))."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, *,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.router = common.Dense(d_model, n_experts, False, **kw)
        std_in, std_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        self.gate = common._normal((n_experts, d_model, d_ff), std_in, **kw)
        self.up = common._normal((n_experts, d_model, d_ff), std_in, **kw)
        self.down = common._normal((n_experts, d_ff, d_model), std_out, **kw)
        # the stacks' programmed residues ({"gate", "up", "down"} ->
        # StationaryResidues) while a serving engine installs them
        self.stationary = None


class Routing(NamedTuple):
    """One MoE call's routing: ``probs`` (T, E) f32, the renormalized
    ``gate_vals`` and ``expert_ids`` (T, K) of the top K, each (token,
    slot)'s ``positions`` in its expert's buffer (T, K), ``keep`` (T, K)
    (position under capacity C), and ``slot_index`` (T * K,), the flat row
    ``e * C + pos`` of a kept pair in the ``(E * C + 1, d)`` buffers, or the
    trash row ``E * C``."""
    probs: torch.Tensor
    gate_vals: torch.Tensor
    expert_ids: torch.Tensor
    positions: torch.Tensor
    keep: torch.Tensor
    slot_index: torch.Tensor


def capacity(T: int, n_experts: int, experts_per_token: int,
             capacity_factor: float, min_capacity: int = 4) -> int:
    """Rows per expert buffer (the JAX package's ``C``)."""
    return max(min_capacity,
               int(capacity_factor * T * experts_per_token / n_experts))


def route(router: common.Dense, xf: torch.Tensor, K: int, C: int,
          comm=None) -> Routing:
    """Route the tokens ``xf`` (T, d) to their top ``K`` experts with
    capacity ``C`` per expert (the JAX ``moe_apply``'s routing, step for
    step). Ties among equal probabilities go to the lower expert id, as
    ``jax.lax.top_k`` orders them: the top K come from a stable descending
    sort. With a ``comm`` whose batch axes hold more than one data rank,
    ``xf`` is the rank's share of the global batch and the positions are
    global: each slot's per-expert counts of the lower data ranks lead the
    rank's own, and the counts of every rank's earlier slots fill in
    first."""
    _pin_full_f32()
    # a weight-stationary step hands the router its bf16 grid copy, which
    # the JAX package's f32 matmul promotes to f32
    logits = torch.matmul(xf.to(torch.float32),
                          common.weight(router).to(torch.float32))  # (T, E)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :K], ids[:, :K]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    # position of each (token, slot) in its expert's buffer, slot-major:
    # slot 0 (the highest gate) of every token before any slot 1
    experts = torch.arange(E, device=xf.device)
    ohs = [(expert_ids[:, j, None] == experts).to(torch.int64)
           for j in range(K)]                                   # (T, E)
    lead = [torch.zeros((E,), dtype=torch.int64, device=xf.device)] * K
    fill = torch.zeros((E,), dtype=torch.int64, device=xf.device)
    if comm is not None and comm.dp > 1:
        # (dp, K, E): every data rank's per-slot counts, in batch order
        counts = comm.all_gather(torch.stack(
            [torch.sum(oh, dim=0) for oh in ohs])[None], "dp", 0)
        lead = list(torch.sum(counts[:comm.dp_rank], dim=0))
        totals = torch.sum(counts, dim=0)                       # (K, E)
    positions = []
    for j, oh in enumerate(ohs):
        pos_within = torch.cumsum(oh, dim=0) - 1
        pos = torch.gather(pos_within, 1, expert_ids[:, j:j + 1])[:, 0]
        positions.append(pos + (fill + lead[j])[expert_ids[:, j]])
        fill = fill + (totals[j] if comm is not None and comm.dp > 1
                       else torch.sum(oh, dim=0))
    positions = torch.stack(positions, dim=1)                   # (T, K)
    keep = positions < C
    slot_index = torch.where(keep, expert_ids * C + positions,
                             E * C).reshape(-1)
    return Routing(probs, gate_vals, expert_ids, positions, keep, slot_index)


def moe_apply(p: MoE, x: torch.Tensor, policy: MiragePolicy, *,
              n_experts: int, experts_per_token: int,
              capacity_factor: float = 1.25, min_capacity: int = 4,
              comm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> (out (B, L, d), the Switch load-balancing aux loss,
    an f32 scalar). With a ``comm`` (the model's, on a mesh) ``x`` is the
    rank's rows of the global batch and the result is the single-device
    function's rows for them (module docstring)."""
    Bt, L, d = x.shape
    E, K = n_experts, experts_per_token
    dp = comm.dp if comm is not None else 1
    C = capacity(Bt * L * dp, E, K, capacity_factor, min_capacity)
    xf = x.reshape(Bt * L, d)
    r = route(p.router, xf, K, C, comm) if dp > 1 else \
        route(p.router, xf, K, C)
    out = _experts(p, xf, r, C, policy, comm, global_buffers=dp > 1)
    return out.reshape(Bt, L, d), _aux(r, E, comm)


def moe_apply_ep(p: MoE, x: torch.Tensor, policy: MiragePolicy, *,
                 n_experts: int, experts_per_token: int,
                 capacity_factor: float = 1.25, min_capacity: int = 4,
                 comm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE (the JAX package's ``shard_map`` path): each
    model rank routes its data shard's tokens ``x`` (B_loc, L, d) to its
    own E/tp experts with C from the local token count, one all-reduce over
    ``model`` combines the partial outputs, and the aux loss takes the
    router statistics' means over the data ranks. Needs expert-parallel
    stacks (E % tp == 0 on a mesh with tp > 1); falls back to
    :func:`moe_apply` otherwise, as the JAX function does."""
    dim = common.tp_dim(p, "gate")[0]
    if comm is None or comm.tp <= 1 or dim != 0:
        return moe_apply(p, x, policy, n_experts=n_experts,
                         experts_per_token=experts_per_token,
                         capacity_factor=capacity_factor,
                         min_capacity=min_capacity, comm=comm)
    Bt, L, d = x.shape
    E, K = n_experts, experts_per_token
    C = capacity(Bt * L, E, K, capacity_factor, min_capacity)
    xf = x.reshape(Bt * L, d)
    r = route(p.router, xf, K, C)
    out = _experts(p, xf, r, C, policy, comm, global_buffers=False)
    return out.reshape(Bt, L, d), _aux(r, E, comm)


class _SumOverDP(torch.autograd.Function):
    """Buffers whose rows the data ranks fill disjointly, summed over the
    batch axes (each rank gets the global buffers); backward, the gradient
    (the data ranks' mean, :class:`_SpreadOverDP`) times the rank count."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x, "dp")

    @staticmethod
    def backward(ctx, g):
        return g * ctx.comm.dp, None


class _SpreadOverDP(torch.autograd.Function):
    """Identity forward; backward, the mean over the batch axes of the
    ranks' gradients (each rank's reaches its own rows alone), so every
    data rank runs the experts' backward GEMMs on the global gradient,
    scaled by 1/dp: the trainer's sum over data ranks restores it."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, "dp") / ctx.comm.dp, None


def _experts(p: MoE, xf: torch.Tensor, r: Routing, C: int,
             policy: MiragePolicy, comm, global_buffers: bool
             ) -> torch.Tensor:
    """Dispatch the tokens ``xf`` (T, d) as ``r`` routes them, run the
    rank's experts, and combine: (T, d). On a mesh the stacks may be
    expert-parallel (dim 0 over ``model``: the rank's E/tp experts) or
    TP-sharded along f; either way the rank's outputs are partial sums
    over ``model``. ``global_buffers`` sums the buffers over the data
    ranks first (:func:`moe_apply` on a mesh)."""
    T, d = xf.shape
    E = r.probs.shape[-1]
    K = r.expert_ids.shape[-1]
    tdim, tcomm = common.tp_dim(p, "gate")
    E_loc, slot_index = E, r.slot_index
    if tdim == 0:
        # the rank's experts [e0, e0 + E_loc): other pairs go to the trash
        E_loc = p.gate.shape[0]
        e0 = tcomm.tp_rank * E_loc
        mine = r.keep & (r.expert_ids >= e0) & (r.expert_ids < e0 + E_loc)
        slot_index = torch.where(mine, (r.expert_ids - e0) * C + r.positions,
                                 E_loc * C).reshape(-1)
    if tdim is not None:
        xf = pcomm.copy_to_tp(xf, tcomm)

    # dispatch: every (token, slot) pair into its row of the (E * C + 1, d)
    # buffers; dropped pairs land in the trash row E * C
    src = xf[:, None, :].expand(T, K, d).reshape(T * K, d)
    flat = torch.zeros((E_loc * C + 1, d), dtype=xf.dtype, device=xf.device)
    flat.index_copy_(0, slot_index, src)
    buffers = flat[:E_loc * C].view(E_loc, C, d)
    if global_buffers:
        buffers = _SumOverDP.apply(buffers, comm)

    # the expert FFNs: one batched GEMM per weight stack over the experts,
    # against the stacks' programmed residues where installed
    w = p.stationary or {k: common.weight(p, k)
                         for k in ("gate", "up", "down")}
    h = torch.nn.functional.silu(mirage_matmul_auto(buffers, w["gate"],
                                                    policy)) \
        * mirage_matmul_auto(buffers, w["up"], policy)
    out_buffers = mirage_matmul_auto(h, w["down"], policy)      # (E, C, d)
    if global_buffers:
        out_buffers = _SpreadOverDP.apply(out_buffers, comm)

    # combine: each token's K results (a dropped pair reads the zero row),
    # weighted by its gates
    out_flat = torch.cat([out_buffers.reshape(E_loc * C, d),
                          torch.zeros((1, d), dtype=out_buffers.dtype,
                                      device=out_buffers.device)])
    gathered = out_flat[slot_index].reshape(T, K, d)
    gates = (r.gate_vals * r.keep).to(gathered.dtype)
    if tdim is not None:
        # the gates weigh the rank's experts' rows alone: their gradient is
        # a partial sum over ``model`` too (the router is replicated)
        gates = pcomm.copy_to_tp(gates, tcomm)
    out = torch.einsum("tkd,tk->td", gathered, gates)
    if tdim is not None:
        out = pcomm.reduce_from_tp(out, tcomm)
    return out


def _aux(r: Routing, E: int, comm) -> torch.Tensor:
    """Switch-style load-balancing loss from the router statistics' means
    over the global batch (over the data ranks where ``comm`` has
    several: the means are averaged before their product)."""
    me = pcomm.mean_over_dp(torch.mean(r.probs, dim=0), comm)
    ce = pcomm.mean_over_dp(torch.mean(
        (r.expert_ids[:, 0, None] ==
         torch.arange(E, device=r.probs.device)).to(torch.float32), dim=0),
        comm)
    return E * torch.sum(me * ce)
