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

``moe_apply_ep`` (expert parallelism over a mesh) waits in the distributed
slice (ROADMAP.md queue 1, item 14).
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


def route(router: common.Dense, xf: torch.Tensor, K: int, C: int
          ) -> Routing:
    """Route the tokens ``xf`` (T, d) to their top ``K`` experts with
    capacity ``C`` per expert (the JAX ``moe_apply``'s routing, step for
    step). Ties among equal probabilities go to the lower expert id, as
    ``jax.lax.top_k`` orders them: the top K come from a stable descending
    sort."""
    _pin_full_f32()
    # a weight-stationary step hands the router its bf16 grid copy, which
    # the JAX package's f32 matmul promotes to f32
    logits = torch.matmul(xf.to(torch.float32),
                          router.w.to(torch.float32))          # (T, E) f32
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :K], ids[:, :K]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    # position of each (token, slot) in its expert's buffer, slot-major:
    # slot 0 (the highest gate) of every token before any slot 1
    experts = torch.arange(E, device=xf.device)
    fill = torch.zeros((E,), dtype=torch.int64, device=xf.device)
    positions = []
    for j in range(K):
        oh = (expert_ids[:, j, None] == experts).to(torch.int64)   # (T, E)
        pos_within = torch.cumsum(oh, dim=0) - 1
        pos = torch.gather(pos_within, 1, expert_ids[:, j:j + 1])[:, 0]
        positions.append(pos + fill[expert_ids[:, j]])
        fill = fill + torch.sum(oh, dim=0)
    positions = torch.stack(positions, dim=1)                   # (T, K)
    keep = positions < C
    slot_index = torch.where(keep, expert_ids * C + positions,
                             E * C).reshape(-1)
    return Routing(probs, gate_vals, expert_ids, positions, keep, slot_index)


def moe_apply(p: MoE, x: torch.Tensor, policy: MiragePolicy, *,
              n_experts: int, experts_per_token: int,
              capacity_factor: float = 1.25, min_capacity: int = 4
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> (out (B, L, d), the Switch load-balancing aux loss,
    an f32 scalar)."""
    Bt, L, d = x.shape
    T = Bt * L
    E, K = n_experts, experts_per_token
    xf = x.reshape(T, d)
    C = capacity(T, E, K, capacity_factor, min_capacity)
    r = route(p.router, xf, K, C)

    # dispatch: every (token, slot) pair into its row of the (E * C + 1, d)
    # buffers; dropped pairs land in the trash row E * C
    src = xf[:, None, :].expand(T, K, d).reshape(T * K, d)
    flat = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    flat.index_copy_(0, r.slot_index, src)
    buffers = flat[:E * C].view(E, C, d)

    # the expert FFNs: one batched GEMM per weight stack over all E
    # experts, against the stacks' programmed residues where installed
    w = p.stationary or {"gate": p.gate, "up": p.up, "down": p.down}
    h = torch.nn.functional.silu(mirage_matmul_auto(buffers, w["gate"],
                                                    policy)) \
        * mirage_matmul_auto(buffers, w["up"], policy)
    out_buffers = mirage_matmul_auto(h, w["down"], policy)      # (E, C, d)

    # combine: each token's K results (a dropped pair reads the zero row),
    # weighted by its gates
    out_flat = torch.cat([out_buffers.reshape(E * C, d),
                          torch.zeros((1, d), dtype=out_buffers.dtype,
                                      device=out_buffers.device)])
    gathered = out_flat[r.slot_index].reshape(T, K, d)
    gates = (r.gate_vals * r.keep).to(gathered.dtype)
    out = torch.einsum("tkd,tk->td", gathered, gates)

    # load-balancing aux loss (Switch-style)
    me = torch.mean(r.probs, dim=0)
    ce = torch.mean((r.expert_ids[:, 0, None] ==
                     torch.arange(E, device=x.device)).to(torch.float32),
                    dim=0)
    aux = E * torch.sum(me * ce)
    return out.reshape(Bt, L, d), aux
