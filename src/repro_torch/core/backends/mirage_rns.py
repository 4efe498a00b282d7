"""mirage_rns: the full hardware path, group-batched (port of
``repro.core.backends.mirage_rns``).

Forward conversion to the special moduli set -> per-modulus modular GEMM
over all groups at once -> (optional) phase noise on the residue readout ->
CRT reverse conversion -> FP32 scale-accumulate.

The port has no ``use_pallas``: the operand's device picks the route. On
the card both ``mirage_rns`` and ``mirage_rns_pallas`` launch the residue
kernel (``csrc/rns_matmul.cu``) over blocks (:func:`card_blocks`) whose
``(n_mod, experts, groups, M, N)`` residue tensor stays under
:data:`CARD_RESIDUE_BUDGET_BYTES`: whole experts while one expert's
residues fit (a 2-D GEMM is one expert), else one expert in blocks of
groups (:func:`card_group_block`). Each block runs the whole pipeline
(residue kernel, CRT, scale-accumulate), so a training step's tied head
(26 GB of residues in one piece at 256 tokens) fits the card. The residues
are exact either way; blocks of whole experts change nothing, and only the
f32 sum across group blocks is ordered differently, so a blocked result
equals one launch within the GEMM's f32 bound, and bit for bit where one
block covers every group. On the CPU both take the plain path with the
JAX package's regimes, decided on one expert's sizes (as its vmap over
experts sees them): one batched product while the residue stack fits
:data:`grouped.VECTORIZE_BUDGET_BYTES`, else blocks of
:data:`grouped.DEFAULT_GROUP_BLOCK` groups. An explicit
``policy.group_block`` is kept on both. Noisy policies take one launch on
the CPU (as the JAX package); on the card they block too, each block
reading its slice of the one noise draw.

An expert stack (``x (E, C, K)``, ``w (E, K, N)``: the MoE layer, where
the JAX package vmaps this backend over the experts) folds E into the
kernel's slot axis: one launch covers (n_mod, E x G) slots, and each
expert sums its own groups. Its noise is ONE draw at one expert's shape,
shared by every expert, as under the JAX vmap, whose key is not batched.

``policy.noise_sigma > 0`` injects phase noise on the residue outputs and
needs draws: explicit, or the engine's :func:`repro_torch.core.gemm.noise_scope`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.analog import channel
from repro_torch.core import rns, stationary
from repro_torch.core.backends import grouped
from repro_torch.core.backends.base import register_fn


#: the most bytes of int32 residues one launch of the residue kernel writes
#: on the card: the largest serving tensor (gate/up at a 512-token
#: prefill, 1.67 GB) stays one launch, and a training step's head (26 GB
#: in one piece) runs in blocks of at most this, with the CRT's int32
#: temporaries on top (a 3-step run peaks at 17.3 GB on the H100)
CARD_RESIDUE_BUDGET_BYTES = 2 << 30


def card_group_block(n_mod: int, G: int, M: int, N: int,
                     budget: int = CARD_RESIDUE_BUDGET_BYTES) -> int:
    """Groups per launch of the residue kernel on the card: as many as keep
    one block's (n_mod, gb, M, N) int32 residues within ``budget``, at
    least one, at most G."""
    per_group = n_mod * M * N * 4
    return max(1, min(G, budget // max(per_group, 1)))


def card_blocks(n_mod: int, E: int, G: int, M: int, N: int,
                budget: int = CARD_RESIDUE_BUDGET_BYTES) -> Tuple[int, int]:
    """(experts, groups) per launch of the residue kernel on the card: as
    many whole experts as keep their int32 residues within ``budget``
    while one expert's fit, else one expert in blocks of
    :func:`card_group_block` groups."""
    per_expert = n_mod * G * M * N * 4
    if per_expert <= budget:
        return max(1, min(E, budget // max(per_expert, 1))), G
    return 1, card_group_block(n_mod, G, M, N, budget)


def as_stack(xr, wr, sx, sw, stack: bool):
    """The operands of a 2-D GEMM as a stack of one expert (views)."""
    if stack:
        return xr, wr, sx, sw
    return xr[:, None], wr[:, None], sx[None], sw[None]


def run_blocks(xr, wr, sx, sw, eb: int, gb: int, block_fn) -> torch.Tensor:
    """Residues ``xr (n_mod, E, G, M, g)``, ``wr (n_mod, E, G, g, N)`` and
    scales ``sx (E, G, M, 1)``, ``sw (E, G, 1, N)`` through ``block_fn``
    in blocks of ``eb`` experts and ``gb`` groups -> (E, M, N).

    ``block_fn(xb, wb, experts, groups)`` takes one block's residues with
    its (expert, group) slots folded, ``(n_mod, eb x gb, M, g)``, and its
    slices, and returns its values p ``(eb, gb, M, N)`` f32. Blocks of
    every group sum as one launch would (bit for bit); group blocks add
    each block's sum to a running sum in block order, as the JAX package's
    scan over blocks (its zero-padded last block adds exact zeros)."""
    nm, E, G, M, g = xr.shape
    N = wr.shape[-1]
    outs = []
    for e0 in range(0, E, eb):
        es = slice(e0, min(E, e0 + eb))
        acc = None
        for g0 in range(0, G, gb):
            gs = slice(g0, min(G, g0 + gb))
            xb = xr[:, es, gs].reshape(nm, -1, M, g)
            wb = wr[:, es, gs].reshape(nm, -1, g, N)
            if gb < G:
                # group blocks are copied (the kernel's contiguous layout);
                # a block of whole experts runs in place, its slots one
                # run per modulus
                xb, wb = xb.contiguous(), wb.contiguous()
            p = block_fn(xb, wb, es, gs)
            part = grouped.sum_groups(p * sx[es, gs] * sw[es, gs])
            if gb >= G:
                acc = part
            else:
                acc = (torch.zeros_like(part) if acc is None else acc) + part
            del p
        outs.append(acc)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _rns_forward(x, w, policy, draws):
    k = policy.k
    moduli = policy.moduli
    stack = grouped.is_stack(w)
    if isinstance(w, stationary.StationaryResidues):
        # program-once dataflow: only the streamed operand converts
        w.check_matches(policy, moduli, x.shape[-1])
        qx, sx, batch = grouped.prepare_activations(x, policy, stack)
        wr, sw = w.residues, w.scale
    else:
        qx, sx, qw, sw, batch = grouped.prepare_operands(x, w, policy)
        wr = rns.to_rns_special(qw, k)         # (n_mod, [E,] G, g, N) int32
    xr = rns.to_rns_special(qx, k)             # (n_mod, [E,] G, M, g) int32
    xr, wr, sx, sw = as_stack(xr, wr, sx, sw, stack)
    nm, E, G, M, _ = xr.shape
    N = wr.shape[-1]
    noisy = policy.noise_sigma > 0
    if noisy and draws is None:
        raise ValueError(
            "policy.noise_sigma > 0 requires draws: call "
            "mirage_matmul_nograd(x, w, policy, draws=...) or open "
            "gemm.noise_scope")
    gb, eb = policy.group_block, E
    if x.is_cuda:
        from repro_torch.kernels import ops as kops
        residue_op = kops.rns_group_matmul
        if gb == 0:
            eb, gb = card_blocks(nm, E, G, M, N)
    else:
        residue_op = grouped.residue_dots
        if gb == 0:
            gb = -1 if grouped.vectorized(G, M, N, nm) \
                else grouped.DEFAULT_GROUP_BLOCK
        if noisy:          # the JAX package draws over the whole tensor
            gb = -1
    if not 0 < gb < G:
        gb = G
    # one draw at one expert's shape, every expert's noise
    unit = draws.normal("detector", (nm, G, M, N)) if noisy else None
    sigma = (policy.noise_sigma,) * nm

    def block(xb, wb, es, gs):
        res = residue_op(xb, wb, moduli).reshape(
            nm, es.stop - es.start, gs.stop - gs.start, M, N)
        if noisy:
            res = channel.add_noise(res, moduli, (
                unit[:, gs] * channel.device_constant(
                    sigma, torch.float32, res.device).reshape(-1, 1, 1, 1)
            )[:, None])
        return rns.from_rns_special(res, k).to(torch.float32)

    return run_blocks(xr, wr, sx, sw, eb, gb, block).reshape(batch + (N,))


@register_fn("mirage_rns",
             description="group-batched RNS path: residue GEMMs + CRT",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True,
             supports_batched_weights=True)
def _matmul_mirage_rns(x, w, policy, *, draws=None):
    return _rns_forward(x, w, policy, draws)


@register_fn("mirage_rns_pallas",
             description="mirage_rns through the residue kernel (the port "
                         "routes by device, so it is mirage_rns)",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True,
             supports_batched_weights=True)
def _matmul_mirage_rns_pallas(x, w, policy, *, draws=None):
    return _rns_forward(x, w, policy, draws)
