"""mirage_rns: the full hardware path, group-batched (port of
``repro.core.backends.mirage_rns``).

Forward conversion to the special moduli set -> per-modulus modular GEMM
over all groups at once -> (optional) phase noise on the residue readout ->
CRT reverse conversion -> FP32 scale-accumulate.

The port has no ``use_pallas``: the operand's device picks the route. On
the card both ``mirage_rns`` and ``mirage_rns_pallas`` launch the residue
kernel (``csrc/rns_matmul.cu``), once per block of groups whose
``(n_mod, gb, M, N)`` residue tensor stays under
:data:`CARD_RESIDUE_BUDGET_BYTES` (:func:`card_group_block`): each block
runs the whole pipeline (residue kernel, CRT, scale-accumulate), so a
training step's tied head (26 GB of residues in one piece at 256 tokens)
fits the card. The residues are exact either way; only the f32 sum across
blocks is ordered differently, so a blocked result equals one launch
within the GEMM's f32 bound, and bit for bit where one block covers every
group. On the CPU both take the plain path with the JAX package's
regimes: one batched product while the residue stack fits
:data:`grouped.VECTORIZE_BUDGET_BYTES`, else blocks of
:data:`grouped.DEFAULT_GROUP_BLOCK` groups. An explicit
``policy.group_block`` is kept on both. Noisy policies take one launch:
their noise is drawn over the whole residue tensor.

``policy.noise_sigma > 0`` injects phase noise on the residue outputs and
needs draws: explicit, or the engine's :func:`repro_torch.core.gemm.noise_scope`.
"""

from __future__ import annotations

import torch

from repro_torch.core import noise, rns, stationary
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


def _rns_blocked(xr, wr, sx, sw, policy, gb, residue_op):
    """Group blocks of ``gb``, each through ``residue_op`` (the residue
    kernel on the card, the plain residue dots on the CPU) -> CRT ->
    scale-accumulate, so the intermediate is bounded at (gb, M, N)."""
    nm, G, M, g = xr.shape
    N = wr.shape[-1]
    acc = torch.zeros((M, N), dtype=torch.float32, device=xr.device)
    for g0 in range(0, G, gb):
        # a ragged last block equals the JAX package's zero-padded one:
        # zero groups add exactly 0.0
        res = residue_op(xr[:, g0:g0 + gb].contiguous(),
                         wr[:, g0:g0 + gb].contiguous(), policy.moduli)
        p = rns.from_rns_special(res, policy.k).to(torch.float32)
        del res
        acc = acc + grouped.sum_groups(p * sx[g0:g0 + gb] * sw[g0:g0 + gb])
    return acc


def _rns_forward(x, w, policy, draws):
    k = policy.k
    moduli = policy.moduli
    if isinstance(w, stationary.StationaryResidues):
        # program-once dataflow: only the streamed operand converts
        w.check_matches(policy, moduli, x.shape[-1])
        qx, sx, batch = grouped.prepare_activations(x, policy)
        wr, sw = w.residues, w.scale
    else:
        qx, sx, qw, sw, batch = grouped.prepare_operands(x, w, policy)
        wr = rns.to_rns_special(qw, k)             # (n_mod, G, g, N) int32
    G, M, _ = qx.shape
    N = wr.shape[-1]
    xr = rns.to_rns_special(qx, k)                 # (n_mod, G, M, g) int32
    noisy = policy.noise_sigma > 0
    if noisy and draws is None:
        raise ValueError(
            "policy.noise_sigma > 0 requires draws: call "
            "mirage_matmul_nograd(x, w, policy, draws=...) or open "
            "gemm.noise_scope")
    gb = policy.group_block
    if x.is_cuda:
        from repro_torch.kernels import ops as kops
        residue_op = kops.rns_group_matmul
        if gb == 0:
            gb = card_group_block(len(moduli), G, M, N)
    else:
        residue_op = grouped.residue_dots
        if gb == 0:
            single = len(moduli) * G * M * N * 4 <= \
                grouped.VECTORIZE_BUDGET_BYTES
            gb = -1 if single else grouped.DEFAULT_GROUP_BLOCK
    if 0 < gb < G and not noisy:
        return _rns_blocked(xr, wr, sx, sw, policy, gb,
                            residue_op).reshape(batch + (N,))
    res = residue_op(xr, wr, moduli)               # (n_mod, G, M, N)
    if noisy:
        res = noise.inject_phase_noise(res, moduli, policy.noise_sigma, draws)
    p = rns.from_rns_special(res, k).to(torch.float32)
    return grouped.scale_accumulate(p, sx, sw, batch)


@register_fn("mirage_rns",
             description="group-batched RNS path: residue GEMMs + CRT",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True)
def _matmul_mirage_rns(x, w, policy, *, draws=None):
    return _rns_forward(x, w, policy, draws)


@register_fn("mirage_rns_pallas",
             description="mirage_rns through the residue kernel (the port "
                         "routes by device, so it is mirage_rns)",
             supports_noise=True,
             supports_stationary_residues=True,
             supports_weight_stationary=True,
             weight_stationary_aligned_only=True)
def _matmul_mirage_rns_pallas(x, w, policy, *, draws=None):
    return _rns_forward(x, w, policy, draws)
