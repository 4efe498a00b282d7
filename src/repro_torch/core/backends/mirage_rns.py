"""mirage_rns: the full hardware path, group-batched (port of
``repro.core.backends.mirage_rns``).

Forward conversion to the special moduli set -> per-modulus modular GEMM
over all groups at once -> (optional) phase noise on the residue readout ->
CRT reverse conversion -> FP32 scale-accumulate.

The port has no ``use_pallas``: the operand's device picks the route. On
the card both ``mirage_rns`` and ``mirage_rns_pallas`` launch the residue
kernel (``csrc/rns_matmul.cu``) on the full ``(n_mod, G, M, N)`` tensor, as
the JAX Pallas route does. On the CPU both take the plain path with the JAX
package's regimes: one batched product while the residue stack fits
:data:`grouped.VECTORIZE_BUDGET_BYTES`, else a loop over group blocks that
runs the whole pipeline per block, so CPU memory stays bounded.

``policy.noise_sigma > 0`` injects phase noise on the residue outputs and
needs draws: explicit, or the engine's :func:`repro_torch.core.gemm.noise_scope`.
"""

from __future__ import annotations

import torch

from repro_torch.core import noise, rns, stationary
from repro_torch.core.backends import grouped
from repro_torch.core.backends.base import register_fn


def _rns_blocked(xr, wr, sx, sw, policy, gb):
    """Group blocks of ``gb``, each through residue dots -> CRT ->
    scale-accumulate, so the intermediate is bounded at (gb, M, N)."""
    nm, G, M, g = xr.shape
    N = wr.shape[-1]
    acc = torch.zeros((M, N), dtype=torch.float32, device=xr.device)
    for g0 in range(0, G, gb):
        # a ragged last block equals the JAX package's zero-padded one:
        # zero groups add exactly 0.0
        res = grouped.residue_dots(xr[:, g0:g0 + gb], wr[:, g0:g0 + gb],
                                   policy.moduli)
        p = rns.from_rns_special(res, policy.k).to(torch.float32)
        acc = acc + torch.sum(p * sx[g0:g0 + gb] * sw[g0:g0 + gb], dim=0)
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
    if x.is_cuda:
        from repro_torch.kernels import ops as kops
        res = kops.rns_group_matmul(xr, wr, moduli)
    else:
        gb = policy.group_block
        if gb == 0:
            single = len(moduli) * G * M * N * 4 <= \
                grouped.VECTORIZE_BUDGET_BYTES
            gb = -1 if single else grouped.DEFAULT_GROUP_BLOCK
        if 0 < gb < G and not noisy:
            return _rns_blocked(xr, wr, sx, sw, policy, gb).reshape(
                batch + (N,))
        res = grouped.residue_dots(xr, wr, moduli)  # (n_mod, G, M, N)
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
