"""Shared machinery of the group-batched RNS backends (port of
``repro.core.backends.grouped``).

A K-contraction decomposes into ``G = K/g`` independent g-wide integer
group dots followed by an FP32 scale-accumulate (paper Section III-A steps
2-9). The group axis is the batch axis of one batched product.

Layouts (group-major):

  qx : (G, M, g)   activation mantissas, M = prod(batch dims)
  qw : (G, g, N)   weight mantissas
  sx : (G, M, 1)   activation group scales (powers of two)
  sw : (G, 1, N)   weight group scales (powers of two)

The plain residue path here is what a CPU tensor takes; on the card the
backends launch the residue kernel on the whole ``(n_mod, G, M, N)``
tensor instead. ``grouped_dot`` (the ``mirage_faithful`` contraction) waits
with that backend.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bfp

# (n_mod, G, M, N) f32 intermediates up to this size run as ONE batched
# product on the CPU; beyond it the backends walk blocks of
# DEFAULT_GROUP_BLOCK groups, so CPU memory stays bounded (the JAX
# package's defaults, without its environment overrides)
VECTORIZE_BUDGET_BYTES = 32 * 1024 * 1024
DEFAULT_GROUP_BLOCK = 8

# f32 holds integers exactly up to 2^24: cap on any integer partial dot
F32_EXACT_WINDOW = 1 << 24


def prepare_activations(x: torch.Tensor, policy
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Tuple[int, ...]]:
    """BFP-quantize the activation operand into group-major layout.

    Returns ``(qx (G, M, g), sx (G, M, 1), batch)``."""
    batch = tuple(x.shape[:-1])
    t = bfp.bfp_quantize(x, policy.b_m, policy.g, policy.rounding)
    G, g = t.mantissa.shape[-2], t.mantissa.shape[-1]
    M = 1
    for d in batch:
        M *= d
    qx = t.mantissa.reshape(M, G, g).transpose(0, 1)
    sx = t.scale.reshape(M, G, 1).transpose(0, 1)
    return qx, sx, batch


def prepare_operands(x: torch.Tensor, w: torch.Tensor, policy):
    """BFP-quantize both operands into group-major layout.

    Returns ``(qx, sx, qw, sw, batch)``. Under
    ``policy.assume_quantized_weights`` the weight side takes the exact
    decomposition (bit-identical for on-grid weights)."""
    qx, sx, batch = prepare_activations(x, policy)
    if policy.assume_quantized_weights:
        qw, sw = bfp.bfp_decompose_contract(w, policy.b_m, policy.g)
    else:
        qw, sw = bfp.bfp_quantize_contract(w, policy.b_m, policy.g,
                                           policy.rounding)
    return qx, sx, qw, sw, batch


def exact_mod(a: torch.Tensor, m: int) -> torch.Tensor:
    """``a mod m`` for integer-valued f32 ``a`` in [0, 2^24), exact:
    ``a - floor(a * (1/m)) * m`` with the quotient's possible off-by-one
    from the rounded reciprocal corrected by two selects."""
    mf = float(m)
    q = torch.floor(a * (1.0 / mf))
    r = a - q * mf
    r = torch.where(r < 0, r + mf, r)
    return torch.where(r >= mf, r - mf, r)


def grouped_residue_dot(xr: torch.Tensor, wr: torch.Tensor,
                        m: int) -> torch.Tensor:
    """Per-group modular dot for one modulus: (G, M, g) x (G, g, N) ->
    (G, M, N) f32 residues.

    The exact group dot is bounded by ``g * (m-1)^2``; past the f32 window
    the g axis is split into sub-chunks reduced mod m before combining."""
    g = xr.shape[-1]
    xf, wf = xr.to(torch.float32), wr.to(torch.float32)
    cap = max(1, (F32_EXACT_WINDOW - 1) // max(1, (m - 1) ** 2))
    if g <= cap:
        return exact_mod(torch.bmm(xf, wf), m)
    acc = None
    for k0 in range(0, g, cap):
        part = exact_mod(torch.bmm(xf[:, :, k0:k0 + cap],
                                   wf[:, k0:k0 + cap, :]), m)
        acc = part if acc is None else acc + part
    return exact_mod(acc, m)


def residue_dots(xr: torch.Tensor, wr: torch.Tensor,
                 moduli) -> torch.Tensor:
    """Every modulus's group dots: (n_mod, G, M, g) x (n_mod, G, g, N) ->
    (n_mod, G, M, N) int32 residues."""
    return torch.stack([grouped_residue_dot(xr[i], wr[i], m)
                        for i, m in enumerate(moduli)],
                       dim=0).to(torch.int32)


def scale_accumulate(p: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                     batch: Tuple[int, ...]) -> torch.Tensor:
    """sum_G of p * sx * sw: (G, M, N) -> batch + (N,). The multiplies are
    exact (power-of-two scales); only the cross-group sum rounds."""
    N = p.shape[-1]
    return torch.sum(p * sx * sw, dim=0).reshape(batch + (N,))
