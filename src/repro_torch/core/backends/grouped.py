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
RNS backends launch the residue kernel instead. :func:`grouped_dot`, the
``mirage_faithful`` contraction, is a batched ``torch.matmul`` on both (the
JAX package leaves it to XLA, outside any Pallas kernel): with the
power-of-two scales folded into the mantissas first, every group dot is
exact, and only the cross-group sum rounds.
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


def is_stack(w) -> bool:
    """True for a stack of expert weights: an ``(E, K, N)`` tensor, or
    stationary residues programmed from one (``(n_mod, E, G, g, N)``)."""
    if isinstance(w, torch.Tensor):
        return w.dim() == 3
    return w.residues.dim() == 5


def prepare_activations(x: torch.Tensor, policy, stack: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Tuple[int, ...]]:
    """BFP-quantize the activation operand into group-major layout.

    Returns ``(qx (G, M, g), sx (G, M, 1), batch)``. With ``stack``, ``x``
    is an expert stack ``(E, C, K)``: ``qx (E, G, C, g)``, ``sx (E, G, C,
    1)``, each expert grouped as the JAX package's vmap groups it."""
    batch = tuple(x.shape[:-1])
    t = bfp.bfp_quantize(x, policy.b_m, policy.g, policy.rounding)
    G, g = t.mantissa.shape[-2], t.mantissa.shape[-1]
    lead = batch[:1] if stack else ()
    M = 1
    for d in batch[len(lead):]:
        M *= d
    qx = t.mantissa.reshape(lead + (M, G, g)).transpose(-3, -2)
    sx = t.scale.reshape(lead + (M, G, 1)).transpose(-3, -2)
    return qx, sx, batch


def prepare_operands(x: torch.Tensor, w: torch.Tensor, policy):
    """BFP-quantize both operands into group-major layout.

    Returns ``(qx, sx, qw, sw, batch)``; an expert stack ``w (E, K, N)``
    with ``x (E, C, K)`` gives each a leading E axis. Under
    ``policy.assume_quantized_weights`` the weight side takes the exact
    decomposition (bit-identical for on-grid weights)."""
    qx, sx, batch = prepare_activations(x, policy, stack=w.dim() == 3)
    if policy.assume_quantized_weights:
        qw, sw = bfp.bfp_decompose_contract(w, policy.b_m, policy.g)
    else:
        qw, sw = bfp.bfp_quantize_contract(w, policy.b_m, policy.g,
                                           policy.rounding)
    return qx, sx, qw, sw, batch


#: group counts up to this are summed left to right, one group at a time:
#: XLA's order for a sum over the group axis on the CPU, so the group-dot
#: and RNS paths equal the JAX package's bit for bit there (``torch.sum``
#: orders its own sum from 5 groups on). Beyond it the port takes
#: ``torch.sum`` (every full-width GEMM of qwen2-0.5b has 56 or more
#: groups).
SEQUENTIAL_SUM_GROUPS = 32


def sum_groups(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t (..., G, M, N)`` over its group axis."""
    G = t.shape[-3]
    if G > SEQUENTIAL_SUM_GROUPS:
        return torch.sum(t, dim=-3)
    acc = t[..., 0, :, :]
    for i in range(1, G):
        acc = acc + t[..., i, :, :]
    return acc


def vectorized(n_groups: int, M: int, N: int, n_mod: int = 1) -> bool:
    """The CPU regime of one expert's (or one 2-D GEMM's) group dots: one
    batched product while its ``(n_mod, G, M, N)`` f32 intermediate fits
    :data:`VECTORIZE_BUDGET_BYTES`. An expert stack decides per expert, as
    the JAX package's vmap sees one expert's shapes."""
    return n_mod * n_groups * M * N * 4 <= VECTORIZE_BUDGET_BYTES


def _group_dots(xv: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """(..., G, M, g) x (..., G, g, N) -> (..., G, M, N), one batched
    product over every (expert, group) slot."""
    lead, (M, g), N = xv.shape[:-2], xv.shape[-2:], wv.shape[-1]
    return torch.bmm(xv.reshape(-1, M, g),
                     wv.reshape(-1, g, N)).reshape(lead + (M, N))


def grouped_dot(xv: torch.Tensor, wv: torch.Tensor,
                group_block: int = 0) -> torch.Tensor:
    """Scale-accumulated sum of per-group dots: (G, M, g) x (G, g, N) ->
    (M, N), or over an expert stack (E, G, M, g) x (E, G, g, N) -> (E, M,
    N), each expert summing its own groups.

    group_block: 0 = adaptive (one batched product inside
    :data:`VECTORIZE_BUDGET_BYTES`, blocks of :data:`DEFAULT_GROUP_BLOCK`
    groups beyond it, decided on one expert's sizes); -1 = one batched
    product; n > 0 = blocks of n groups, each summed, then added to the
    running sum in block order (the JAX package's scan; its zero-padded
    last block adds exact zeros)."""
    G, M, _ = xv.shape[-3:]
    N = wv.shape[-1]
    if group_block == 0:
        gb = -1 if vectorized(G, M, N) else DEFAULT_GROUP_BLOCK
    else:
        gb = group_block
    if gb < 0 or gb >= G:
        return sum_groups(_group_dots(xv, wv))
    acc = torch.zeros(xv.shape[:-3] + (M, N), dtype=torch.float32,
                      device=xv.device)
    for g0 in range(0, G, gb):
        acc = acc + sum_groups(_group_dots(xv[..., g0:g0 + gb, :, :],
                                           wv[..., g0:g0 + gb, :, :]))
    return acc


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
    """sum_G of p * sx * sw: (G, M, N) -> batch + (N,), or (E, G, M, N) ->
    (E, C, N) over an expert stack. The multiplies are exact (power-of-two
    scales); only the cross-group sum rounds."""
    N = p.shape[-1]
    return sum_groups(p * sx * sw).reshape(batch + (N,))
