"""The seed's sequential GEMM implementations, kept as reference backends
(port of ``repro.core.backends.reference``).

The faithful and RNS paths as the seed wrote them: a loop over the groups,
the weight quantized through its transpose, one group's integer dot (and,
for RNS, its residue conversion, per-modulus modular GEMM and CRT) at a
time, accumulated in f32 in group order. They are bit-exactness oracles
for the group-batched backends, not deployment paths.
"""

from __future__ import annotations

import torch

from repro_torch.core import bfp, rns
from repro_torch.core.backends.base import register_fn


def _per_group_operands(x, w, policy):
    """Seed operand prep: (qx (..., G, g), sx (..., G, 1), qw (G, g, N),
    sw (G, 1, N)), the weight quantized as w.T and transposed back."""
    qxt = bfp.bfp_quantize(x, policy.b_m, policy.g, policy.rounding)
    qwt = bfp.bfp_quantize(w.T, policy.b_m, policy.g, policy.rounding)
    qw = qwt.mantissa.permute(1, 2, 0)   # (N, G, g) -> (G, g, N)
    sw = qwt.scale.permute(1, 2, 0)      # (N, G, 1) -> (G, 1, N)
    return qxt.mantissa, qxt.scale, qw, sw


def _group_loop(x, w, policy, group_dot):
    """sum over groups j, in order, of group_dot(qx_j, qw_j) * sx_j * sw_j;
    an expert stack one expert at a time."""
    if w.dim() == 3:
        return torch.stack([_group_loop(x[e], w[e], policy, group_dot)
                            for e in range(w.shape[0])])
    qx, sx, qw, sw = _per_group_operands(x, w, policy)
    acc = torch.zeros(x.shape[:-1] + (qw.shape[-1],), dtype=torch.float32,
                      device=x.device)
    for j in range(qx.shape[-2]):
        p = group_dot(qx[..., j, :], qw[j])
        acc = acc + p * sx[..., j, :] * sw[j][0]
    return acc


@register_fn("mirage_faithful_ref",
             description="seed group-loop faithful path (parity oracle)",
             supports_batched_weights=True, reference=True)
def _matmul_mirage_faithful_ref(x, w, policy):
    # one group's integer dot is exact: |.| <= g * qmax^2 <= psi
    return _group_loop(x, w, policy, torch.matmul)


@register_fn("mirage_rns_ref",
             description="seed group-loop RNS path (parity oracle)",
             supports_batched_weights=True, reference=True)
def _matmul_mirage_rns_ref(x, w, policy):
    k = policy.k
    moduli = policy.moduli

    def rns_group_dot(qxj, qwj):
        xr = rns.to_rns_special(qxj, k)            # (3, ..., g)
        wr = rns.to_rns_special(qwj, k)            # (3, g, N)
        res = torch.stack([rns.mod_matmul(xr[i], wr[i], m)
                           for i, m in enumerate(moduli)],
                          dim=0).to(torch.int32)
        return rns.from_rns_special(res, k).to(torch.float32)

    return _group_loop(x, w, policy, rns_group_dot)
