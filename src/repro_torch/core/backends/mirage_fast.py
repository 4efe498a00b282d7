"""mirage_fast: BFP-quantize, fold scales into mantissas, one matmul.

Port of ``repro.core.backends.mirage_fast``. Where the JAX backend takes the
fused Pallas kernel under ``policy.use_pallas``, the port takes the fused
CUDA kernel whenever the activations lie on the card. The kernel quantizes
the weight along the contraction unless ``policy.assume_quantized_weights``
says it already lies on its grid; then it takes the weight as it is, as
the plain path does (the weight-stationary dX GEMM reads a weight gridded
along the forward K transposed, and regrouping it along N would change
it). A weight stored in bf16 (``quant_param_dtype="bfloat16"``) is cast to
f32 here, before the kernel, which reads f32 only: BFP(b_m <= 8) values
are exact in bf16, so the cast is lossless. The CPU path is the JAX
package's plain path, ``assume_quantized_weights`` branch included.

A stacked weight ``(E, K, N)`` with ``x (E, M, K)`` (the MoE layer's expert
GEMMs, which the JAX package runs as a vmap of this backend) is one launch
of the kernel over the stack on the card, and the plain path applied to
each expert on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core import bfp
from repro_torch.core.backends.base import register_fn


def _fold_x(x, policy):
    """Quantize-and-fold activations along the contraction dim -> (..., Kpad)."""
    t = bfp.bfp_quantize(x, policy.b_m, policy.g, policy.rounding)
    xg = t.mantissa * t.scale
    return xg.reshape(xg.shape[:-2] + (xg.shape[-2] * xg.shape[-1],))


@register_fn("mirage_fast",
             description="BFP quantize -> fold scales -> one matmul",
             supports_weight_stationary=True,
             supports_batched_weights=True)
def _matmul_mirage_fast(x, w, policy):
    if x.is_cuda:
        from repro_torch.kernels import ops as kops
        return kops.mirage_matmul_fused(
            x, w.to(torch.float32), policy,
            quantize_w=not policy.assume_quantized_weights)
    if w.dim() == 3:
        return torch.stack([_matmul_mirage_fast(xe, we, policy)
                            for xe, we in zip(x, w)])
    xq = _fold_x(x, policy)                    # (..., Kpad)
    if policy.assume_quantized_weights:
        # weight operand already on the BFP grid (weight-stationary quant)
        wq = w.to(torch.float32)
        if xq.shape[-1] != w.shape[0]:         # padding from x grouping
            wq = torch.nn.functional.pad(
                wq, (0, 0, 0, xq.shape[-1] - w.shape[0]))
    else:
        qw, sw = bfp.bfp_quantize_contract(w, policy.b_m, policy.g,
                                           policy.rounding)
        wq = (qw * sw).reshape(-1, w.shape[-1])  # (Kpad, N)
        if wq.shape[0] != xq.shape[-1]:
            wq = wq[: xq.shape[-1]]
    if policy.compute_dtype == "bfloat16":
        # BFP(b_m <= 6) values are exact in bf16: the cast is value-identical
        xq = xq.to(torch.bfloat16).to(torch.float32)
        wq = wq.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xq, wq)
