"""BFP gradient compression with error feedback (port of
``repro.optim.grad_compress``).

The paper's own numerics as a wire format for data-parallel gradient
reduction: gradients are BFP-quantized (shared-exponent groups, b_m
mantissa bits) along their last axis before the all-reduce; error feedback
(Karimireddy et al. 2019) keeps the quantization residual locally so the
compression bias vanishes over steps. Value-level simulation: quantize and
dequantize. On the card every leaf goes through the hand-written BFP
quantizer (:func:`repro_torch.kernels.ops.bfp_fake_quant`, kernel #2), one
launch per non-scalar leaf; on the CPU through its plain version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.precision import MiragePolicy
from repro_torch.kernels import ops

Tree = Dict[str, torch.Tensor]


def _quantizer(b_m: int, g: int) -> MiragePolicy:
    """The quantizer reads b_m, g and the rounding of a policy; the fp32
    mode carries them without the RNS range check of the mirage modes."""
    return MiragePolicy(mode="fp32", b_m=b_m, g=g)


@torch.no_grad()
def compress_with_error_feedback(grads: Tree, error_buf: Tree,
                                 b_m: int = 4, g: int = 16
                                 ) -> Tuple[Tree, Tree]:
    """Returns (quantized grads to reduce, new error buffer)."""
    q = _quantizer(b_m, g)
    qs, es = {}, {}
    for k, gr in grads.items():
        if gr.dim() == 0:
            qs[k], es[k] = gr, error_buf[k]
            continue
        corrected = (gr.to(torch.float32) + error_buf[k]).contiguous()
        qs[k] = ops.bfp_fake_quant(corrected, q)
        es[k] = corrected - qs[k]
    return qs, es


def init_error_buffer(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}

