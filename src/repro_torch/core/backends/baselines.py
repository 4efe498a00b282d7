"""Baseline GEMM backends the paper compares against (Table III).

These are plain matrix products outside any kernel of the port: on the card
they are ``torch.matmul``, as the JAX package left them to XLA.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends.base import register_fn


def _pin_full_f32() -> None:
    """The FP32 baseline means full f32: keep TF32 off for matmuls and for
    cuDNN (whose default is TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@register_fn("fp32", description="plain f32 matmul (paper FP32 baseline)",
             quantized=False, supports_batched_weights=True)
def _matmul_fp32(x, w, policy):
    _pin_full_f32()
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


@register_fn("bf16", description="bfloat16 matmul, f32 accumulation",
             quantized=False, supports_batched_weights=True)
def _matmul_bf16(x, w, policy):
    # bf16 operands, f32 accumulation: bf16 x bf16 products are exact in
    # f32, so rounding the operands and multiplying in full f32 is the same
    # function (a bf16 matmul would round its OUTPUT to bf16 as well)
    _pin_full_f32()
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.bfloat16).to(torch.float32))


@register_fn("int8", description="per-tensor symmetric int8 systolic baseline",
             supports_batched_weights=True)
def _matmul_int8(x, w, policy):
    _pin_full_f32()
    # one scale per tensor; over an expert stack one per expert, as the
    # JAX package's vmap of its per-tensor scale gives
    dims = (-2, -1) if w.dim() == 3 else tuple(range(x.dim()))
    sx = torch.clamp_min(torch.amax(torch.abs(x), dim=dims, keepdim=True),
                         1e-30) / 127.0
    sw = torch.clamp_min(torch.amax(torch.abs(w), dim=(-2, -1),
                                    keepdim=True), 1e-30) / 127.0
    if w.dim() == 2:
        sx, sw = sx.reshape(()), sw.reshape(())
    qx = torch.clamp(torch.round(x / sx), -127, 127)
    qw = torch.clamp(torch.round(w / sw), -127, 127)
    return torch.matmul(qx, qw) * (sx * sw)
