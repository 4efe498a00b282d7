"""Public wrappers of the hand-written kernels (port of ``repro.kernels.ops``).

The operands' device decides the route. CPU tensors take the kernel's plain
PyTorch version (:mod:`repro_torch.kernels.ref`); CUDA tensors launch the
kernel or raise. There is no fallback from the card to a plain version.

Each wrapper checks device, dtype, shape and contiguity, reshapes leading
dims away, allocates the output, and adds one to its entry of
:data:`LAUNCHES` where it launches. The TPU wrappers' padding to block
multiples is done inside the kernels, whose edge tiles load zeros.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.precision import MiragePolicy
from repro_torch.kernels import ref
from repro_torch.kernels.build import extension

#: launches per kernel since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"bfp_quantize": 0, "mirage_gemm": 0,
                            "flash_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU operands, False for all-CUDA ones; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    devices = {t.device for t in tensors}
    if kinds != {"cuda"} or len(devices) != 1:
        raise ValueError(f"operands must all lie on the CPU or all on one "
                         f"CUDA device, got {sorted(map(str, devices))}")
    return False


def _check_cuda_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")


def _truncate(rounding: str) -> bool:
    if rounding == "nearest":
        return False
    if rounding == "truncate":
        return True
    raise ValueError(f"the BFP kernels round 'nearest' or 'truncate', got "
                     f"{rounding!r} (stochastic rounding is training-only)")


def bfp_fake_quant(x: torch.Tensor, policy: MiragePolicy) -> torch.Tensor:
    """BFP(b_m, g) fake quantization along the last axis (any rank)."""
    if _on_cpu(x):
        return ref.bfp_fake_quant_ref(x, policy.b_m, policy.g,
                                      policy.rounding)
    _check_cuda_operand(x, "x")
    truncate = _truncate(policy.rounding)
    xf = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(xf)
    if xf.numel():
        extension().bfp_fake_quant(xf, out, policy.g, policy.b_m, truncate)
        LAUNCHES["bfp_quantize"] += 1
    return out.reshape(x.shape)


def mirage_matmul_fused(x: torch.Tensor, w: torch.Tensor,
                        policy: MiragePolicy) -> torch.Tensor:
    """Fused BFP-quantize + GEMM: ``x (..., K) @ w (K, N)`` (paper dataflow
    steps 2-9 in one kernel).

    On the card ``w`` may be a contiguous ``(K, N)`` matrix or the transpose
    of a contiguous ``(N, K)`` one (the tied head passes ``emb.T``); the
    kernel reads either in place. ``compute_dtype`` does not change the
    kernel: BFP(b_m <= 6) products are exact in f32 as in bf16.
    """
    if _on_cpu(x, w):
        return ref.mirage_gemm_ref(x, w, policy.b_m, policy.g,
                                   policy.rounding, policy.compute_dtype)
    _check_cuda_operand(x, "x")
    if w.dim() != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} along K")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32 for the CUDA kernel, got {w.dtype}")
    if w.is_contiguous():
        w_nk, wk = False, w
    elif w.t().is_contiguous():
        w_nk, wk = True, w.t()
    else:
        raise ValueError("w must be a contiguous (K, N) matrix or the "
                         "transpose of a contiguous (N, K) one")
    truncate = _truncate(policy.rounding)
    K, N = w.shape
    xf = x.reshape(-1, K)
    out = torch.empty((xf.shape[0], N), dtype=torch.float32, device=x.device)
    if out.numel():
        extension().mirage_gemm(xf, wk, out, w_nk, policy.g, policy.b_m,
                                 truncate)
        LAUNCHES["mirage_gemm"] += 1
    return out.reshape(x.shape[:-1] + (N,))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA flash attention over a full sequence at positions 0..L-1.

    q: (B, Lq, H, D) with rope applied; k/v: (B, S, Kv, D). Query head h
    reads kv head h // (H // Kv). Returns (B, Lq, H, D)."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal, window)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_cuda_operand(t, name)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q must be (B, Lq, H, D) and k/v (B, S, Kv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H, D, Kv = q.shape[2], q.shape[3], k.shape[2]
    if H % Kv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Kv}")
    if D != 64:
        raise ValueError(f"the flash kernel is built for head_dim 64, got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    out = torch.empty_like(q)
    if out.numel():
        extension().flash_attention(q, k, v, out, causal,
                                     -1 if window is None else window,
                                     1.0 / math.sqrt(D))
        LAUNCHES["flash_attention"] += 1
    return out
