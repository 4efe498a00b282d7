"""Block Floating Point (BFP) quantization (port of ``repro.core.bfp``).

Groups of ``g`` consecutive elements along the contraction dimension share one
exponent; each element keeps a signed mantissa of ``b_m`` magnitude bits.
Values are stored as ``q * 2^(E - (b_m - 1))`` where ``E = floor(log2 max|x|)``
over the group and ``q`` is an integer in ``[-(2^b_m - 1), 2^b_m - 1]``.

Exponents come from the f32 bit field and scales are built in it, so every
function here is bit-exact against the JAX package on normal inputs. One
difference is the host's, not the port's: XLA on the CPU flushes subnormal
inputs to zero, while PyTorch (and the CUDA kernels, built without fast
math) keep IEEE gradual underflow. A group whose result depends on a
subnormal therefore matches an exact IEEE oracle, not the JAX CPU run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_TINY = torch.finfo(torch.float32).tiny


class BFPTensor(NamedTuple):
    """Quantized representation of a tensor grouped along its last axis.

    mantissa: integer-valued f32 tensor, shape (..., G, g).
    scale:    power-of-two f32 tensor, shape (..., G, 1) — equals 2^(E - b_m + 1).
    orig_k:   original length of the contraction axis (pre-padding).
    """

    mantissa: torch.Tensor
    scale: torch.Tensor
    orig_k: int


def _group_reshape(x: torch.Tensor, g: int) -> Tuple[torch.Tensor, int]:
    """Pad the last axis to a multiple of g and reshape to (..., G, g)."""
    k = x.shape[-1]
    pad = (-k) % g
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + ((k + pad) // g, g)), k


def _exponent_bits(maxabs: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) via f32 exponent-field extraction; zero groups get 0.

    Subnormals are clamped to the smallest normal first (the JAX package's
    ``tiny`` clamp, ``repro/core/bfp.py:58``)."""
    m = torch.clamp_min(maxabs.to(torch.float32), _TINY)
    e = ((m.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.where(maxabs > 0, e, torch.zeros_like(e))


def _exp2_exact(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for integer e, by constructing the f32 exponent field."""
    e = torch.clamp(e, -126, 127).to(torch.int32)
    return ((e + 127) << 23).view(torch.float32)


def _round(v: torch.Tensor, rounding: str,
           uniform: Optional[torch.Tensor]) -> torch.Tensor:
    if rounding == "nearest":
        return torch.round(v)  # round-half-to-even, as jnp.round
    if rounding == "truncate":
        return torch.trunc(v)  # toward zero: hardware LSB truncation
    if rounding == "stochastic":
        # training only: the caller injects the uniform draw (torch
        # generators cannot reproduce the reference's threefry bits)
        if uniform is None:
            raise ValueError("stochastic rounding requires an injected "
                             "uniform draw of the mantissa's shape")
        return torch.floor(v + uniform.reshape(v.shape))
    raise ValueError(f"unknown rounding mode {rounding!r}")


def bfp_quantize(x: torch.Tensor, b_m: int, g: int,
                 rounding: str = "nearest",
                 uniform: Optional[torch.Tensor] = None) -> BFPTensor:
    """Quantize ``x`` along its last axis into BFP(b_m, g).

    Mantissas are integer-valued float32 (exact for b_m <= 23). ``uniform``
    is the [0, 1) draw stochastic rounding adds, shaped like the padded
    mantissa ``(..., G, g)``.
    """
    xg, orig_k = _group_reshape(x.to(torch.float32), g)
    maxabs = torch.amax(torch.abs(xg), dim=-1, keepdim=True)
    scale = _exp2_exact(_exponent_bits(maxabs) - (b_m - 1))
    qmax = float(2**b_m - 1)
    q = torch.clamp(_round(xg / scale, rounding, uniform), -qmax, qmax)
    return BFPTensor(mantissa=q, scale=scale, orig_k=orig_k)


def bfp_dequantize(t: BFPTensor) -> torch.Tensor:
    """Reconstruct the (quantized) values, shape (..., K) with padding removed."""
    xg = t.mantissa * t.scale
    flat = xg.reshape(xg.shape[:-2] + (xg.shape[-2] * xg.shape[-1],))
    return flat[..., : t.orig_k]


def _contract_groups(w: torch.Tensor, g: int) -> torch.Tensor:
    """``w (..., K, N)`` in f32, K padded to a multiple of g and split into
    ``(..., G, g, N)``."""
    w = w.to(torch.float32)
    K, N = w.shape[-2:]
    pad = (-K) % g
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return w.reshape(w.shape[:-2] + ((K + pad) // g, g, N))


def _group_maxabs(wg: torch.Tensor) -> torch.Tensor:
    """max |w| over each group of ``wg (..., G, g, N)`` -> ``(..., G, 1,
    N)``, exact, with no |w| temporary (the weight side of an expert stack
    is encoded per call): on the card the inf-norm in one pass; on the CPU,
    whose inf-norm over a middle axis runs far slower, the larger of the
    group's max and minus its min (the same value)."""
    if wg.is_cuda:
        return torch.linalg.vector_norm(wg, ord=float("inf"), dim=-2,
                                        keepdim=True)
    return torch.maximum(wg.amax(dim=-2, keepdim=True),
                         -wg.amin(dim=-2, keepdim=True))


def bfp_quantize_contract(w: torch.Tensor, b_m: int, g: int,
                          rounding: str = "nearest",
                          uniform: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a weight operand ``w: (K, N)`` grouped along K (axis -2).

    Transpose-free equivalent of ``bfp_quantize(w.T, ...)`` with mantissa and
    scale transposed back: returns ``(mantissa (G, g, N), scale (G, 1, N))``,
    bit-identical values. A stack ``(E, K, N)`` gives ``(E, G, g, N)`` and
    ``(E, G, 1, N)``, each expert's own grouping.
    """
    wg = _contract_groups(w, g)
    scale = _exp2_exact(_exponent_bits(_group_maxabs(wg)) - (b_m - 1))
    qmax = float(2**b_m - 1)
    q = torch.clamp(_round(wg / scale, rounding, uniform), -qmax, qmax)
    return q, scale


def bfp_decompose_contract(w: torch.Tensor, b_m: int, g: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (mantissa, scale) of an ALREADY on-grid ``(K, N)`` weight (the
    weight-stationary contract): the group max re-derives the exponent and
    ``w / scale`` recovers the integer mantissas, with no round or clip.
    Bit-identical to :func:`bfp_quantize_contract` for on-grid inputs."""
    wg = _contract_groups(w, g)
    scale = _exp2_exact(_exponent_bits(_group_maxabs(wg)) - (b_m - 1))
    return wg * (1.0 / scale), scale


def bfp_fake_quant(x: torch.Tensor, b_m: int, g: int,
                   rounding: str = "nearest",
                   uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize-dequantize in one shot ("fake quantization")."""
    return bfp_dequantize(bfp_quantize(x, b_m, g, rounding, uniform))
