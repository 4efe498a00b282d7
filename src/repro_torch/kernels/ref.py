"""Plain PyTorch versions of the hand-written kernels.

Port of ``repro.kernels.ref`` and the plain versions of the residue kernels;
flash attention's plain version is the model's own
:func:`repro_torch.models.attention.chunked_attention`.
A CPU tensor reaching a wrapper in :mod:`repro_torch.kernels.ops` runs these;
on the card ``chip_smoke.py`` holds each kernel against them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analog import rrns
from repro_torch.analog.channel import adc_step
from repro_torch.core import bfp


def bfp_fake_quant_ref(x: torch.Tensor, b_m: int = 4, g: int = 16,
                       rounding: str = "nearest") -> torch.Tensor:
    """Plain version of ``csrc/bfp_quantize.cu``."""
    return bfp.bfp_fake_quant(x.to(torch.float32), b_m, g, rounding)


def mirage_gemm_ref(x: torch.Tensor, w: torch.Tensor, b_m: int = 4,
                    g: int = 16, rounding: str = "nearest",
                    compute_dtype: str = "float32",
                    quantize_w: bool = True) -> torch.Tensor:
    """Plain version of ``csrc/mirage_gemm.cu``: quantize both operands along
    K (the weight only where ``quantize_w``; else it is taken as it is),
    fold scales, one f32-accumulated matmul. A stacked ``w (E, K, N)``
    with ``x (E, M, K)`` gives ``(E, M, N)``, one product per expert."""
    xq = bfp.bfp_fake_quant(x.to(torch.float32), b_m, g, rounding)
    wq = w.to(torch.float32)
    if quantize_w:
        wq = bfp.bfp_fake_quant(wq.transpose(-1, -2), b_m, g,
                                rounding).transpose(-1, -2)
    if compute_dtype == "bfloat16":
        # BFP(b_m <= 6) values are exact in bf16: the cast is value-identical
        xq = xq.to(torch.bfloat16).to(torch.float32)
        wq = wq.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xq, wq)


def stream_prep_ref(x: torch.Tensor, b_m: int, g: int, rounding: str,
                    splits: int, k_split: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the stream route's pre-pass
    (``csrc/mirage_gemm_stack.cu`` ``stream_prep_kernel``): x (E, M, K)
    quantized along K into the k-major ``xq`` (E, Kp, MT), Kp = K rounded
    up to 64 and MT = 4, 8 or 16 >= M, zero past M and K; and ``live``
    (E * splits,) int32, 1 where a quantized value of split s (rows
    [s k_split, (s + 1) k_split)) of expert e is nonzero, at e * splits + s.
    """
    E, M, K = x.shape
    mt = 4 if M <= 4 else 8 if M <= 8 else 16
    kp = -(-K // 64) * 64
    q = bfp.bfp_fake_quant(x.to(torch.float32), b_m, g, rounding)
    xq = torch.zeros((E, kp, mt), dtype=torch.float32, device=x.device)
    xq[:, :K, :M] = q.transpose(1, 2)
    nonzero = (xq != 0).any(dim=2)                              # (E, Kp)
    live = torch.stack([nonzero[:, s * k_split:(s + 1) * k_split].any(dim=1)
                        for s in range(splits)], dim=1)
    return xq, live.reshape(-1).to(torch.int32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``csrc/flash_attention.cu``: full-sequence
    self-attention at contiguous positions from 0, as the kernel assumes.
    ``sm_scale`` defaults to 1/sqrt(D)."""
    from repro_torch.models.attention import chunked_attention

    Lq, Sk = q.shape[1], k.shape[1]
    return chunked_attention(
        q.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
        torch.arange(Lq, device=q.device), torch.arange(Sk, device=q.device),
        causal=causal, window=window, sm_scale=sm_scale)


def rns_matmul_ref(x_res: torch.Tensor, w_res: torch.Tensor,
                   moduli: Sequence[int]) -> torch.Tensor:
    """Plain version of ``csrc/rns_matmul.cu``: per modulus, a float64
    batched matmul over the S slots (exact: sums stay far below 2^53) and
    ``torch.remainder``. (n_mod, S, M, g) x (n_mod, S, g, N) -> int32."""
    return torch.stack([
        torch.remainder(torch.matmul(x_res[i].to(torch.float64),
                                     w_res[i].to(torch.float64)), m)
        for i, m in enumerate(moduli)], dim=0).to(torch.int32)


def rns_matmul_channel_ref(x_res: torch.Tensor, w_res: torch.Tensor,
                           moduli: Sequence[int], noise: torch.Tensor,
                           adc_bits: Optional[int] = None,
                           count_flips: bool = False):
    """Plain version of the readout epilogue of ``csrc/rns_matmul.cu``:
    ``mod(round(o + noise), m)``, then the ADC re-grid
    ``clip(round(round(o / step) * step), 0, m - 1)`` where the converter
    has fewer levels than m. ``noise`` (n_mod, P, M, N) has a group period
    P: slot s reads ``noise[:, s % P]``. ``count_flips=True`` also returns
    the (n_mod,) int64 count of residues the noise moved, before the ADC."""
    o = rns_matmul_ref(x_res, w_res, moduli).to(torch.float32)
    S, P = o.shape[1], noise.shape[1]
    if S % P:
        raise ValueError(f"a noise period of {P} does not divide {S} slots")
    if P != S:
        noise = noise.repeat(1, S // P, 1, 1)
    outs, flips = [], []
    for i, m in enumerate(moduli):
        v = torch.remainder(torch.round(o[i] + noise[i]), float(m))
        flips.append(torch.sum(v != o[i]))
        step = adc_step(m, adc_bits)
        if step:
            s = torch.tensor(step, dtype=torch.float32, device=v.device)
            v = torch.clamp(torch.round(torch.round(v / s) * s), 0, m - 1)
        outs.append(v)
    out = torch.stack(outs, dim=0).to(torch.int32)
    if count_flips:
        return out, torch.stack(flips).to(torch.int64)
    return out


def rrns_decode_ref(residues: torch.Tensor, tables
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``csrc/rrns_decode.cu``: the fused decode in
    PyTorch operations, ``(decoded int32, votes f32)``."""
    return rrns.decode_votes(residues, tables)
