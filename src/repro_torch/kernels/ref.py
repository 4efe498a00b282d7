"""Plain PyTorch versions of the hand-written kernels.

Port of ``repro.kernels.ref`` plus ``repro.models.attention.chunked_attention``
and the plain versions of the residue kernels.
A CPU tensor reaching a wrapper in :mod:`repro_torch.kernels.ops` runs these;
on the card ``chip_smoke.py`` holds each kernel against them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analog import rrns
from repro_torch.analog.channel import adc_step
from repro_torch.core import bfp

NEG_INF = -1e30


def bfp_fake_quant_ref(x: torch.Tensor, b_m: int = 4, g: int = 16,
                       rounding: str = "nearest") -> torch.Tensor:
    """Plain version of ``csrc/bfp_quantize.cu``."""
    return bfp.bfp_fake_quant(x.to(torch.float32), b_m, g, rounding)


def mirage_gemm_ref(x: torch.Tensor, w: torch.Tensor, b_m: int = 4,
                    g: int = 16, rounding: str = "nearest",
                    compute_dtype: str = "float32") -> torch.Tensor:
    """Plain version of ``csrc/mirage_gemm.cu``: quantize both operands along
    K, fold scales, one f32-accumulated matmul."""
    xq = bfp.bfp_fake_quant(x.to(torch.float32), b_m, g, rounding)
    wq = bfp.bfp_fake_quant(w.to(torch.float32).T, b_m, g, rounding).T
    if compute_dtype == "bfloat16":
        # BFP(b_m <= 6) values are exact in bf16: the cast is value-identical
        xq = xq.to(torch.bfloat16).to(torch.float32)
        wq = wq.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xq, wq)


def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(Lq, Sk) boolean validity mask from absolute positions. Padded key
    slots carry position 2^30 and are masked in the non-causal path too."""
    m = (k_pos[None, :] < 2**29).expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        m = m & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        m = m & (q_pos[:, None] - k_pos[None, :] < window)
    return m


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, k_positions: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax GQA attention; returns (B, Lq, H, D).

    q: (B, Lq, H, D) with rope applied, k/v: (B, Sk, Kv, D); query head h
    reads kv head h // (H // Kv). The JAX package's ``lax.map``/``lax.scan``
    over chunks become Python loops; the arithmetic is the same."""
    B, Lq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Kv}")
    rep = H // Kv
    sm_scale = 1.0 / math.sqrt(D)
    qc = min(q_chunk, Lq)
    kc = min(kv_chunk, Sk)
    pad_q = (-Lq) % qc
    pad_k = (-Sk) % kc
    F = torch.nn.functional
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = F.pad(q_positions, (0, pad_q), value=-1)
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_positions = F.pad(k_positions, (0, pad_k), value=2**30)
    q5 = q.reshape(B, -1, Kv, rep, D)
    outs = []
    for i0 in range(0, q5.shape[1], qc):
        qi, qp = q5[:, i0:i0 + qc], q_positions[i0:i0 + qc]
        acc = torch.zeros((B, qc, Kv, rep, D), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((B, qc, Kv, rep), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, qc, Kv, rep), dtype=torch.float32,
                            device=q.device)
        for j0 in range(0, k.shape[1], kc):
            ki, vi = k[:, j0:j0 + kc], v[:, j0:j0 + kc]
            s = torch.einsum("bqkrd,bskd->bqkrs", qi, ki) * sm_scale
            mask = _chunk_mask(qp, k_positions[j0:j0 + kc], causal, window)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkrs,bskd->bqkrd",
                                                        p, vi)
            m_run = m_new
        outs.append(acc / torch.clamp_min(l_run[..., None], 1e-30))
    out = torch.cat(outs, dim=1).reshape(B, -1, H, D)
    return out[:, :Lq]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``csrc/flash_attention.cu``: full-sequence
    self-attention at contiguous positions from 0, as the kernel assumes."""
    Lq, Sk = q.shape[1], k.shape[1]
    return chunked_attention(
        q.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
        torch.arange(Lq, device=q.device), torch.arange(Sk, device=q.device),
        causal=causal, window=window)


def rns_matmul_ref(x_res: torch.Tensor, w_res: torch.Tensor,
                   moduli: Sequence[int]) -> torch.Tensor:
    """Plain version of ``csrc/rns_matmul.cu``: per modulus, a float64
    batched matmul over the G groups (exact: sums stay far below 2^53) and
    ``torch.remainder``. (n_mod, G, M, g) x (n_mod, G, g, N) -> int32."""
    return torch.stack([
        torch.remainder(torch.matmul(x_res[i].to(torch.float64),
                                     w_res[i].to(torch.float64)), m)
        for i, m in enumerate(moduli)], dim=0).to(torch.int32)


def rns_matmul_channel_ref(x_res: torch.Tensor, w_res: torch.Tensor,
                           moduli: Sequence[int], noise: torch.Tensor,
                           adc_bits: Optional[int] = None) -> torch.Tensor:
    """Plain version of the readout epilogue of ``csrc/rns_matmul.cu``:
    ``mod(round(o + noise), m)``, then the ADC re-grid
    ``clip(round(round(o / step) * step), 0, m - 1)`` where the converter
    has fewer levels than m."""
    o = rns_matmul_ref(x_res, w_res, moduli).to(torch.float32)
    outs = []
    for i, m in enumerate(moduli):
        v = torch.remainder(torch.round(o[i] + noise[i]), float(m))
        step = adc_step(m, adc_bits)
        if step:
            s = torch.tensor(step, dtype=torch.float32, device=v.device)
            v = torch.clamp(torch.round(torch.round(v / s) * s), 0, m - 1)
        outs.append(v)
    return torch.stack(outs, dim=0).to(torch.int32)


def rrns_decode_ref(residues: torch.Tensor, tables
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``csrc/rrns_decode.cu``: the fused decode in
    PyTorch operations, ``(decoded int32, votes f32)``."""
    return rrns.decode_votes(residues, tables)
