"""GQA attention: full-sequence path + dense cached decode.

Port of ``repro.models.attention`` for the dense family. Full-sequence
attention is the hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`; its plain version on a
CPU tensor) where the caller asks for it (``use_flash``, the JAX package's
``LMCallOptions.use_flash_kernel``: serving's prefill), and otherwise the
plain online-softmax :func:`chunked_attention` in PyTorch operations, which
is what both packages train through (the flash kernel has no backward in
either; its wrapper raises where a gradient would be lost). Decode
attention has no kernel in either package. The paged, verify and
chunked-prefill decode variants are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.precision import MiragePolicy
from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30

__all__ = ["Attention", "NEG_INF", "_chunk_mask", "_repeat_kv",
           "attn_apply", "attn_decode_step", "attn_chunk_step",
           "attn_verify_step", "chunked_attention"]

_PAGED = "the paged KV layout waits in ROADMAP.md queue 1, slice 5"


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
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax GQA attention; returns (B, Lq, H, D).

    q: (B, Lq, H, D) with rope applied, k/v: (B, Sk, Kv, D); query head h
    reads kv head h // (H // Kv). The JAX package's ``lax.map``/``lax.scan``
    over chunks become Python loops; the arithmetic is the same.
    ``sm_scale`` defaults to 1/sqrt(D) (a caller that padded D with zero
    columns passes the true head dim's)."""
    B, Lq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {Kv}")
    rep = H // Kv
    if sm_scale is None:
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


class Attention(nn.Module):
    """q/k/v/o projection weights (and the qwen3 qk-norm scales)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool, qk_norm: bool, *,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.q = common.Dense(d_model, n_heads * head_dim, qkv_bias, **kw)
        self.k = common.Dense(d_model, n_kv_heads * head_dim, qkv_bias, **kw)
        self.v = common.Dense(d_model, n_kv_heads * head_dim, qkv_bias, **kw)
        self.o = common.Dense(n_heads * head_dim, d_model, False, **kw)
        self.q_norm = (nn.Parameter(torch.ones(head_dim, device=device))
                       if qk_norm else None)
        self.k_norm = (nn.Parameter(torch.ones(head_dim, device=device))
                       if qk_norm else None)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Kv, D) -> (B, S, Kv*n_rep, D). Exact duplication (jnp.repeat)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attn_apply(p: Attention, x: torch.Tensor, policy: MiragePolicy, *,
               n_heads: int, n_kv_heads: int, head_dim: int,
               positions: torch.Tensor, rope_theta: float,
               causal: bool = True, window: Optional[int] = None,
               qk_norm: bool = False, kv_repeat: int = 1,
               q_chunk: int = 1024, kv_chunk: int = 1024,
               use_flash: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention block (train and prefill path).

    ``positions`` are the sequence's positions 0..L-1 (what the flash
    kernel assumes, as the JAX ``use_flash`` condition does). Returns
    ``(out, (k_cache, v_cache))`` so prefill can keep the projected KV."""
    B, L, _ = x.shape
    q = common.dense(p.q, x, policy).reshape(B, L, n_heads, head_dim)
    k = common.dense(p.k, x, policy).reshape(B, L, n_kv_heads, head_dim)
    v = common.dense(p.v, x, policy).reshape(B, L, n_kv_heads, head_dim)
    if qk_norm:
        q = common.head_rmsnorm(p.q_norm, q)
        k = common.head_rmsnorm(p.k_norm, k)
    q = common.apply_rope(q, positions, rope_theta)
    k = common.apply_rope(k, positions, rope_theta)
    k = _repeat_kv(k, kv_repeat)
    v = _repeat_kv(v, kv_repeat)
    if use_flash:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = chunked_attention(q, k, v, positions, positions, causal=causal,
                                window=window, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    out = out.reshape(B, L, n_heads * head_dim)
    return common.dense(p.o, out, policy), (k, v)


def attn_decode_step(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, idx: torch.Tensor,
                     policy: MiragePolicy, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     window: Optional[int] = None, qk_norm: bool = False,
                     kv_repeat: int = 1,
                     block_tables: Optional[torch.Tensor] = None):
    """One decode step over a dense per-slot ring. x: (B, 1, d).

    ``idx`` is the current length: a scalar (the whole batch at one
    position) or a ``(B,)`` vector (every serving slot at its own position).
    cache_k/v are ``(B, S_cap, Kv_eff, D)`` rings of keys already rope'd at
    their absolute positions; position p lives at slot ``p % S_cap``.

    Unlike the JAX function, the new key/value are written into cache_k/v
    IN PLACE (the serving cache is large and its old value is never read
    again); the updated tensors are also returned.
    """
    if block_tables is not None:
        raise NotImplementedError(_PAGED)
    B = x.shape[0]
    per_slot = idx.dim() == 1
    q = common.dense(p.q, x, policy).reshape(B, 1, n_heads, head_dim)
    knew = common.dense(p.k, x, policy).reshape(B, 1, n_kv_heads, head_dim)
    vnew = common.dense(p.v, x, policy).reshape(B, 1, n_kv_heads, head_dim)
    if qk_norm:
        q = common.head_rmsnorm(p.q_norm, q)
        knew = common.head_rmsnorm(p.k_norm, knew)
    rope_pos = idx.reshape(B, 1) if per_slot else idx.reshape(1)
    q = common.apply_rope(q, rope_pos, rope_theta)
    knew = _repeat_kv(common.apply_rope(knew, rope_pos, rope_theta),
                      kv_repeat)
    vnew = _repeat_kv(vnew, kv_repeat)

    S_cap = cache_k.shape[1]
    slot = torch.remainder(idx, S_cap)   # jnp.mod semantics
    if per_slot:
        rows = torch.arange(B, device=x.device)
        cache_k[rows, slot] = knew[:, 0]
        cache_v[rows, slot] = vnew[:, 0]
    else:
        where = slot.reshape(1).long()
        cache_k.index_copy_(1, where, knew)
        cache_v.index_copy_(1, where, vnew)
    # absolute position held by each slot (after this write); per-row when
    # idx is a vector -> kpos/valid broadcast to (B, S_cap)
    slots = torch.arange(S_cap, device=x.device)
    idx_b = idx[:, None] if per_slot else idx
    kpos = idx_b - torch.remainder(idx_b - slots, S_cap)
    valid = kpos >= 0
    if window:
        valid = valid & (kpos >= idx_b - (window - 1))

    Kv_eff = cache_k.shape[2]
    rep = n_heads // Kv_eff
    q5 = q.reshape(B, 1, Kv_eff, rep, head_dim)
    s = torch.einsum("bqkrd,bskd->bqkrs", q5, cache_k) * \
        (1.0 / math.sqrt(head_dim))
    vmask = (valid[:, None, None, None, :] if valid.dim() == 2
             else valid[None, None, None, None, :])
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", w, cache_v)
    out = out.reshape(B, 1, n_heads * head_dim)
    return common.dense(p.o, out, policy), cache_k, cache_v


def attn_verify_step(*args, **kwargs):
    """Speculative-decoding verify step: paged layout only, not ported."""
    raise NotImplementedError(
        "attn_verify_step (speculative decoding over the paged layout) "
        "waits in ROADMAP.md queue 1, slice 5")


def attn_chunk_step(*args, **kwargs):
    """Chunked-prefill attention over the paged layout, not ported."""
    raise NotImplementedError(
        "attn_chunk_step (chunked prefill over the paged layout) waits in "
        "ROADMAP.md queue 1, slice 5")
