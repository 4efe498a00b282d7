"""GQA attention: full-sequence path + cached decode over the dense rings
or the paged pool, the speculative verify step and the chunked-prefill step;
self-attention, or the enc-dec decoder's cross-attention over the encoder's
output (``x_kv``, and a decode step that reads a fixed cross cache).

Port of ``repro.models.attention``. Full-sequence self-attention is the
hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`; its plain version on a
CPU tensor) where the caller asks for it (``use_flash``, the JAX package's
``LMCallOptions.use_flash_kernel``: serving's prefill), and otherwise the
plain online-softmax :func:`chunked_attention` in PyTorch operations, which
is what both packages train through (the flash kernel has no backward in
either; its wrapper raises where a gradient would be lost). Decode,
verify and chunk attention have no kernel in either package: they are
gathers and einsums in plain PyTorch, as in ``jnp`` there.

The paged steps write through a block table whose unmapped entries hold the
sentinel ``n_blocks``. JAX drops such writes on the device (``mode=
"drop"``); torch has no such mode, and an index of ``n_blocks`` is an
error. A step's :func:`page_plan`, computed once for all layers, points
each dropped row at a kept row's cell with that row's value, so
:func:`write_pages` drops them in one ordinary scatter with no
device-to-host transfer; gathers clamp the sentinel to ``n_blocks - 1``,
whose finite contents the position mask hides (the pools start zeroed).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.precision import MiragePolicy
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.parallel import comm as pcomm

NEG_INF = -1e30

__all__ = ["Attention", "NEG_INF", "_chunk_mask", "_repeat_kv",
           "attn_apply", "attn_decode_step", "attn_chunk_step",
           "attn_verify_step", "chunked_attention", "gather_pages",
           "PagePlan", "chunk_plan", "page_plan", "write_pages"]


class PagePlan(NamedTuple):
    """Where one step's rows land in the page pools, and what it reads.

    Computed once a step (:func:`page_plan`) and shared by every layer.
    ``cell`` (``(R,)`` int64, in bounds) is ``block * block_size +
    offset`` of each of the step's ``R`` rows in the pool seen as
    ``(NB * bs, Kv, D)``; a dropped row (sentinel block, past the table's
    capacity, or a pad) is pointed at the first kept row's cell and takes
    that row's value (``src``), so the one scatter writes every cell it
    touches with a single value and drops nothing it should keep; with no
    row kept (``any_kept`` False) the cells are written back unchanged.
    ``read`` is the table with the sentinel clamped to ``n_blocks - 1``."""
    cell: torch.Tensor
    src: torch.Tensor
    any_kept: torch.Tensor
    read: torch.Tensor


def page_plan(table: torch.Tensor, pos: torch.Tensor, NB: int, bs: int,
              extra_keep: Optional[torch.Tensor] = None) -> PagePlan:
    """The :class:`PagePlan` of writing logical positions ``pos`` through
    ``table`` (``(..., mb)``, its leading dims those of ``pos`` but the
    last) into pools of ``NB`` blocks of ``bs``. A row is kept when its
    position lies under the table's capacity ``mb * bs``, maps to a real
    block, and ``extra_keep`` (pads) allows it."""
    mb = table.shape[-1]
    blk = torch.clamp(torch.div(pos, bs, rounding_mode="floor"),
                      max=mb - 1).long()
    if blk.dim() < table.dim():
        dest = torch.gather(table, -1, blk.unsqueeze(-1)).squeeze(-1)
    else:
        dest = torch.gather(table, -1, blk)
    keep = (pos < mb * bs) & (dest < NB)
    if extra_keep is not None:
        keep = keep & extra_keep
    keep = keep.reshape(-1)
    rows = torch.arange(keep.numel(), device=keep.device)
    src = torch.where(keep, rows, torch.argmax(keep.to(torch.uint8)))
    cell = torch.clamp_max(dest.reshape(-1), NB - 1).long() * bs + \
        torch.remainder(pos.reshape(-1), bs)
    return PagePlan(cell[src], src, keep.any(),
                    torch.clamp_max(table, NB - 1).long())


def chunk_plan(table_row: torch.Tensor, pos0: int, C: int, true_len: int,
               NB: int, bs: int) -> PagePlan:
    """The :class:`PagePlan` of a prefill chunk: ``C`` positions from
    ``pos0`` through one slot's table row, the pads past ``true_len``
    dropped."""
    j = torch.arange(C, device=table_row.device)
    return page_plan(table_row, pos0 + j, NB, bs, j < true_len)


def write_pages(pages: torch.Tensor, plan: PagePlan,
                values: torch.Tensor) -> None:
    """Write a step's rows into a pool in place, dropping what the plan
    drops (the JAX package's ``.at[...].set(..., mode="drop")``), with no
    device-to-host transfer. ``pages`` is one layer's ``(NB, bs, Kv, D)``
    pool with ``values`` ``(rows..., Kv, D)``, or the layer-stacked
    ``(nl, NB, bs, Kv, D)`` pools with ``values`` ``(nl, rows..., Kv,
    D)``."""
    d = pages.dim() - 4                  # 1 when a layer dim leads
    flat = pages.view(pages.shape[:d] + (-1,) + pages.shape[d + 2:])
    v = values.flatten(d, -3).index_select(d, plan.src)
    flat.index_copy_(d, plan.cell, torch.where(
        plan.any_kept, v, flat.index_select(d, plan.cell)))


def gather_pages(pages: torch.Tensor, plan: PagePlan) -> torch.Tensor:
    """The pages the plan's table maps, in logical order: ``(NB, bs, Kv,
    D)`` pool and a ``(..., mb)`` table -> ``(..., mb * bs, Kv, D)``.
    Sentinel entries read block ``NB - 1``; the caller masks their
    positions."""
    read = plan.read
    out = pages.index_select(0, read.reshape(-1))
    return out.view(read.shape[:-1] + (read.shape[-1] * pages.shape[1],)
                    + pages.shape[2:])


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


def _local_kv(p: Attention, n_local: int, n_heads: int, k: torch.Tensor,
              v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (repeated) kv heads that the rank's ``n_local`` of the
    ``n_heads`` query heads read, where q is head-sharded over ``model``
    and k/v are not (fewer kv heads than ranks): a slice of the replicated
    k/v whose gradient is summed over ``model``."""
    if n_local == n_heads or common.tp_dim(p.k)[0] is not None:
        return k, v
    comm = common.tp_dim(p.q)[1]
    g = n_heads // k.shape[2]
    first = comm.tp_rank * n_local
    idx = torch.arange(first // g, (first + n_local - 1) // g + 1,
                       device=k.device)
    return (pcomm.select_tp(k, comm, 2, idx),
            pcomm.select_tp(v, comm, 2, idx))


def attn_apply(p: Attention, x: torch.Tensor, policy: MiragePolicy, *,
               n_heads: int, n_kv_heads: int, head_dim: int,
               positions: torch.Tensor, rope_theta: float,
               causal: bool = True, window: Optional[int] = None,
               qk_norm: bool = False, kv_repeat: int = 1,
               x_kv: Optional[torch.Tensor] = None,
               q_chunk: int = 1024, kv_chunk: int = 1024,
               use_flash: bool = False, skip_o_proj: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention block (train and prefill path).

    ``x_kv`` is the source of k/v for the enc-dec decoder's
    cross-attention over the encoder's output: its S rows sit at
    positions 0..S-1, every one valid, and neither side takes rope.
    Without it the call is self-attention over ``x`` at ``positions``
    with rope, and takes the flash kernel where ``use_flash`` asks, as
    the JAX package's ``use_flash`` condition has it: ``positions`` are
    then 0..L-1, what the kernel assumes. Returns ``(out, (k_cache,
    v_cache))`` so prefill can keep the projected KV; with
    ``skip_o_proj`` ``out`` is the context (B, L, H * D) before the output
    projection, for a caller that merges that GEMM with another
    (``LMCallOptions.merge_parallel_proj``)."""
    B, L, _ = x.shape
    src = x if x_kv is None else x_kv
    S = src.shape[1]
    if x_kv is None:
        xq, xk, xv = common.tp_inputs(x, p.q, p.k, p.v)
    else:
        (xq,), (xk, xv) = common.tp_inputs(x, p.q), \
            common.tp_inputs(src, p.k, p.v)
    # -1: the rank's heads where q/k/v are head-sharded over ``model``
    q = common.dense(p.q, xq, policy).reshape(B, L, -1, head_dim)
    k = common.dense(p.k, xk, policy).reshape(B, S, -1, head_dim)
    v = common.dense(p.v, xv, policy).reshape(B, S, -1, head_dim)
    if qk_norm:
        q = common.head_rmsnorm(p.q_norm, q)
        k = common.head_rmsnorm(p.k_norm, k)
    if x_kv is None:
        kv_pos = positions
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    else:
        kv_pos = torch.arange(S, device=x.device)
    k = _repeat_kv(k, kv_repeat)
    v = _repeat_kv(v, kv_repeat)
    k, v = _local_kv(p, q.shape[2], n_heads, k, v)
    if use_flash and x_kv is None:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = chunked_attention(q, k, v, positions, kv_pos, causal=causal,
                                window=window, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    out = out.reshape(B, L, -1)
    if skip_o_proj:
        return out, (k, v)
    return common.dense(p.o, out, policy), (k, v)


def attn_decode_step(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, idx: torch.Tensor,
                     policy: MiragePolicy, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     window: Optional[int] = None, qk_norm: bool = False,
                     kv_repeat: int = 1, cross: bool = False,
                     block_tables: Optional[torch.Tensor] = None,
                     plan: Optional[PagePlan] = None):
    """One decode step. x: (B, 1, d).

    ``idx`` is the current length: a scalar (the whole batch at one
    position) or a ``(B,)`` vector (every serving slot at its own position).
    Two cache layouts:

      * **dense** (``block_tables=None``): cache_k/v are ``(B, S_cap,
        Kv_eff, D)`` rings of keys already rope'd at their absolute
        positions; position p lives at slot ``p % S_cap``.
      * **paged** (``block_tables`` = ``(B, max_blocks)`` int32): cache_k/v
        are the global pools ``(n_blocks, block_size, Kv_eff, D)``;
        position p of row b lives at block ``block_tables[b, p // bs]``,
        offset ``p % bs`` (linear addressing, the window applied through
        the mask alone). A write through the sentinel ``n_blocks`` is
        dropped (:func:`write_pages`); the gather clamps it and the
        ``kpos <= idx`` mask hides it. Needs a vector ``idx``. ``plan``
        is the step's :func:`page_plan` where the caller shares one over
        the layers (computed here otherwise).

    Unlike the JAX function, the new key/value are written into cache_k/v
    IN PLACE (the serving cache is large and its old value is never read
    again); the updated tensors are also returned.

    ``cross=True`` is the enc-dec decoder's cross-attention: cache_k/v
    are the dense ``(B, S_enc, Kv_eff, D)`` keys and values projected from
    the encoder's output at prefill, read whole (every position valid);
    only q and o are projected, no rope is applied, and nothing is
    written.
    """
    B = x.shape[0]
    paged = block_tables is not None
    per_slot = idx.dim() == 1
    if paged and (cross or not per_slot):
        raise ValueError("paged decode needs a per-slot idx vector and a "
                         "self-attention cache")
    xq, xk, xv = common.tp_inputs(x, p.q, p.k, p.v)
    # -1: the rank's heads where q/k/v are head-sharded over ``model``
    # (the cache then holds the rank's kv heads)
    q = common.dense(p.q, xq, policy).reshape(B, 1, -1, head_dim)
    if qk_norm:
        q = common.head_rmsnorm(p.q_norm, q)
    rope_pos = idx.reshape(B, 1) if per_slot else idx.reshape(1)
    if not cross:
        q = common.apply_rope(q, rope_pos, rope_theta)
        knew = common.dense(p.k, xk, policy).reshape(B, 1, -1, head_dim)
        vnew = common.dense(p.v, xv, policy).reshape(B, 1, -1, head_dim)
        if qk_norm:
            knew = common.head_rmsnorm(p.k_norm, knew)
        knew = common.apply_rope(knew, rope_pos, rope_theta)
        knew = _repeat_kv(knew, kv_repeat)
        vnew = _repeat_kv(vnew, kv_repeat)

    if cross:
        valid = torch.ones(cache_k.shape[1], dtype=torch.bool,
                           device=x.device)
        keys, vals = cache_k, cache_v
    elif paged:
        if plan is None:
            plan = page_plan(block_tables, idx, cache_k.shape[0],
                             cache_k.shape[1])
        write_pages(cache_k, plan, knew[:, 0])
        write_pages(cache_v, plan, vnew[:, 0])
        keys = gather_pages(cache_k, plan)
        vals = gather_pages(cache_v, plan)
        kpos = torch.arange(keys.shape[1], device=x.device)
        idx_b = idx[:, None]
        valid = kpos[None, :] <= idx_b
        if window:
            valid = valid & (kpos[None, :] >= idx_b - (window - 1))
    else:
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
        # absolute position held by each slot (after this write); per-row
        # when idx is a vector -> kpos/valid broadcast to (B, S_cap)
        slots = torch.arange(S_cap, device=x.device)
        idx_b = idx[:, None] if per_slot else idx
        kpos = idx_b - torch.remainder(idx_b - slots, S_cap)
        valid = kpos >= 0
        if window:
            valid = valid & (kpos >= idx_b - (window - 1))
        keys, vals = cache_k, cache_v

    Kv_eff = keys.shape[2]
    rep = q.shape[2] // Kv_eff
    q5 = q.reshape(B, 1, Kv_eff, rep, head_dim)
    s = torch.einsum("bqkrd,bskd->bqkrs", q5, keys) * \
        (1.0 / math.sqrt(head_dim))
    vmask = (valid[:, None, None, None, :] if valid.dim() == 2
             else valid[None, None, None, None, :])
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", w, vals)
    out = out.reshape(B, 1, -1)
    return common.dense(p.o, out, policy), cache_k, cache_v


def attn_verify_step(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, idx: torch.Tensor,
                     policy: MiragePolicy, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     window: Optional[int] = None, qk_norm: bool = False,
                     kv_repeat: int = 1,
                     block_tables: Optional[torch.Tensor] = None,
                     plan: Optional[PagePlan] = None):
    """Multi-token verify step of speculative decoding (paged cache only).

    x: ``(B, T, d)``: per slot, the current token and ``T-1`` draft tokens
    at absolute positions ``idx[b] + j``. All ``T`` keys/values are written
    through the block tables FIRST (the engine maps the blocks beforehand;
    sentinel entries drop), then row ``j`` attends over the gathered pages
    masked at ``kpos <= idx + j``. Rejected draft tails need no rollback:
    their KV sits at positions past the accepted ones, which the next
    verify step writes again before any gather reads them. The pools are
    written in place and returned; ``plan`` as in :func:`attn_decode_step`.
    """
    if block_tables is None:
        raise ValueError("the verify step requires the paged layout")
    B, T = x.shape[0], x.shape[1]
    q = common.dense(p.q, x, policy).reshape(B, T, n_heads, head_dim)
    knew = common.dense(p.k, x, policy).reshape(B, T, n_kv_heads, head_dim)
    vnew = common.dense(p.v, x, policy).reshape(B, T, n_kv_heads, head_dim)
    if qk_norm:
        q = common.head_rmsnorm(p.q_norm, q)
        knew = common.head_rmsnorm(p.k_norm, knew)
    pos = idx[:, None] + torch.arange(T, device=x.device)[None, :]   # (B, T)
    q = common.apply_rope(q, pos, rope_theta)
    knew = _repeat_kv(common.apply_rope(knew, pos, rope_theta), kv_repeat)
    vnew = _repeat_kv(vnew, kv_repeat)

    # positions within a slot are distinct, and slots never share a
    # writable block (the engine forks shared blocks before any write), so
    # the kept writes never collide
    if plan is None:
        plan = page_plan(block_tables, pos, cache_k.shape[0],
                         cache_k.shape[1])
    write_pages(cache_k, plan, knew)
    write_pages(cache_v, plan, vnew)
    keys = gather_pages(cache_k, plan)
    vals = gather_pages(cache_v, plan)
    kpos = torch.arange(keys.shape[1], device=x.device)
    valid = kpos[None, None, :] <= pos[:, :, None]       # (B, T, LP)
    if window:
        valid = valid & (kpos[None, None, :] > pos[:, :, None] - window)

    Kv_eff = keys.shape[2]
    rep = n_heads // Kv_eff
    q5 = q.reshape(B, T, Kv_eff, rep, head_dim)
    s = torch.einsum("btkrd,bskd->btkrs", q5, keys) * \
        (1.0 / math.sqrt(head_dim))
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("btkrs,bskd->btkrd", w, vals)
    out = out.reshape(B, T, n_heads * head_dim)
    return common.dense(p.o, out, policy), cache_k, cache_v


def attn_chunk_step(p: Attention, x: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table_row: torch.Tensor,
                    pos0: int, true_len: int, policy: MiragePolicy, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    rope_theta: float, window: Optional[int] = None,
                    qk_norm: bool = False, kv_repeat: int = 1,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    plan: Optional[PagePlan] = None):
    """Chunked-prefill attention for ONE serving slot over the paged pools.

    x: ``(1, C, d)``, the slot's next ``C`` prompt tokens from absolute
    position ``pos0``; ``true_len <= C`` of them are real (the engine
    right-pads the last chunk: pads are dropped at the page write and
    masked in attention). ``pos0`` and ``true_len`` are host integers.
    k/v_pages are the ``(n_blocks, block_size, Kv_eff, D)`` pools (written
    in place and returned) and ``table_row`` the slot's ``(max_blocks,)``
    table. The chunk's keys are written FIRST, then q attends over the
    gathered prefix + chunk through the same plain online-softmax
    :func:`chunked_attention` as the JAX step (not the flash kernel), with
    cross-chunk causality and windows from the position mask alone;
    ``plan`` as in :func:`attn_decode_step`."""
    B, C = x.shape[0], x.shape[1]
    dev = x.device
    positions = pos0 + torch.arange(C, device=dev)
    q = common.dense(p.q, x, policy).reshape(B, C, n_heads, head_dim)
    k = common.dense(p.k, x, policy).reshape(B, C, n_kv_heads, head_dim)
    v = common.dense(p.v, x, policy).reshape(B, C, n_kv_heads, head_dim)
    if qk_norm:
        q = common.head_rmsnorm(p.q_norm, q)
        k = common.head_rmsnorm(p.k_norm, k)
    q = common.apply_rope(q, positions, rope_theta)
    k = _repeat_kv(common.apply_rope(k, positions, rope_theta), kv_repeat)
    v = _repeat_kv(v, kv_repeat)
    # pads and positions past the table's capacity are dropped
    if plan is None:
        plan = chunk_plan(table_row, pos0, C, true_len, k_pages.shape[0],
                          k_pages.shape[1])
    write_pages(k_pages, plan, k[0])
    write_pages(v_pages, plan, v[0])
    kb = gather_pages(k_pages, plan)[None]
    vb = gather_pages(v_pages, plan)[None]
    kpos = torch.arange(kb.shape[1], device=dev)
    kpos = torch.where(kpos < pos0 + true_len, kpos,
                       torch.full_like(kpos, 2**30))
    out = chunked_attention(q, kb, vb, positions, kpos, causal=True,
                            window=window, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    out = out.reshape(B, C, n_heads * head_dim)
    return common.dense(p.o, out, policy), k_pages, v_pages
