"""Decoder-only LM, dense family (port of ``repro.models.lm``).

Pre-norm GQA attention + SwiGLU MLP per layer, with QKV bias and tied
embeddings as qwen2 has them. The JAX package's ``lax.scan`` over stacked
layers becomes a loop over an ``nn.ModuleList``. Serving caches come in the
dense layout (per-slot rings) and the paged one (global page pools and
per-slot block tables, :meth:`LM.cache_spec`), with the speculative
:meth:`LM.verify_step` and :meth:`LM.prefill_chunk` over the latter. The
MoE, SSM, hybrid, enc-dec and vlm families and the parallel (command-r)
block are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import MiragePolicy
from repro_torch.device import resolve_device
from repro_torch.models import attention, common
from repro_torch.runtime.paging import blocks_for

_FAMILIES = "the MoE, SSM, hybrid, enc-dec and vlm families wait in " \
            "ROADMAP.md queue 1, slice 6"


@dataclasses.dataclass(frozen=True)
class LMCallOptions:
    """Runtime knobs that don't change parameters (the JAX package's fields
    that the ported paths read).

    ``q_chunk``/``kv_chunk`` size the plain attention's chunks; the flash
    kernel picks its own tiles. ``use_flash_kernel`` runs full-sequence
    attention through the flash kernel (forward only: serving's prefill
    sets it; training keeps the default, the plain attention, as in the
    JAX package). ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint`` per layer, the JAX package's
    ``jax.checkpoint`` around the scanned layer); ``ce_chunk`` computes the
    loss over chunks of that many tokens without materializing the full
    logits (:func:`chunked_ce`)."""
    kv_repeat: int = 1          # repeat kv heads (exact duplication)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    remat: bool = False
    ce_chunk: int = 0           # chunked CE loss (0 = unchunked)
    use_flash_kernel: bool = False   # flash attention kernel (forward only)


def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token log-likelihood of ``labels`` (clamped at 0) under f32
    ``logits`` (..., V)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, torch.clamp_min(labels, 0).long()[..., None]
                        )[..., 0]


def chunked_ce(h: torch.Tensor, labels: torch.Tensor, head_fn,
               chunk: int) -> torch.Tensor:
    """Cross-entropy without materializing (T, V) logits: a loop over token
    chunks, each recomputing its logits in the backward pass
    (``torch.utils.checkpoint``). h: (T, d), labels: (T,); label -1 (the
    padding of the last chunk) contributes nothing. Returns the mean CE."""
    T = h.shape[0]
    chunk = min(chunk, T) if chunk else T
    pad = (-T) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def body(hh, ll):
        ll_tok = _token_ce(head_fn(hh), ll)
        return -torch.sum(torch.where(ll >= 0, ll_tok,
                                      torch.zeros_like(ll_tok)))

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], chunk):
        total = total + checkpoint(body, h[i:i + chunk], labels[i:i + chunk],
                                   use_reentrant=False)
    return total / T


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.attn = attention.Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.qkv_bias, cfg.qk_norm, **kw)
        self.ln2 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, False, **kw)


class LM(nn.Module):
    """The dense LM. Weights are drawn from ``generator`` (default: seed 0
    on ``device``) with the JAX package's initializers; to compute the same
    function as a JAX model, load its parameters with
    :func:`repro_torch.interop.load_jax_params`."""

    def __init__(self, cfg: ModelConfig, policy: MiragePolicy,
                 options: LMCallOptions = LMCallOptions(), *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kinds = set(cfg.layer_kinds())
        if kinds != {"attn_mlp"} or cfg.is_encdec or cfg.frontend:
            raise NotImplementedError(f"{cfg.arch_id}: {_FAMILIES}")
        if cfg.arch_id.startswith("command-r"):
            raise NotImplementedError(
                f"{cfg.arch_id}: the parallel attention/MLP block waits in "
                f"ROADMAP.md queue 1, slice 6")
        self.cfg = cfg
        self.policy = policy
        self.opt = options
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(generator=generator, device=device)
        self.embed = common.Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.Norm(cfg.d_model, cfg.norm_type,
                                      device=device)
        self.lm_head = None if cfg.tie_embeddings else common.Dense(
            cfg.d_model, cfg.vocab_size, False, scale=0.02, **kw)

    @property
    def device(self) -> torch.device:
        """Where the parameters live (follows ``.to(...)``)."""
        return self.embed.emb.device

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = common.norm(self.final_norm, h, cfg.norm_eps, cfg.norm_type)
        if self.lm_head is None:
            return common.unembed(self.embed, h, self.policy)
        return common.dense(self.lm_head, h, self.policy)

    def _attn_mlp_block(self, layer: Layer, h: torch.Tensor,
                        positions: torch.Tensor):
        """One layer over a full sequence; returns (h, (k, v))."""
        cfg, opt = self.cfg, self.opt
        n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
        a, kv = attention.attn_apply(
            layer.attn, n1, self.policy, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            positions=positions, rope_theta=cfg.rope_theta, causal=True,
            window=cfg.sliding_window, qk_norm=cfg.qk_norm,
            kv_repeat=opt.kv_repeat, q_chunk=opt.q_chunk,
            kv_chunk=opt.kv_chunk, use_flash=opt.use_flash_kernel)
        return self._mlp_tail(layer, h + a), kv

    def _mlp_tail(self, layer: Layer, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n2 = common.norm(layer.ln2, h, cfg.norm_eps, cfg.norm_type)
        return h + common.mlp(layer.mlp, n2, self.policy)

    # ------------------------------------------------------------------
    # forward (train / logits over the full sequence)
    # ------------------------------------------------------------------

    def forward_hidden(self, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Run the layer stack; returns (hidden, aux, n_prefix). The dense
        family has no router loss (aux is 0) and no frontend prefix."""
        h = common.embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)

        def block(layer, hh):
            return self._attn_mlp_block(layer, hh, positions)[0]

        for layer in self.layers:
            if self.opt.remat and torch.is_grad_enabled():
                h = checkpoint(block, layer, h, use_reentrant=False)
            else:
                h = block(layer, h)
        return h, torch.zeros((), dtype=torch.float32, device=h.device), 0

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L) -> logits (B, L, V) (the JAX ``forward``'s first
        output; its aux and prefix are those of :meth:`forward_hidden`)."""
        return self._head(self.forward_hidden(tokens)[0])

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels``, (B, L)) plus the router loss; returns (loss, metrics
        ``ce``, ``aux``, ``ppl``) as the JAX ``loss`` does."""
        tokens, labels = batch["tokens"], batch["labels"]
        h, aux, n_prefix = self.forward_hidden(tokens)
        h = h[:, n_prefix:, :]
        B, L, d = h.shape
        if self.opt.ce_chunk:
            ce = chunked_ce(h.reshape(B * L, d), labels.reshape(B * L),
                            self._head, self.opt.ce_chunk)
        else:
            ce = -torch.mean(_token_ce(self._head(h), labels))
        total = ce + self.cfg.router_aux_loss * aux / max(self.cfg.n_layers,
                                                          1)
        return total, {"ce": ce, "aux": aux,
                       "ppl": torch.exp(torch.clamp_max(ce, 20.0))}

    # ------------------------------------------------------------------
    # serving: prefill + single-token decode with caches
    # ------------------------------------------------------------------

    def cache_len(self, cap: int) -> int:
        return min(cap, self.cfg.sliding_window or cap)

    def cache_spec(self, batch: int, cap: int, per_slot_idx: bool = False,
                   layout: str = "dense", block_size: int = 16,
                   n_blocks: Optional[int] = None
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Cache leaf shapes and dtypes (the JAX ``cache_spec``).

        ``per_slot_idx=True`` is the continuous-batching layout: ``idx`` is
        a ``(batch,)`` vector instead of one scalar. ``layout="paged"``
        (implies per-slot idx) replaces the per-slot rings ``k``/``v``
        ``(n_layers, batch, cache_len, kv_eff, hd)`` with ONE pool shared
        by every slot, ``kp``/``vp`` ``(n_layers, n_blocks, block_size,
        kv_eff, hd)`` (default ``batch * ceil(cap / block_size)`` blocks:
        no saving but never exhausted), and the ``(batch, ceil(cap /
        block_size))`` int32 block table ``bt``. Paged addressing is
        linear (no ring wrap): a sliding window is applied through the
        mask, so paged capacity is ``cap`` positions."""
        if layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache layout {layout!r}")
        paged = layout == "paged"
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        kv_eff = cfg.n_kv_heads * self.opt.kv_repeat
        nl = cfg.n_layers
        spec: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {
            "idx": (((batch,) if per_slot_idx or paged else ()),
                    torch.int32)}
        if paged:
            mb = blocks_for(cap, block_size)
            nb = n_blocks if n_blocks is not None else batch * mb
            spec["kp"] = ((nl, nb, block_size, kv_eff, hd), torch.float32)
            spec["vp"] = ((nl, nb, block_size, kv_eff, hd), torch.float32)
            spec["bt"] = ((batch, mb), torch.int32)
        else:
            shape = (nl, batch, self.cache_len(cap), kv_eff, hd)
            spec["k"] = (shape, torch.float32)
            spec["v"] = (shape, torch.float32)
        return spec

    def init_cache(self, batch: int, cap: int, per_slot_idx: bool = False,
                   layout: str = "dense", block_size: int = 16,
                   n_blocks: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
        """Zeroed cache of :meth:`cache_spec`'s shapes on the model's
        device; unmapped block-table entries hold the sentinel
        ``n_blocks``."""
        spec = self.cache_spec(batch, cap, per_slot_idx, layout=layout,
                               block_size=block_size, n_blocks=n_blocks)
        cache = {k: torch.zeros(shape, dtype=dt, device=self.device)
                 for k, (shape, dt) in spec.items()}
        if "bt" in cache:
            cache["bt"].fill_(spec["kp"][0][1])
        return cache

    def prefill(self, tokens: torch.Tensor, cap: int,
                lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the prompt, build the cache, return last-position logits.

        ``lens``: optional ``(B,)`` true prompt lengths for right-padded
        batched prefill. The logits are then taken at each row's last REAL
        token and the cache's per-slot ``idx`` is ``lens``; decode
        overwrites the padded positions one token at a time while the
        validity mask hides them (exact for attention: the causal mask keeps
        real positions from reading padded ones)."""
        B, L = tokens.shape
        cache_len = self.cache_len(cap)
        if lens is not None and L > cache_len:
            raise ValueError(
                f"padded prefill length {L} exceeds cache capacity "
                f"{cache_len}; raise cap or shrink the bucket")
        h = common.embed(self.embed, tokens)
        positions = torch.arange(L, device=tokens.device)
        cache = self.init_cache(B, cap)
        # keep the last cache_len positions in ring layout (pos % cache_len)
        keep = min(L, cache_len)
        roll = max(L - cache_len, 0) % cache_len
        for li, layer in enumerate(self.layers):
            h, (kk, vv) = self._attn_mlp_block(layer, h, positions)
            for leaf, val in (("k", kk), ("v", vv)):
                val = torch.roll(val[:, L - keep:], roll, dims=1)
                cache[leaf][li, :, :keep] = val
        if lens is None:
            cache["idx"] = torch.tensor(L, dtype=torch.int32,
                                        device=tokens.device)
            h_last = h[:, -1:, :]
        else:
            lens = lens.to(device=tokens.device, dtype=torch.int32)
            cache["idx"] = lens
            last = torch.clamp_min(lens.long() - 1, 0)
            h_last = h[torch.arange(B, device=tokens.device), last][:, None]
        return self._head(h_last), cache

    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens: (B, 1). Returns (logits (B, 1, V), cache with idx + 1).

        The layout follows the cache's keys: a ``bt`` leaf selects the
        paged pools ``kp``/``vp``, else the dense rings ``k``/``v``. Either
        is updated in place (see
        :func:`repro_torch.models.attention.attn_decode_step`)."""
        cfg = self.cfg
        h = common.embed(self.embed, tokens)
        idx = cache["idx"]
        bt = cache.get("bt")
        k_key, v_key = ("kp", "vp") if bt is not None else ("k", "v")
        plan = None if bt is None else attention.page_plan(
            bt, idx, *cache["kp"].shape[1:3])
        for li, layer in enumerate(self.layers):
            n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
            a, _, _ = attention.attn_decode_step(
                layer.attn, n1, cache[k_key][li], cache[v_key][li], idx,
                self.policy, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                window=cfg.sliding_window, qk_norm=cfg.qk_norm,
                kv_repeat=self.opt.kv_repeat, block_tables=bt, plan=plan)
            h = self._mlp_tail(layer, h + a)
        return self._head(h), dict(cache, idx=idx + 1)

    def verify_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], None]:
        """Speculative-decoding verify over a PAGED cache: score ``T``
        tokens per slot in one step.

        tokens: ``(S, T)``, per slot ``[current token ; T-1 drafts]`` at
        positions ``idx[s] .. idx[s]+T-1``. Returns ``(logits (S, T, V),
        cache, steps)``; ``idx`` is NOT advanced (the caller commits the
        accepted count), and ``steps`` is None (the JAX package's recurrent
        per-token states, which the dense family has none of)."""
        cfg = self.cfg
        h = common.embed(self.embed, tokens)
        idx, bt = cache["idx"], cache["bt"]
        pos = idx[:, None] + torch.arange(tokens.shape[1],
                                          device=idx.device)[None, :]
        plan = attention.page_plan(bt, pos, *cache["kp"].shape[1:3])
        for li, layer in enumerate(self.layers):
            n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
            a, _, _ = attention.attn_verify_step(
                layer.attn, n1, cache["kp"][li], cache["vp"][li], idx,
                self.policy, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                window=cfg.sliding_window, qk_norm=cfg.qk_norm,
                kv_repeat=self.opt.kv_repeat, block_tables=bt, plan=plan)
            h = self._mlp_tail(layer, h + a)
        return self._head(h), cache, None

    def prefill_chunk(self, cache: Dict[str, torch.Tensor],
                      tokens: torch.Tensor, slot: int, pos0: int,
                      true_len: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One prompt chunk of ONE slot of a PAGED cache.

        tokens: ``(1, C)``, the slot's next chunk from absolute position
        ``pos0``; ``true_len <= C`` tokens are real (the last chunk may be
        right-padded). ``slot``, ``pos0`` and ``true_len`` are host
        integers. The chunk's k/v go straight into the pools through the
        slot's table (blocks must be mapped for positions ``< pos0 +
        true_len``), in place. Returns (logits (1, 1, V) at the chunk's
        last real token, cache) with ``idx[slot] = pos0 + true_len``."""
        cfg, opt = self.cfg, self.opt
        h = common.embed(self.embed, tokens)
        bt_row = cache["bt"][slot]
        plan = attention.chunk_plan(bt_row, pos0, tokens.shape[1], true_len,
                                    *cache["kp"].shape[1:3])
        for li, layer in enumerate(self.layers):
            n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
            a, _, _ = attention.attn_chunk_step(
                layer.attn, n1, cache["kp"][li], cache["vp"][li], bt_row,
                pos0, true_len, self.policy, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                qk_norm=cfg.qk_norm, kv_repeat=opt.kv_repeat,
                q_chunk=opt.q_chunk, kv_chunk=opt.kv_chunk, plan=plan)
            h = self._mlp_tail(layer, h + a)
        cache["idx"][slot] = pos0 + true_len
        last = max(true_len - 1, 0)
        return self._head(h[:, last:last + 1]), cache


# --------------------------------------------------------------------------
# Stacked-cache helpers of the continuous-batching engine. A stacked cache's
# batch dim is the slot dim and its "idx" a per-slot vector; the paged
# layout adds the global pools (NOT per slot) and the per-slot table "bt".
# --------------------------------------------------------------------------

PAGE_POOL_LEAVES = ("kp", "vp")
# paged pool leaf -> the dense prefill leaf whose rows scatter into it
_POOL_SRC = {"kp": "k", "vp": "v"}


def cache_slot_axis(name: str) -> int:
    """Axis of the slot dim of a PER-SLOT leaf: 0 for ``idx`` and ``bt``,
    1 for the layer-stacked rings. Pool leaves have no slot axis."""
    return 0 if name in ("idx", "bt") else 1


def _scatter_pages(pages: torch.Tensor, dense: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """Scatter dense prefill KV rows into a page pool, in place.

    pages: ``(nl, n_blocks, bs, kv, hd)``; dense: ``(nl, B, L, kv, hd)``
    at linear positions 0..L-1 (serving prefill never wraps); rows: the
    ``(B, max_blocks)`` destination tables. Sentinel entries and
    positions past the table's capacity are dropped."""
    B, L = dense.shape[1], dense.shape[2]
    pos = torch.arange(L, device=pages.device).expand(B, L)
    plan = attention.page_plan(rows, pos, pages.shape[1], pages.shape[2])
    attention.write_pages(pages, plan, dense)
    return pages


def cache_insert(live: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                 slots: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scatter a batched prefill cache into the live per-slot cache.

    ``new`` is a DENSE prefill cache of ``B_new`` rows; ``slots`` the
    ``(B_new,)`` destination slot per row. Rows whose slot is out of bounds
    (the ``>= n_slots`` sentinel that pads admission groups to a power of
    two) are dropped: they are masked out before the scatter, which is what
    the JAX package's ``mode="drop"`` does on device. Pass ``slots`` on the
    host to keep the mask off the device. When ``live`` is PAGED, the
    dense ``k``/``v`` rows go through the live block tables into the pools
    (the rows' blocks must be mapped already; unmapped ones drop). The live
    leaves are written in place and returned."""
    rows = torch.nonzero(slots < live["idx"].shape[0])[:, 0]
    dst = slots[rows].to(live["idx"].device)
    src = rows.to(new["idx"].device)
    for name, leaf in live.items():
        if name == "bt":
            continue
        if name in PAGE_POOL_LEAVES:
            _scatter_pages(leaf, new[_POOL_SRC[name]][:, src],
                           live["bt"][dst])
        elif name == "idx":
            leaf[dst] = new[name][src].to(leaf.dtype)
        else:
            leaf[:, dst] = new[name][:, src]
    return live


def cache_extract(cache: Dict[str, torch.Tensor], slots
                  ) -> Dict[str, torch.Tensor]:
    """Gather the given slots out of a stacked cache. Pool leaves are global
    (block ids do not move with slots) and pass through; the ``bt`` rows
    carry each slot's mapping."""
    slots = torch.as_tensor(slots, dtype=torch.long,
                            device=cache["idx"].device)
    out = {}
    for name, leaf in cache.items():
        if name in PAGE_POOL_LEAVES:
            out[name] = leaf
        elif cache_slot_axis(name) == 0:
            out[name] = leaf[slots]
        else:
            out[name] = leaf[:, slots]
    return out
