"""Encoder-decoder transformer, the enc-dec family (port of
``repro.models.encdec``; the SeamlessM4T v2 backbone).

Encoder: ``frontend_proj`` over precomputed frame embeddings (the speech
frontend is a stub), then bidirectional self-attention + GELU MLP layers
with rope at the frames' positions, then ``enc_norm``. Decoder: causal
self-attention with rope, cross-attention over the encoder's output (no
rope, every frame valid), GELU MLP, then ``final_norm`` and an untied head.
LayerNorm and QKV biases (fairseq style).

Serving is the model's own :meth:`EncDec.prefill` and greedy
:meth:`EncDec.decode_step`, as in the JAX package, whose engine serves no
enc-dec model. The cache holds each decoder layer's self-attention KV
(``self_k``/``self_v``, padded to the capacity and written in place one
token a step) and its cross-attention KV (``cross_k``/``cross_v``,
projected from the encoder's output once at prefill and only read), with
one scalar ``idx``: every row of a batch shares one prompt length.

The JAX package's ``lax.scan`` over the stacked layers becomes a loop over
two ``nn.ModuleList``s, ``enc_layers`` and ``dec_layers`` (the JAX tree's
two stacked subtrees, which :mod:`repro_torch.interop` maps by name);
``remat`` wraps each layer in ``torch.utils.checkpoint``, except where a
prefill collects the caches. Analog-health records reach an open scope
from any layer directly (the JAX ``lifted``/``lifting_scan`` carry them
out of its scans and suppress nothing here).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import MiragePolicy
from repro_torch.device import resolve_device
from repro_torch.models import attention, common
from repro_torch.models.lm import LMCallOptions, _token_ce, chunked_ce


class EncLayer(nn.Module):
    """An encoder layer: pre-norm bidirectional attention, GELU MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.attn = attention.Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.qkv_bias, False, **kw)
        self.ln2 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, cfg.qkv_bias, "gelu",
                              **kw)


class DecLayer(nn.Module):
    """A decoder layer: causal self-attention, cross-attention over the
    encoder's output, GELU MLP, each pre-norm."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        attn = dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                    qk_norm=False, **kw)
        self.ln1 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.self_attn = attention.Attention(**attn)
        self.ln_x = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.cross_attn = attention.Attention(**attn)
        self.ln2 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, cfg.qkv_bias, "gelu",
                              **kw)


class EncDec(nn.Module):
    """The enc-dec model. Weights are drawn from ``generator`` (default:
    seed 0 on ``device``) with the JAX package's initializers, in the JAX
    tree's order of leaves; to compute the same function as a JAX model,
    load its parameters with :func:`repro_torch.interop.load_jax_params`.
    """

    #: the layer stacks, named as the JAX tree's stacked subtrees
    stacks = ("enc_layers", "dec_layers")

    def __init__(self, cfg: ModelConfig, policy: MiragePolicy,
                 options: LMCallOptions = LMCallOptions(), *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.arch_id} has no encoder (encoder_layers "
                             f"= 0); build it as an LM")
        self.cfg = cfg
        self.policy = policy
        self.opt = options
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(generator=generator, device=device)
        self.frontend_proj = common.Dense(cfg.frontend_dim, cfg.d_model,
                                          **kw)
        self.embed = common.Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, **kw)
                                        for _ in range(cfg.encoder_layers))
        self.enc_norm = common.Norm(cfg.d_model, cfg.norm_type,
                                    device=device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        self.final_norm = common.Norm(cfg.d_model, cfg.norm_type,
                                      device=device)
        self.lm_head = common.Dense(cfg.d_model, cfg.vocab_size, False,
                                    scale=0.02, **kw)

    @property
    def device(self) -> torch.device:
        """Where the parameters live (follows ``.to(...)``)."""
        return self.embed.emb.device

    def _norm(self, p: common.Norm, x: torch.Tensor) -> torch.Tensor:
        return common.norm(p, x, self.cfg.norm_eps, self.cfg.norm_type)

    def _attend(self, p: attention.Attention, x: torch.Tensor,
                positions: torch.Tensor, causal: bool, **kw):
        cfg, opt = self.cfg, self.opt
        return attention.attn_apply(
            p, x, self.policy, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            positions=positions, rope_theta=cfg.rope_theta, causal=causal,
            kv_repeat=opt.kv_repeat, q_chunk=opt.q_chunk,
            kv_chunk=opt.kv_chunk, use_flash=opt.use_flash_kernel, **kw)

    def _run(self, block, layer, *args, remat: bool):
        if remat and self.opt.remat and torch.is_grad_enabled():
            return checkpoint(block, layer, *args, use_reentrant=False)
        return block(layer, *args)

    # ------------------------------------------------------------------
    # encoder / decoder over full sequences
    # ------------------------------------------------------------------

    def enc_layer(self, layer: EncLayer, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """One encoder layer: bidirectional attention with rope at
        ``positions`` (the flash kernel under ``use_flash_kernel``), then
        the GELU MLP."""
        a, _ = self._attend(layer.attn, self._norm(layer.ln1, h), positions,
                            causal=False)
        h = h + a
        return h + common.mlp(layer.mlp, self._norm(layer.ln2, h),
                              self.policy)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, frontend_dim) -> the encoder's output (B, F,
        d_model): ``frontend_proj``, the encoder layers at positions
        0..F-1, ``enc_norm``."""
        h = common.dense(self.frontend_proj, frames, self.policy)
        positions = torch.arange(h.shape[1], device=h.device)
        for layer in self.enc_layers:
            h = self._run(self.enc_layer, layer, h, positions, remat=True)
        return self._norm(self.enc_norm, h)

    def dec_layer(self, layer: DecLayer, h: torch.Tensor,
                  positions: torch.Tensor, enc_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """One decoder layer over a full sequence; returns (h, (self k,
        self v, cross k, cross v)). The cross-attention reads the encoder's
        output at positions 0..F-1 without rope, through the plain
        attention (the JAX package takes flash for self-attention alone)."""
        a, (sk, sv) = self._attend(layer.self_attn,
                                   self._norm(layer.ln1, h), positions,
                                   causal=True)
        h = h + a
        c, (xk, xv) = self._attend(layer.cross_attn,
                                   self._norm(layer.ln_x, h), positions,
                                   causal=False, x_kv=enc_out)
        h = h + c
        h = h + common.mlp(layer.mlp, self._norm(layer.ln2, h), self.policy)
        return h, (sk, sv, xk, xv)

    def _decoder(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                 collect_cache: bool = False):
        """The decoder over ``tokens`` (B, L) attending to ``enc_out``;
        returns (``final_norm``'s output (B, L, d), the per-layer (self k,
        self v, cross k, cross v) where ``collect_cache``, else None)."""
        h = common.embed(self.embed, tokens)
        positions = torch.arange(h.shape[1], device=h.device)

        def block(layer, hh, out):
            return self.dec_layer(layer, hh, positions, out)

        caches = []
        for layer in self.dec_layers:
            h, kv = self._run(block, layer, h, enc_out,
                              remat=not collect_cache)
            if collect_cache:
                caches.append(kv)
        return self._norm(self.final_norm, h), \
            (caches if collect_cache else None)

    def forward(self, frames: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, L, V) of ``tokens`` given ``frames``."""
        h, _ = self._decoder(tokens, self.encode(frames))
        return common.dense(self.lm_head, h, self.policy)

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy of ``batch`` (``frames`` (B, F,
        frontend_dim), ``tokens`` and ``labels`` (B, L)); returns (loss,
        metrics ``ce``, ``aux`` (0) and ``ppl``) as the JAX ``loss``
        does, over chunks of ``ce_chunk`` tokens where that is set."""
        h, _ = self._decoder(batch["tokens"], self.encode(batch["frames"]))
        labels = batch["labels"]
        B, L, d = h.shape

        def head(hh):
            return common.dense(self.lm_head, hh, self.policy)

        if self.opt.ce_chunk:
            ce = chunked_ce(h.reshape(B * L, d), labels.reshape(B * L), head,
                            self.opt.ce_chunk)
        else:
            ce = -torch.mean(_token_ce(head(h), labels))
        return ce, {"ce": ce,
                    "aux": torch.zeros((), dtype=torch.float32,
                                       device=h.device),
                    "ppl": torch.exp(torch.clamp_max(ce, 20.0))}

    # ------------------------------------------------------------------
    # serving: prefill + greedy single-token decode
    # ------------------------------------------------------------------

    def cache_spec(self, batch: int, cap: int, enc_len: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Cache leaf shapes and dtypes (the JAX ``cache_spec``): the
        scalar ``idx``, ``self_k``/``self_v`` (n_layers, batch, cap,
        kv_eff, hd) and ``cross_k``/``cross_v`` (n_layers, batch, enc_len,
        kv_eff, hd)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        kv_eff = cfg.n_kv_heads * self.opt.kv_repeat
        nl = cfg.n_layers
        return {
            "idx": ((), torch.int32),
            "self_k": ((nl, batch, cap, kv_eff, hd), torch.float32),
            "self_v": ((nl, batch, cap, kv_eff, hd), torch.float32),
            "cross_k": ((nl, batch, enc_len, kv_eff, hd), torch.float32),
            "cross_v": ((nl, batch, enc_len, kv_eff, hd), torch.float32),
        }

    def init_cache(self, batch: int, cap: int, enc_len: int
                   ) -> Dict[str, torch.Tensor]:
        """Zeroed cache of :meth:`cache_spec`'s shapes on the model's
        device."""
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in self.cache_spec(batch, cap,
                                                      enc_len).items()}

    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor, cap: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Encode ``frames`` (B, F, frontend_dim), run the prompt
        ``tokens`` (B, L) through the decoder, build the cache (the self KV
        at positions 0..L-1 of ``cap``, the cross KV of the F frames) and
        return the last position's logits (B, 1, V). ``idx`` is the scalar
        L: every row shares the prompt length."""
        B, L = tokens.shape
        if L > cap:
            raise ValueError(f"prompt length {L} exceeds the cache "
                             f"capacity {cap}")
        enc_out = self.encode(frames)
        h, caches = self._decoder(tokens, enc_out, collect_cache=True)
        cache = self.init_cache(B, cap, enc_out.shape[1])
        for li, (sk, sv, xk, xv) in enumerate(caches):
            cache["self_k"][li, :, :L] = sk
            cache["self_v"][li, :, :L] = sv
            cache["cross_k"][li] = xk
            cache["cross_v"][li] = xv
        cache["idx"] = torch.tensor(L, dtype=torch.int32,
                                    device=tokens.device)
        # the last position as its own rows: the card's GEMM kernel reads
        # a contiguous x
        return common.dense(self.lm_head, h[:, -1:, :].contiguous(),
                            self.policy), cache

    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens: (B, 1) at position ``idx``. Returns (logits (B, 1, V),
        cache with idx + 1). Each layer's self KV takes the token's key and
        value in place (:func:`repro_torch.models.attention
        .attn_decode_step`); the cross KV is read, never written."""
        cfg, opt = self.cfg, self.opt
        h = common.embed(self.embed, tokens)
        idx = cache["idx"]
        kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                  kv_repeat=opt.kv_repeat)
        for li, layer in enumerate(self.dec_layers):
            a, _, _ = attention.attn_decode_step(
                layer.self_attn, self._norm(layer.ln1, h),
                cache["self_k"][li], cache["self_v"][li], idx, self.policy,
                **kw)
            h = h + a
            c, _, _ = attention.attn_decode_step(
                layer.cross_attn, self._norm(layer.ln_x, h),
                cache["cross_k"][li], cache["cross_v"][li], idx,
                self.policy, cross=True, **kw)
            h = h + c
            h = h + common.mlp(layer.mlp, self._norm(layer.ln2, h),
                               self.policy)
        h = self._norm(self.final_norm, h)
        return common.dense(self.lm_head, h, self.policy), \
            dict(cache, idx=idx + 1)
