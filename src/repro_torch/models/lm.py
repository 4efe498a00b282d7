"""Decoder-only LM: the dense, vlm, MoE, SSM and hybrid families (port of
``repro.models.lm``).

Pre-norm GQA attention + SwiGLU MLP per layer, with QKV bias and tied
embeddings as qwen2 has them, qk-norm as qwen3 has it and a sliding window
as mixtral has it. command-r's layers are parallel blocks (attention and the
MLP both read ``ln1(h)``; the layer returns ``h + a + m``). The vlm family
(internvl2) runs the same dense stack over ``[projected patch embeddings ;
text tokens]``: the ``frontend_proj`` MLP maps the stub vision tower's patch
embeddings into the LM stream. The MoE family (mixtral, qwen3-moe) replaces
the MLP by the routed experts of :mod:`repro_torch.models.moe`. The SSM
family (mamba2) stacks attention-free Mamba2 blocks
(:mod:`repro_torch.models.mamba2`) whose serving cache is the recurrent
state ``ssm`` (n_layers, B, H, P, N) and ``conv`` (n_layers, B, K-1,
conv_dim), O(1) per slot and dense under both layouts. The hybrid family
(zamba2) is that Mamba2 stack with ONE shared attention + MLP block
(:class:`SharedBlock`) applied after every ``attn_every``-th layer, the
same weights each time, on ``concat(hidden, emb0)``, ``emb0`` the step's
raw token embeddings; its serving cache adds a KV of its own per
application (``shared_k``/``shared_v``, or the pools ``shared_kp``/
``shared_vp`` through one block table). The JAX package's ``lax.scan`` over
stacked layers becomes a loop over an ``nn.ModuleList``. Serving caches come
in the dense layout (per-slot rings) and the paged one (global page pools
and per-slot block tables, :meth:`LM.cache_spec`), with the speculative
:meth:`LM.verify_step` and :meth:`LM.prefill_chunk` over the latter. The
enc-dec family is :class:`repro_torch.models.encdec.EncDec`; ``LM``
refuses its configs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import mirage_matmul_auto
from repro_torch.core.precision import MiragePolicy
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mamba2, moe
from repro_torch.obs import health as obs_health
from repro_torch.parallel import comm as pcomm
from repro_torch.runtime.paging import blocks_for

_ENCDEC = "an enc-dec config is built as repro_torch.models.encdec.EncDec " \
          "(models.build_model picks it)"


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
    logits (:func:`chunked_ce`). ``merge_parallel_proj`` runs a parallel
    block's two output projections as ONE GEMM, ``[a ; silu(gate) * up] @
    [w_o ; w_down]``, in the full-sequence forward (:meth:`LM.forward_hidden`,
    as in the JAX package; the serving steps keep the two): one row-sharded
    GEMM, so one tensor-parallel all-reduce a layer where the weights are
    sharded; on one device the same math in another order of sums.
    ``moe_impl`` picks the MoE layer on a mesh: ``"gspmd"``
    (:func:`repro_torch.models.moe.moe_apply`, the single-device function
    of the global batch) or ``"ep_shard_map"``
    (:func:`repro_torch.models.moe.moe_apply_ep`, routing per data shard)."""
    kv_repeat: int = 1          # repeat kv heads (exact duplication)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    remat: bool = False
    ce_chunk: int = 0           # chunked CE loss (0 = unchunked)
    merge_parallel_proj: bool = False   # command-r: one o/down GEMM
    moe_impl: str = "gspmd"     # gspmd | ep_shard_map (MoE on a mesh)
    use_flash_kernel: bool = False   # flash attention kernel (forward only)


def _token_ce(logits: torch.Tensor, labels: torch.Tensor,
              vocab=None) -> torch.Tensor:
    """Per-token log-likelihood of ``labels`` (clamped at 0) under f32
    ``logits`` (..., V). ``vocab`` (first row, rows, comm) marks logits of
    one vocab shard over ``model``: the max, the sum of exponentials and
    the label's logit then meet over ``model``
    (``logit - max - log(sum exp(logits - max))``, log_softmax's
    formula)."""
    logits = logits.to(torch.float32)
    labels = torch.clamp_min(labels, 0).long()
    if vocab is None:
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels[..., None])[..., 0]
    v0, v, comm = vocab
    m = comm.all_reduce(torch.amax(logits, dim=-1, keepdim=True), "model",
                        op=torch.distributed.ReduceOp.MAX)
    z = logits - m
    se = pcomm.reduce_from_tp(torch.sum(torch.exp(z), dim=-1), comm)
    local = labels - v0
    mine = (local >= 0) & (local < v)
    tl = torch.gather(z, -1, torch.clamp(local, 0, v - 1)[..., None])[..., 0]
    tl = pcomm.reduce_from_tp(tl * mine.to(tl.dtype), comm)
    return tl - torch.log(se)


def chunked_ce(h: torch.Tensor, labels: torch.Tensor, head_fn,
               chunk: int, vocab=None) -> torch.Tensor:
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
        ll_tok = _token_ce(head_fn(hh), ll, vocab)
        return -torch.sum(torch.where(ll >= 0, ll_tok,
                                      torch.zeros_like(ll_tok)))

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], chunk):
        total = total + checkpoint(body, h[i:i + chunk], labels[i:i + chunk],
                                   use_reentrant=False)
    return total / T


class _AttnLayer(nn.Module):
    """The pre-norm attention half that every ported layer kind shares."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.ln1 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.attn = attention.Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.qkv_bias, cfg.qk_norm, generator=generator, device=device)
        self.ln2 = common.Norm(cfg.d_model, cfg.norm_type, device=device)


class Layer(_AttnLayer):
    """An ``attn_mlp`` layer: attention, then the SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__(cfg, generator=generator, device=device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, False,
                              generator=generator, device=device)


class FrontendProj(nn.Module):
    """The vlm projector of the stub vision tower's patch embeddings:
    ``fc2(gelu(fc1(x)))``, ``fc1`` frontend_dim -> d_model, ``fc2`` d_model
    -> d_model, no biases (the JAX package's ``frontend_proj``)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.fc1 = common.Dense(cfg.frontend_dim, cfg.d_model, **kw)
        self.fc2 = common.Dense(cfg.d_model, cfg.d_model, **kw)


class MoELayer(_AttnLayer):
    """An ``attn_moe`` layer: attention, then the routed experts."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__(cfg, generator=generator, device=device)
        self.moe = moe.MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff,
                           generator=generator, device=device)


class MambaLayer(nn.Module):
    """A ``mamba`` layer: the pre-norm Mamba2 block."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.ln1 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.mamba = mamba2.Mamba(cfg, generator=generator, device=device)


class SharedBlock(nn.Module):
    """The hybrid family's shared block (the JAX ``params["shared"]``):
    ``proj`` (2 d_model -> d_model) over ``concat(hidden, emb0)``, then a
    pre-norm attention (no qkv bias, no qk-norm) and SwiGLU MLP. One set of
    weights, applied after every ``attn_every``-th Mamba2 layer."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.proj = common.Dense(2 * cfg.d_model, cfg.d_model, **kw)
        self.ln1 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.attn = attention.Attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            False, False, **kw)
        self.ln2 = common.Norm(cfg.d_model, cfg.norm_type, device=device)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, False, **kw)


def _write_state(dst: torch.Tensor, new: torch.Tensor,
                 keep: Optional[torch.Tensor]) -> None:
    """Write a recurrent-state leaf in place (a captured graph replays the
    write): ``new`` where ``keep`` (S,) is true, else the old value."""
    if keep is not None:
        new = torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)),
                          new, dst)
    dst.copy_(new)


def check_policy(cfg: ModelConfig, policy: MiragePolicy) -> None:
    """Raise where ``policy``'s GEMM backend cannot run ``cfg``'s layers:
    the MoE family's expert stacks need a backend that takes stacked
    weights (``supports_batched_weights``; every built-in mode does)."""
    from repro_torch.core import backends

    if cfg.family == "moe" and \
            not backends.resolve(policy).supports_batched_weights:
        raise TypeError(
            f"{cfg.arch_id} under {policy.mode!r}: the GEMM backend takes "
            f"one (K, N) weight, not the MoE layer's expert stacks")


class LM(nn.Module):
    """The dense, vlm, MoE, SSM or hybrid LM. Weights are drawn from
    ``generator`` (default: seed 0 on ``device``) with the JAX package's
    initializers, in the port's own order (embedding, layers, head, shared
    block, frontend projector); to compute the same function as a JAX
    model, load its parameters with
    :func:`repro_torch.interop.load_jax_params`."""

    #: the layer stack, named as the JAX tree's stacked subtree
    stacks = ("layers",)
    #: :func:`repro_torch.parallel.shard.shard_model` places this model
    supports_mesh = True
    #: the mesh's comm once the model is sharded (None: one device)
    comm = None

    def __init__(self, cfg: ModelConfig, policy: MiragePolicy,
                 options: LMCallOptions = LMCallOptions(), *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kinds = set(cfg.layer_kinds())
        if cfg.is_encdec or cfg.frontend not in (None, "vit_stub"):
            raise ValueError(f"{cfg.arch_id}: {_ENCDEC}")
        if len(kinds) != 1 or \
                not kinds <= {"attn_mlp", "attn_moe", "mamba"}:
            raise ValueError(f"{cfg.arch_id}: layer kinds {sorted(kinds)} "
                             f"are not a decoder-only LM's")
        self.kind = kinds.pop()
        if (cfg.family == "hybrid") != (cfg.attn_every > 0):
            raise ValueError(
                f"{cfg.arch_id}: a shared attention block (attn_every = "
                f"{cfg.attn_every}) belongs to the hybrid family's Mamba2 "
                f"stack alone (family {cfg.family!r})")
        check_policy(cfg, policy)
        self.cfg = cfg
        self.policy = policy
        self.opt = options
        #: applications of the shared block (one after every attn_every-th
        #: layer); 0 outside the hybrid family
        self.napp = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        # the JAX package's test for the parallel block
        self.parallel = cfg.arch_id.startswith("command-r")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        kw = dict(generator=generator, device=device)
        self.embed = common.Embed(cfg.vocab_size, cfg.d_model, **kw)
        layer_cls = {"attn_moe": MoELayer, "mamba": MambaLayer}.get(
            self.kind, Layer)
        self.layers = nn.ModuleList(layer_cls(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.Norm(cfg.d_model, cfg.norm_type,
                                      device=device)
        self.lm_head = None if cfg.tie_embeddings else common.Dense(
            cfg.d_model, cfg.vocab_size, False, scale=0.02, **kw)
        self.shared = SharedBlock(cfg, **kw) if cfg.family == "hybrid" \
            else None
        self.frontend_proj = FrontendProj(cfg, **kw) \
            if cfg.frontend is not None else None

    @property
    def device(self) -> torch.device:
        """Where the parameters live (follows ``.to(...)``)."""
        return self.embed.emb.device

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------

    def _embed_inputs(self, tokens: torch.Tensor,
                      extra_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, int]:
        """The token embeddings, led by the projected patch embeddings
        ``extra_embeds`` (B, P, frontend_dim) where given; returns (h,
        n_prefix). The projector's activation is the JAX package's
        ``jax.nn.gelu``, whose default is the tanh approximation."""
        h = common.embed(self.embed, tokens)
        if extra_embeds is None:
            return h, 0
        if self.frontend_proj is None:
            raise ValueError(f"{self.cfg.arch_id} has no frontend to take "
                             f"extra_embeds")
        proj = self.frontend_proj
        pe = common.dense(proj.fc2, torch.nn.functional.gelu(
            common.dense(proj.fc1, extra_embeds, self.policy),
            approximate="tanh"), self.policy)
        return torch.cat([pe, h], dim=1), extra_embeds.shape[1]

    def _head_local(self, h: torch.Tensor):
        """The final norm and the head: (logits, vocab), ``vocab`` (first
        row, rows, comm) where the logits are one vocab shard over
        ``model`` (a vocab-parallel tied table or a column-parallel
        ``lm_head``), else None."""
        cfg = self.cfg
        h = common.norm(self.final_norm, h, cfg.norm_eps, cfg.norm_type)
        if self.lm_head is None:
            return common.unembed(self.embed, h, self.policy), self._vocab()
        logits = common.dense(self.lm_head,
                              common.tp_inputs(h, self.lm_head)[0],
                              self.policy)
        return logits, self._vocab()

    def _vocab(self):
        """(first row, rows, comm) of the rank's vocab shard of the head,
        or None where the head's logits cover the whole vocab."""
        if self.lm_head is None:
            return common.vocab_range(self.embed)
        dim, comm = common.tp_dim(self.lm_head)
        if dim != 1:
            return None
        v = self.lm_head.w.shape[1]
        return comm.tp_rank * v, v, comm

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The logits over the whole vocab (gathered over ``model`` where
        the head is vocab-sharded)."""
        logits, vocab = self._head_local(h)
        if vocab is None:
            return logits
        return pcomm.gather_tp(logits, vocab[2], logits.dim() - 1)

    def _attn_mlp_block(self, layer: Union[Layer, MoELayer],
                        h: torch.Tensor, positions: torch.Tensor,
                        merge: bool = False):
        """One layer over a full sequence; returns (h, (k, v), aux), aux
        the MoE layer's router loss (0 for a dense layer). ``merge`` runs a
        parallel block's projections as one GEMM (``merge_parallel_proj``;
        :meth:`forward_hidden` alone asks for it, as in the JAX package)."""
        cfg, opt = self.cfg, self.opt
        merge = merge and self.parallel
        n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
        a, kv = attention.attn_apply(
            layer.attn, n1, self.policy, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            positions=positions, rope_theta=cfg.rope_theta, causal=True,
            window=cfg.sliding_window, qk_norm=cfg.qk_norm,
            kv_repeat=opt.kv_repeat, q_chunk=opt.q_chunk,
            kv_chunk=opt.kv_chunk, use_flash=opt.use_flash_kernel,
            skip_o_proj=merge)
        if merge:
            return self._merged_tail(layer, h, n1, a), kv, \
                torch.zeros((), dtype=torch.float32, device=h.device)
        h, aux = self._ffn_tail(layer, h, n1, a)
        return h, kv, aux

    def _mamba_block(self, layer: MambaLayer, h: torch.Tensor
                     ) -> torch.Tensor:
        """One Mamba2 layer over a full sequence: ``h + mamba(ln1(h))``."""
        cfg = self.cfg
        n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
        return h + mamba2.mamba_apply(layer.mamba, n1, cfg, self.policy)

    def _applies_shared(self, li: int) -> Optional[int]:
        """The shared block's application index after layer ``li`` (JAX's
        ``(li + 1) // attn_every - 1``), or None where it does not run."""
        every = self.cfg.attn_every
        if every and (li + 1) % every == 0:
            return (li + 1) // every - 1
        return None

    def _shared_apply(self, h: torch.Tensor, emb0: torch.Tensor,
                      attend) -> torch.Tensor:
        """One application of the shared block: ``u = proj(cat[h, emb0])``,
        ``u = u + attend(attn, ln1(u))``, then ``h + u + mlp(ln2(u))``, the
        JAX ``_shared_block``'s order of adds. ``attend(attn_module, x)``
        is the step's attention (full sequence, decode, verify or chunk),
        which reads and writes the application's KV itself. Its GEMMs are
        not counted in the health counters: the JAX package runs the block
        under ``obs.health.suppressed`` (its ``lax.cond`` branch has no
        channel to carry them out)."""
        cfg, sp = self.cfg, self.shared
        with obs_health.suppressed():
            u = common.dense(sp.proj, torch.cat([h, emb0], dim=-1),
                             self.policy)
            n1 = common.norm(sp.ln1, u, cfg.norm_eps, cfg.norm_type)
            u = u + attend(sp.attn, n1)
            n2 = common.norm(sp.ln2, u, cfg.norm_eps, cfg.norm_type)
            return h + u + common.mlp(sp.mlp, n2, self.policy)

    def _shared_full(self, h: torch.Tensor, emb0: torch.Tensor,
                     positions: torch.Tensor, use_flash: bool = False
                     ) -> Tuple[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
        """The shared block over a full sequence; returns (h, (k, v)), the
        application's keys and values for a prefill's cache. Training
        never takes the flash kernel here (the JAX ``_shared_block`` passes
        no options); serving's prefill does where its options ask."""
        cfg, opt = self.cfg, self.opt
        kv = []

        def attend(attn, x):
            a, kv_ = attention.attn_apply(
                attn, x, self.policy, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                positions=positions, rope_theta=cfg.rope_theta, causal=True,
                kv_repeat=opt.kv_repeat, q_chunk=opt.q_chunk,
                kv_chunk=opt.kv_chunk, use_flash=use_flash)
            kv.append(kv_)
            return a

        return self._shared_apply(h, emb0, attend), kv[0]

    def _ffn_tail(self, layer: Union[Layer, MoELayer], h: torch.Tensor,
                  n1: torch.Tensor, a: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The residual and FFN after attention (the JAX
        ``_post_attn_combine``), given the layer's input ``h``, its first
        norm ``n1`` and the attention output ``a``: the routed experts, the
        parallel block's MLP on ``n1`` (``h + a + m``), or the pre-norm MLP
        on ``ln2(h + a)``; returns (h, aux)."""
        cfg = self.cfg
        if self.kind == "attn_moe":
            h = h + a
            n2 = common.norm(layer.ln2, h, cfg.norm_eps, cfg.norm_type)
            apply = (moe.moe_apply_ep if self.opt.moe_impl == "ep_shard_map"
                     else moe.moe_apply)
            m, aux = apply(
                layer.moe, n2, self.policy, n_experts=cfg.n_experts,
                experts_per_token=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor, comm=self.comm)
            return h + m, aux
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        if self.parallel:
            # ln2 is a parameter of the layer (the JAX init draws it) that
            # the parallel block never reads
            return h + a + common.mlp(layer.mlp, n1, self.policy), zero
        h = h + a
        n2 = common.norm(layer.ln2, h, cfg.norm_eps, cfg.norm_type)
        return h + common.mlp(layer.mlp, n2, self.policy), zero

    def _merged_tail(self, layer: Layer, h: torch.Tensor, n1: torch.Tensor,
                     ctx: torch.Tensor) -> torch.Tensor:
        """A parallel block's tail with ``merge_parallel_proj``: the
        attention context ``ctx`` (B, L, H * D, before its output
        projection) and the MLP's hidden ``silu(gate) * up`` go through ONE
        GEMM against ``[w_o ; w_down]``. The two contractions' BFP groups
        stay whole (H * D and d_ff are multiples of g)."""
        mlp = layer.mlp
        xg, xu = common.tp_inputs(n1, mlp.gate, mlp.up)
        hh = torch.nn.functional.silu(common.dense(mlp.gate, xg,
                                                   self.policy)) \
            * common.dense(mlp.up, xu, self.policy)
        cat = torch.cat([ctx, hh], dim=-1)
        w_cat = torch.cat([common.weight(layer.attn.o),
                           common.weight(mlp.down)], dim=0)
        y = mirage_matmul_auto(cat, w_cat, self.policy)
        dim, comm = common.tp_dim(layer.attn.o)
        if dim == 0:
            # row-parallel on both halves: ONE all-reduce for the layer
            y = pcomm.reduce_from_tp(y, comm)
        return h + y

    # ------------------------------------------------------------------
    # forward (train / logits over the full sequence)
    # ------------------------------------------------------------------

    def forward_hidden(self, tokens: torch.Tensor,
                       extra_embeds: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Run the layer stack over the tokens, led by the projected
        ``extra_embeds`` (the vlm's patches) where given; returns (hidden,
        aux, n_prefix): aux is the router loss summed over the layers (0
        for the dense family), n_prefix the patch positions leading
        ``hidden``. The hybrid family's shared block follows every
        ``attn_every``-th layer inside that layer's checkpointed unit
        (``remat``), with the embeddings ``emb0`` an input of the unit."""
        h, n_prefix = self._embed_inputs(tokens, extra_embeds)
        positions = torch.arange(h.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        merge = self.opt.merge_parallel_proj
        emb0 = h

        def block(layer, hh, e0, app):
            if self.kind == "mamba":
                hh = self._mamba_block(layer, hh)
                if app is not None:
                    hh = self._shared_full(hh, e0, positions)[0]
                return hh, torch.zeros((), dtype=torch.float32,
                                       device=hh.device)
            out, _, aux_l = self._attn_mlp_block(layer, hh, positions, merge)
            return out, aux_l

        for li, layer in enumerate(self.layers):
            app = self._applies_shared(li)
            if self.opt.remat and torch.is_grad_enabled():
                h, aux_l = checkpoint(block, layer, h, emb0, app,
                                      use_reentrant=False)
            else:
                h, aux_l = block(layer, h, emb0, app)
            aux = aux + aux_l
        return h, aux, n_prefix

    def forward(self, tokens: torch.Tensor,
                extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: (B, L) -> logits (B, P + L, V), P the patch positions
        of ``extra_embeds`` (the JAX ``forward``'s first output; its aux
        and prefix are those of :meth:`forward_hidden`)."""
        with common.gathered(self.embed, "emb"):
            return self._head(self.forward_hidden(tokens, extra_embeds)[0])

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels``, (B, L); the vlm's ``patches`` (B, P, frontend_dim) lead
        the sequence and are dropped before the head) plus the router loss;
        returns (loss, metrics ``ce``, ``aux``, ``ppl``) as the JAX
        ``loss`` does."""
        tokens, labels = batch["tokens"], batch["labels"]
        # the tied table's FSDP gather, once for the embedding and the head
        with common.gathered(self.embed, "emb"):
            h, aux, n_prefix = self.forward_hidden(tokens,
                                                   batch.get("patches"))
            h = h[:, n_prefix:, :]
            B, L, d = h.shape
            if self.opt.ce_chunk:
                ce = chunked_ce(h.reshape(B * L, d), labels.reshape(B * L),
                                lambda hh: self._head_local(hh)[0],
                                self.opt.ce_chunk, self._vocab())
            else:
                ce = -torch.mean(_token_ce(*self._head_local(h)[:1], labels,
                                           self._vocab()))
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
        mask, so paged capacity is ``cap`` positions. The SSM family's
        recurrent state, ``ssm`` ``(n_layers, batch, H, P, N)`` and
        ``conv`` ``(n_layers, batch, K-1, conv_dim)``, is O(1) per slot and
        dense under both layouts: a pure SSM has no KV, pool or table. The
        hybrid family adds its shared block's KV, indexed by application
        (``napp = n_layers // attn_every``): the rings ``shared_k``/
        ``shared_v`` ``(napp, batch, cache_len, kv_eff, hd)``, or the pools
        ``shared_kp``/``shared_vp`` ``(napp, n_blocks, block_size, kv_eff,
        hd)`` with one table ``bt`` for every application."""
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
        prefix = ""
        if self.kind == "mamba":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            spec["ssm"] = ((nl, batch, cfg.ssm_heads, cfg.ssm_headdim,
                            cfg.ssm_state), torch.float32)
            spec["conv"] = ((nl, batch, cfg.ssm_conv - 1, conv_dim),
                            torch.float32)
            if not cfg.attn_every:
                return spec
            nl, prefix = self.napp, "shared_"
        if paged:
            mb = blocks_for(cap, block_size)
            nb = n_blocks if n_blocks is not None else batch * mb
            for leaf in ("kp", "vp"):
                spec[prefix + leaf] = ((nl, nb, block_size, kv_eff, hd),
                                       torch.float32)
            spec["bt"] = ((batch, mb), torch.int32)
        else:
            shape = (nl, batch, self.cache_len(cap), kv_eff, hd)
            spec[prefix + "k"] = (shape, torch.float32)
            spec[prefix + "v"] = (shape, torch.float32)
        return spec

    def init_cache(self, batch: int, cap: int, per_slot_idx: bool = False,
                   layout: str = "dense", block_size: int = 16,
                   n_blocks: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
        """Zeroed cache of :meth:`cache_spec`'s shapes on the model's
        device; unmapped block-table entries hold the sentinel
        ``n_blocks``. On a mesh (the model sharded) each leaf is cut over
        ``model`` as :func:`repro_torch.parallel.sharding.cache_spec`
        places it (the rank's kv heads) and kept whole over the batch
        axes: the cache a rank's prefill fills for the whole batch."""
        spec = self.cache_spec(batch, cap, per_slot_idx, layout=layout,
                               block_size=block_size, n_blocks=n_blocks)
        if self.comm is not None:
            from repro_torch.parallel.shard import tp_local_shape
            spec = {k: (tp_local_shape(self.comm, self.cfg, k, shape), dt)
                    for k, (shape, dt) in spec.items()}
        cache = {k: torch.zeros(shape, dtype=dt, device=self.device)
                 for k, (shape, dt) in spec.items()}
        if "bt" in cache:
            cache["bt"].fill_(spec[pool_keys(spec)[0]][0][1])
        return cache

    def prefill(self, tokens: torch.Tensor, cap: int,
                lens: Optional[torch.Tensor] = None,
                extra_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the prompt, build the cache, return last-position logits.

        ``lens``: optional ``(B,)`` true prompt lengths for right-padded
        batched prefill. The logits are then taken at each row's last REAL
        token and the cache's per-slot ``idx`` is ``lens``; decode
        overwrites the padded positions one token at a time while the
        validity mask hides them (exact for attention: the causal mask keeps
        real positions from reading padded ones).

        ``extra_embeds`` (the vlm's patches, (B, P, frontend_dim)) lead the
        prompt, as in the JAX package: the P projected positions take
        positions 0..P-1 in the sequence and the cache, the tokens follow,
        and ``idx`` (without ``lens``) is P + L; ``lens`` then counts
        positions of that whole sequence.

        The SSM family's cache is each layer's final ``ssm`` and ``conv``
        state. Its recurrence carries state through padded steps, so its
        callers pad to the exact length (``lens == L``), as the engine's
        exact-length prefill batches do. The hybrid family's shared block
        reads the prompt's embeddings as ``emb0`` and writes each
        application's keys and values into ``shared_k``/``shared_v`` at
        positions 0..L-1 (the last ``cache_len`` of them where L is longer,
        with no ring roll, as in the JAX package)."""
        h, _ = self._embed_inputs(tokens, extra_embeds)
        B, L = h.shape[0], h.shape[1]
        cache_len = self.cache_len(cap)
        if lens is not None and L > cache_len:
            raise ValueError(
                f"padded prefill length {L} exceeds cache capacity "
                f"{cache_len}; raise cap or shrink the bucket")
        positions = torch.arange(L, device=tokens.device)
        cache = self.init_cache(B, cap)
        # keep the last cache_len positions in ring layout (pos % cache_len)
        keep = min(L, cache_len)
        roll = max(L - cache_len, 0) % cache_len
        cfg = self.cfg
        emb0 = h
        for li, layer in enumerate(self.layers):
            if self.kind == "mamba":
                n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
                o, (st, cv) = mamba2.mamba_apply(
                    layer.mamba, n1, cfg, self.policy, return_cache=True)
                h = h + o
                cache["ssm"][li] = st
                cache["conv"][li] = cv
                app = self._applies_shared(li)
                if app is not None:
                    h, (kk, vv) = self._shared_full(
                        h, emb0, positions, self.opt.use_flash_kernel)
                    cache["shared_k"][app, :, :keep] = kk[:, L - keep:]
                    cache["shared_v"][app, :, :keep] = vv[:, L - keep:]
                continue
            h, (kk, vv), _ = self._attn_mlp_block(layer, h, positions)
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
                    tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens: (B, 1). Returns (logits (B, 1, V), cache with idx + 1).

        The layout follows the cache's keys: a ``bt`` leaf selects the
        paged pools ``kp``/``vp``, else the dense rings ``k``/``v``. Either
        is updated in place (see
        :func:`repro_torch.models.attention.attn_decode_step`). The SSM
        family's ``ssm``/``conv`` state is updated in place too, except
        for the rows where the (B,) bool ``active`` is false, which keep
        their state (the engine's inactive slots; the JAX engine's tick
        masks them after the step, with the same values). The hybrid
        family's shared block reads this token's embedding as ``emb0`` and
        its application's KV through the same path as an attention layer;
        an inactive slot's KV write lands at its frozen position, which its
        next real write overwrites."""
        cfg = self.cfg
        h = common.embed(self.embed, tokens)
        idx = cache["idx"]
        bt = cache.get("bt")
        prefix = "shared_" if self.kind == "mamba" else ""
        k_key, v_key = (pool_keys(cache) if bt is not None
                        else (prefix + "k", prefix + "v"))
        plan = None if bt is None else attention.page_plan(
            bt, idx, *cache[k_key].shape[1:3])

        def attend(ck, cv, window, qk_norm):
            def run(attn, x):
                return attention.attn_decode_step(
                    attn, x, ck, cv, idx, self.policy, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    rope_theta=cfg.rope_theta, window=window,
                    qk_norm=qk_norm, kv_repeat=self.opt.kv_repeat,
                    block_tables=bt, plan=plan)[0]
            return run

        if self.kind == "mamba":
            emb0 = h
            for li, layer in enumerate(self.layers):
                n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
                o, st, cv = mamba2.mamba_decode_step(
                    layer.mamba, n1, cfg, self.policy, cache["ssm"][li],
                    cache["conv"][li])
                h = h + o
                _write_state(cache["ssm"][li], st, active)
                _write_state(cache["conv"][li], cv, active)
                app = self._applies_shared(li)
                if app is not None:
                    h = self._shared_apply(h, emb0, attend(
                        cache[k_key][app], cache[v_key][app], None, False))
            return self._head(h), dict(cache, idx=idx + 1)
        for li, layer in enumerate(self.layers):
            n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
            a = attend(cache[k_key][li], cache[v_key][li],
                       cfg.sliding_window, cfg.qk_norm)(layer.attn, n1)
            h = self._ffn_tail(layer, h, n1, a)[0]
        return self._head(h), dict(cache, idx=idx + 1)

    def verify_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                               Optional[Dict[str, torch.Tensor]]]:
        """Speculative-decoding verify over a PAGED cache: score ``T``
        tokens per slot in one step.

        tokens: ``(S, T)``, per slot ``[current token ; T-1 drafts]`` at
        positions ``idx[s] .. idx[s]+T-1``. Returns ``(logits (S, T, V),
        cache, steps)``; ``idx`` is NOT advanced (the caller commits the
        accepted count). ``steps`` is None for the attention families. For
        the SSM and hybrid families it is ``{"ssm": (nl, T, S, H, P, N),
        "conv": (nl, T, S, K-1, C)}``, the recurrent state AFTER each of the
        ``T`` tokens (the per-token ``mamba_decode_step`` recurrence,
        token-exact against one-token decode), so the caller can roll back
        to the accepted position (``steps[...][:, a-1]``). The live ``ssm``/
        ``conv`` tensors are left as they were; the returned cache holds
        the full-T state (``steps[...][:, -1]``). The hybrid family's
        shared block writes all T tokens' KV of each application into its
        pools, as an attention layer does; the rejected tail needs no
        rollback there either."""
        cfg = self.cfg
        h = common.embed(self.embed, tokens)
        idx, bt = cache["idx"], cache.get("bt")
        plan = None
        if bt is None and (self.kind != "mamba" or self.napp):
            raise ValueError("the verify step requires the paged layout")
        if bt is not None:
            pos = idx[:, None] + torch.arange(tokens.shape[1],
                                              device=idx.device)[None, :]
            k_key, v_key = pool_keys(cache)
            plan = attention.page_plan(bt, pos, *cache[k_key].shape[1:3])

        def attend(ck, cv, window, qk_norm):
            def run(attn, x):
                return attention.attn_verify_step(
                    attn, x, ck, cv, idx, self.policy, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    rope_theta=cfg.rope_theta, window=window,
                    qk_norm=qk_norm, kv_repeat=self.opt.kv_repeat,
                    block_tables=bt, plan=plan)[0]
            return run

        if self.kind == "mamba":
            emb0 = h
            T = tokens.shape[1]
            steps = {k: torch.empty((cfg.n_layers, T) + cache[k].shape[1:],
                                    dtype=cache[k].dtype, device=h.device)
                     for k in ("ssm", "conv")}
            for li, layer in enumerate(self.layers):
                n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
                # token-major, so each token's (S, 1, d) rows are
                # contiguous, as the card's GEMM kernel takes them
                n1 = n1.transpose(0, 1).contiguous()
                st, cv = cache["ssm"][li], cache["conv"][li]
                outs = []
                for t in range(T):
                    o, st, cv = mamba2.mamba_decode_step(
                        layer.mamba, n1[t][:, None], cfg, self.policy, st,
                        cv)
                    outs.append(o)
                    steps["ssm"][li, t] = st
                    steps["conv"][li, t] = cv
                h = h + torch.cat(outs, dim=1)
                app = self._applies_shared(li)
                if app is not None:
                    h = self._shared_apply(h, emb0, attend(
                        cache[k_key][app], cache[v_key][app], None, False))
            return self._head(h), dict(cache, ssm=steps["ssm"][:, -1],
                                       conv=steps["conv"][:, -1]), steps
        for li, layer in enumerate(self.layers):
            n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
            a = attend(cache[k_key][li], cache[v_key][li],
                       cfg.sliding_window, cfg.qk_norm)(layer.attn, n1)
            h = self._ffn_tail(layer, h, n1, a)[0]
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
        last real token, cache) with ``idx[slot] = pos0 + true_len``.

        The SSM family reads the slot's ``ssm``/``conv`` state and writes
        it back in place, ``pos0 == 0`` starting from zeros (a reused
        slot's stale state must not leak into a new request); its
        recurrence runs through every step, so its callers send
        exact-length chunks (``true_len == C``). The hybrid family's
        shared block reads the chunk's embeddings as ``emb0`` and writes
        each application's KV into its pools through the slot's table."""
        cfg, opt = self.cfg, self.opt
        h = common.embed(self.embed, tokens)
        bt = cache.get("bt")
        plan = None
        if bt is not None:
            bt_row = bt[slot]
            k_key, v_key = pool_keys(cache)
            plan = attention.chunk_plan(bt_row, pos0, tokens.shape[1],
                                        true_len, *cache[k_key].shape[1:3])

        def attend(kp, vp, window, qk_norm):
            def run(attn, x):
                return attention.attn_chunk_step(
                    attn, x, kp, vp, bt_row, pos0, true_len, self.policy,
                    n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    rope_theta=cfg.rope_theta, window=window,
                    qk_norm=qk_norm, kv_repeat=opt.kv_repeat,
                    q_chunk=opt.q_chunk, kv_chunk=opt.kv_chunk,
                    plan=plan)[0]
            return run

        if self.kind == "mamba":
            emb0 = h
            for li, layer in enumerate(self.layers):
                st = cache["ssm"][li, slot:slot + 1]
                cv = cache["conv"][li, slot:slot + 1]
                if pos0 == 0:
                    st, cv = torch.zeros_like(st), torch.zeros_like(cv)
                n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
                o, (st2, cv2) = mamba2.mamba_apply(
                    layer.mamba, n1, cfg, self.policy, init_state=st,
                    conv_state=cv, return_cache=True)
                h = h + o
                cache["ssm"][li, slot] = st2[0]
                cache["conv"][li, slot] = cv2[0]
                app = self._applies_shared(li)
                if app is not None:
                    h = self._shared_apply(h, emb0, attend(
                        cache[k_key][app], cache[v_key][app], None, False))
        else:
            for li, layer in enumerate(self.layers):
                n1 = common.norm(layer.ln1, h, cfg.norm_eps, cfg.norm_type)
                a = attend(cache[k_key][li], cache[v_key][li],
                           cfg.sliding_window, cfg.qk_norm)(layer.attn, n1)
                h = self._ffn_tail(layer, h, n1, a)[0]
        cache["idx"][slot] = pos0 + true_len
        last = max(true_len - 1, 0)
        return self._head(h[:, last:last + 1]), cache


# --------------------------------------------------------------------------
# Stacked-cache helpers of the continuous-batching engine. A stacked cache's
# batch dim is the slot dim and its "idx" a per-slot vector; the paged
# layout adds the global pools (NOT per slot) and the per-slot table "bt".
# --------------------------------------------------------------------------

PAGE_POOL_LEAVES = ("kp", "vp", "shared_kp", "shared_vp")
# paged pool leaf -> the dense prefill leaf whose rows scatter into it
_POOL_SRC = {"kp": "k", "vp": "v", "shared_kp": "shared_k",
             "shared_vp": "shared_v"}


def pool_keys(cache) -> Tuple[str, str]:
    """The (keys, values) page-pool leaves of a paged cache (or of its
    :meth:`LM.cache_spec`): ``kp``/``vp`` of the attention families,
    ``shared_kp``/``shared_vp`` of the hybrid family. Their block dim (1)
    and block size (2) are the pool's."""
    return ("kp", "vp") if "kp" in cache else ("shared_kp", "shared_vp")


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
                 slots: torch.Tensor, pages: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Scatter a batched prefill cache into the live per-slot cache.

    ``new`` is a DENSE prefill cache of ``B_new`` rows; ``slots`` the
    ``(B_new,)`` destination slot per row. Rows whose slot is out of bounds
    (the ``>= n_slots`` sentinel that pads admission groups to a power of
    two) are dropped: they are masked out before the scatter, which is what
    the JAX package's ``mode="drop"`` does on device. Pass ``slots`` on the
    host to keep the mask off the device. When ``live`` is PAGED, the
    dense ``k``/``v`` rows go through the live block tables into the pools
    (the rows' blocks must be mapped already; unmapped ones drop). The live
    leaves are written in place and returned. ``pages`` (``(B_new,
    max_blocks)``) are the tables every row's KV goes through instead,
    whatever its slot (a meshed engine's rank writes the pages homed on
    its shard of every row, the others dropped)."""
    rows = torch.nonzero(slots < live["idx"].shape[0])[:, 0]
    dst = slots[rows].to(live["idx"].device)
    src = rows.to(new["idx"].device)
    for name, leaf in live.items():
        if name == "bt":
            continue
        if name in PAGE_POOL_LEAVES:
            if pages is not None:
                _scatter_pages(leaf, new[_POOL_SRC[name]],
                               pages.to(leaf.device))
            elif rows.numel():
                _scatter_pages(leaf, new[_POOL_SRC[name]][:, src],
                               live["bt"][dst])
        elif rows.numel() == 0:
            continue
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
