"""Sharding rules: FSDP x TP x EP x SP over the production mesh (port of
``repro.parallel.sharding``).

Logical roles:
  fsdp  -> 'data'   (parameters + optimizer state sharded at rest and
                     gathered per layer: ZeRO-3 style)
  tp    -> 'model'  (Megatron column/row GEMM sharding)
  ep    -> 'model'  (expert dim of MoE weights/buffers when E % tp == 0)
  dp    -> ('pod', 'data')  (batch; the pod axis is an outer DP axis)
  sp    -> 'data'   (sequence axis of long-context decode caches)

Every rule degrades gracefully: an axis is applied to a tensor dim only
when the dim is divisible by the axis size, so odd head counts (qwen2's 14
heads, qwen3's 40) fall back to replication on that dim instead of failing.

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of axis names; it equals ``tuple(PartitionSpec(...))`` of the JAX
rule for the same leaf, entry for entry. The tree functions take and
return flat dicts keyed by the JAX package's ``/``-joined leaf paths
(``layers/attn/q/w``, ``opt/m/embed/emb``, ``cache/k``), with the layer
stacks' leading dim, so each spec compares one to one with JAX's; a leaf
is a shape or anything with a ``shape``. A mesh is anything with
``shape`` and ``mesh_dim_names`` (a ``DeviceMesh``, or a
:class:`repro_torch.launch.mesh.MeshShape`), or a mapping of axis sizes.
Nothing here touches a device or a process group.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig

Spec = Tuple[Any, ...]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axsize(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= _axsize(mesh, a)
        return n
    return mesh_sizes(mesh).get(name, 1)


def _fit(mesh, shape: Tuple[int, ...], want: Tuple[Any, ...]) -> Spec:
    """Keep each requested axis only if the dim divides evenly."""
    assert len(want) == len(shape), (shape, want)
    out = []
    for dim, ax in zip(shape, want):
        if ax is None:
            out.append(None)
        elif dim % _axsize(mesh, ax) == 0 and _axsize(mesh, ax) > 1:
            # a one-axis tuple is that axis (PartitionSpec's normal form)
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                       else ax)
        else:
            out.append(None)
    return tuple(out)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def tp_size(mesh) -> int:
    return _axsize(mesh, "model")


def kv_repeat_for(cfg: ModelConfig, mesh) -> int:
    """Repeat KV heads so attention shards over the full TP degree (value-
    identical). Only when head counts divide cleanly."""
    tp = tp_size(mesh)
    H, kv = cfg.n_heads, cfg.n_kv_heads
    if cfg.family in ("ssm",):
        return 1
    if H % tp == 0 and kv < tp and tp % kv == 0:
        return tp // kv
    return 1


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


# --------------------------------------------------------------------------
# parameter specs (path-pattern -> dim roles)
# --------------------------------------------------------------------------

_PARAM_RULES = (
    # (path regex, roles per dim)  — roles resolved below
    (r"embed/emb$",            ("tp", "fsdp")),  # vocab-parallel
    (r"lm_head/w$",            ("fsdp", "tp")),
    (r"(attn|self_attn|cross_attn)/(q|k|v)/w$", ("fsdp", "tp")),
    (r"(attn|self_attn|cross_attn)/o/w$",       ("tp", "fsdp")),
    (r"(attn|self_attn|cross_attn)/(q|k|v)/b$", ("tp",)),
    (r"(attn|self_attn|cross_attn)/o/b$",       (None,)),
    (r"mlp/(gate|up)/w$",      ("fsdp", "tp")),
    (r"mlp/down/w$",           ("tp", "fsdp")),
    (r"mlp/(gate|up)/b$",      ("tp",)),
    (r"mlp/down/b$",           (None,)),
    (r"moe/router/w$",         ("fsdp", None)),
    (r"moe/(gate|up)$",        ("ep", "fsdp", "tp_if_no_ep")),
    (r"moe/down$",             ("ep", "tp_if_no_ep", "fsdp")),
    # Mamba2 projections: the in_proj output is split into uneven z|x|B|C|dt
    # segments and the conv output re-sliced at the same offsets; those
    # boundaries never align with TP shard boundaries. FSDP over the data
    # axis stays; TP stays off (the JAX rules' choice, kept).
    (r"mamba/in_proj/w$",      ("fsdp", None)),
    (r"mamba/out_proj/w$",     (None, "fsdp")),
    (r"mamba/conv_w$",         (None, None)),
    (r"frontend_proj/(fc1|fc2)?/?w$", ("fsdp", "tp")),
    (r"frontend_proj/w$",      ("fsdp", "tp")),
    (r"shared/proj/w$",        ("fsdp", "tp")),
)

#: the layer stacks whose leaves lead with the layer dim
STACKS = ("layers/", "enc_layers/", "dec_layers/")


def param_spec(mesh, cfg: ModelConfig, pathstr: str,
               shape: Tuple[int, ...], stacked_layers: bool = True) -> Spec:
    """Spec for one parameter leaf. Layer-stacked leaves (a leading
    n_layers dim) get a leading None."""
    shape = tuple(shape)
    lead_none = 0
    core = shape
    if pathstr.startswith(STACKS) and len(shape) >= 1:
        lead_none = 1
        core = shape[1:]

    # The hybrid (zamba-style) stacks replicate wholesale, as the JAX rules
    # have them (its shared block's nested cond miscompiles sharded inputs
    # under XLA's partitioner; the port keeps the same placement).
    if cfg.family == "hybrid" or pathstr.startswith("shared/"):
        return (None,) * len(shape)

    roles: Optional[Tuple[Any, ...]] = None
    for pat, r in _PARAM_RULES:
        if re.search(pat, pathstr):
            roles = r
            break
    if roles is None or len(roles) != len(core):
        # norms, scalars, A_log, biases we didn't match: replicate
        return (None,) * len(shape)

    ep_ok = cfg.n_experts > 0 and cfg.n_experts % tp_size(mesh) == 0
    # q/k/v projections: shard the head-concat dim over TP only when every
    # shard holds WHOLE heads (rope's split of the head dim stays local)
    if re.search(r"(attn|self_attn|cross_attn)/(q|k|v)/(w|b)$", pathstr):
        hd = cfg.resolved_head_dim
        if hd and (core[-1] // hd) % max(tp_size(mesh), 1) != 0:
            roles = tuple(None if r == "tp" else r for r in roles)
    resolved = []
    for role in roles:
        if role == "fsdp":
            resolved.append("data")
        elif role == "tp":
            resolved.append("model")
        elif role == "ep":
            resolved.append("model" if ep_ok else None)
        elif role == "tp_if_no_ep":
            resolved.append(None if ep_ok else "model")
        else:
            resolved.append(None)
    spec = _fit(mesh, core, tuple(resolved))
    return (None,) * lead_none + spec


def param_shardings(mesh, cfg: ModelConfig, params_shape_tree: Mapping
                    ) -> Dict[str, Spec]:
    """Spec of every leaf of a flat ``{path: shape}`` parameter tree."""
    return {path: param_spec(mesh, cfg, path, _shape(leaf))
            for path, leaf in params_shape_tree.items()}


# --------------------------------------------------------------------------
# batch / cache specs
# --------------------------------------------------------------------------

def batch_shardings(mesh, cfg: ModelConfig, batch_tree: Mapping
                    ) -> Dict[str, Spec]:
    """Token/label/frame/patch inputs: batch over (pod, data); any other
    leaf is a cache leaf (:func:`cache_spec`)."""
    dp = dp_axes(mesh)

    def one(name, shape):
        if name.endswith("idx") or not shape:
            return ()
        if name.split("/")[-1] in ("tokens", "labels", "frames", "patches"):
            return _fit(mesh, shape, (dp,) + (None,) * (len(shape) - 1))
        return cache_spec(mesh, cfg, name, shape)
    return {path: one(path, _shape(leaf)) for path, leaf in batch_tree.items()}


def cache_spec(mesh, cfg: ModelConfig, name: str,
               shape: Tuple[int, ...]) -> Spec:
    """KV/SSM cache leaves. Layout:
      k/v/self_k/self_v/cross_k/cross_v/shared_k/shared_v:
          (nl, B, S, kv_eff, hd) -> (None, dp, sp_if_B_unshardable, tp, None)
      kp/vp/shared_kp/shared_vp (paged page pools):
          (nl, NB, bs, kv_eff, hd) -> (None, dp_if_NB_divisible, None, tp,
          None): the BLOCK dim takes the data axis (blocks are the unit of
          both allocation and placement; a prefix-shared block has one home
          and every reader gathers from it)
      bt (block tables): (slots, max_blocks) -> (dp, None)
      ssm:  (nl, B, H, P, N)     -> (None, dp, None, None, None)
      conv: (nl, B, K-1, C)      -> (None, dp, None, None)
    The hybrid family's ``shared_*`` leaves take no tp (the JAX rules')."""
    shape = tuple(shape)
    dp = dp_axes(mesh)
    leaf = name.split("/")[-1]
    if leaf == "idx":
        # scalar (uniform batch) or a per-slot vector (continuous-batching
        # stacked layout): the vector shards over dp like the slot dim
        return () if not shape else _fit(mesh, shape, (dp,))
    if not shape:
        return ()
    if leaf == "bt":
        return _fit(mesh, shape, (dp, None))
    if leaf in ("kp", "vp", "shared_kp", "shared_vp"):
        nl, NB, bs, kv, hd = shape
        b_ax = dp if NB % _axsize(mesh, dp) == 0 else None
        kv_ax = None if leaf.startswith("shared_") else "model"
        return _fit(mesh, shape, (None, b_ax, None, kv_ax, None))
    if leaf in ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
                "shared_k", "shared_v"):
        nl, B, S, kv, hd = shape
        b_ax = dp if B % _axsize(mesh, dp) == 0 else None
        # SP: if batch can't use the data axis, shard the sequence dim there
        s_ax = None if b_ax is not None else (
            "data" if S % _axsize(mesh, "data") == 0 else None)
        kv_ax = None if leaf.startswith("shared_") else "model"
        return _fit(mesh, shape, (None, b_ax, s_ax, kv_ax, None))
    if leaf == "ssm":
        nl, B, H, Pd, N = shape
        b_ax = dp if B % _axsize(mesh, dp) == 0 else None
        return _fit(mesh, shape, (None, b_ax, None, None, None))
    if leaf == "conv":
        nl, B, K, C = shape
        b_ax = dp if B % _axsize(mesh, dp) == 0 else None
        return _fit(mesh, shape, (None, b_ax, None, None))
    return (None,) * len(shape)


def serve_block_shards(mesh, n_blocks: int, n_slots: int) -> int:
    """How many contiguous chunks the paged pools' BLOCK dim and the slot
    dim split into over dp: block ``b`` lives on shard ``b // (n_blocks //
    d)`` and slot ``s`` on ``s // (n_slots // d)``. 1 whenever either dim
    can't take the axis (the rules then replicate it)."""
    d = _axsize(mesh, dp_axes(mesh))
    if d > 1 and n_blocks % d == 0 and n_slots % d == 0:
        return d
    return 1


def serve_state_shardings(mesh, cfg: ModelConfig, abstract_state: Mapping
                          ) -> Dict[str, Spec]:
    """Specs of the continuous-batching engine state (flat paths such as
    ``cache/k``, ``last_tok``): cache leaves follow :func:`cache_spec`
    with the slot dim as the batch dim, the per-slot control vectors shard
    over dp alongside it, the ``health/`` accumulators replicate. The
    hybrid family's whole serving state replicates."""
    dp = dp_axes(mesh)
    out = {}
    for name, leaf in abstract_state.items():
        shape = _shape(leaf)
        if cfg.family == "hybrid" or name.startswith("health/") \
                or not shape:
            out[name] = ()
        elif name.startswith("cache/"):
            out[name] = cache_spec(mesh, cfg, name[len("cache/"):], shape)
        else:
            out[name] = _fit(mesh, shape,
                             (dp,) + (None,) * (len(shape) - 1))
    return out


def train_state_shardings(mesh, cfg: ModelConfig, abstract_state: Mapping
                          ) -> Dict[str, Spec]:
    """Specs of a flat train state ``{params/..., opt/m/..., opt/v/...,
    opt/mom/..., opt/count, step, err/...}``. Optimizer moments and
    error-feedback buffers shard exactly like their parameters (ZeRO-1
    falls out of the fsdp component of the param specs)."""
    out = {}
    for path, leaf in abstract_state.items():
        shape = _shape(leaf)
        keys = path.split("/")
        if not shape:
            out[path] = ()
            continue
        if keys[0] in ("params", "err"):
            sub = keys[1:]
        elif keys[0] == "opt" and len(keys) > 2 and \
                keys[1] in ("m", "v", "mom"):
            sub = keys[2:]
        else:
            out[path] = (None,) * len(shape)
            continue
        out[path] = param_spec(mesh, cfg, "/".join(sub), shape)
    return out


def replicated(mesh) -> Spec:
    return ()
