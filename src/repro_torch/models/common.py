"""Shared layers (port of ``repro.models.common``). Every GEMM routes through
``dense``/``unembed`` -> :func:`repro_torch.core.gemm.mirage_matmul_auto`, so
the policy's mode picks the backend for every model GEMM.

Parameters live in small ``nn.Module``s whose attribute names and layouts are
the JAX parameter tree's (``Dense.w`` is ``(d_in, d_out)`` as in JAX, not
PyTorch's ``(out, in)``), so :mod:`repro_torch.interop` maps one onto the
other leaf by leaf. The apply functions are plain functions on tensors, as in
the JAX package. Initializers draw from an explicit ``torch.Generator``.

On a mesh (:func:`repro_torch.parallel.shard.shard_model`) a module's
``placements`` say where its parameters live, and the apply functions run
on the rank's shards: :func:`weight` gathers an FSDP-sharded leaf over
``data`` where it is used; :func:`dense` runs a column-parallel GEMM
(N sharded over ``model``: its input goes through
:func:`tp_inputs`' ``copy_to_tp``) or a row-parallel one (K sharded: its
output is all-reduced over ``model``), each on the local shard, so the GEMM
kernel reads N/tp or K/tp; :func:`embed` looks up a vocab-parallel table
and :func:`unembed` returns the vocab shard's logits. Without placements
every function is the single-device one, operation for operation.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core.gemm import mirage_matmul_auto
from repro_torch.core.precision import MiragePolicy
from repro_torch.parallel import comm as pcomm


def _normal(shape, std: float, generator: torch.Generator,
            device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator,
                                    device=device) * std)


class Dense(nn.Module):
    """``x @ w (+ b)``; init N(0, 1/d_in) (or ``scale``), zero bias.

    ``stationary`` holds the weight's programmed residues
    (:class:`repro_torch.core.stationary.StationaryResidues`) while a
    serving engine of an RNS backend has installed them; :func:`dense` then
    runs them in place of ``w``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 scale: Optional[float] = None, *,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        std = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = _normal((d_in, d_out), std, generator, device)
        self.b = (nn.Parameter(torch.zeros(d_out, device=device))
                  if bias else None)
        self.stationary = None


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.emb = _normal((vocab, d), 0.02, generator, device)


class Norm(nn.Module):
    def __init__(self, d: int, norm_type: str = "rmsnorm", *,
                 device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = (nn.Parameter(torch.zeros(d, device=device))
                     if norm_type == "layernorm" else None)


class MLP(nn.Module):
    """Feed-forward weights: SwiGLU (gate, up, down), or with ``mlp_type=
    "gelu"`` (the enc-dec family's) up and down alone, no gate."""

    def __init__(self, d: int, d_ff: int, bias: bool = False,
                 mlp_type: str = "swiglu", *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        if mlp_type not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp_type {mlp_type!r}")
        kw = dict(generator=generator, device=device)
        self.gate = Dense(d, d_ff, bias, **kw) if mlp_type == "swiglu" \
            else None
        self.up = Dense(d, d_ff, bias, **kw)
        self.down = Dense(d_ff, d, bias, **kw)


# --------------------------------------------------------------------------
# Apply functions
# --------------------------------------------------------------------------

def _placement(p: nn.Module, name: str):
    return (p.__dict__.get("placements") or {}).get(name)


def weight(p: nn.Module, name: str = "w") -> torch.Tensor:
    """The parameter ``name`` of ``p`` as a layer uses it: gathered over
    ``data`` where it is FSDP-sharded (its TP shard stays local)."""
    t = getattr(p, name)
    pl = _placement(p, name)
    return t if pl is None else pl.gather(t)


def tp_dim(p: nn.Module, name: str = "w"):
    """The dim of ``p.<name>`` sharded over ``model`` (None: replicated or
    no mesh) and the mesh's comm."""
    pl = _placement(p, name)
    return (None, None) if pl is None else (pl.tp_dim, pl.comm)


def tp_inputs(x: torch.Tensor, *mods: nn.Module):
    """The input of each GEMM of ``mods`` that read the same ``x``: one
    ``copy_to_tp`` of it for the column-parallel ones (their dX partial
    sums meet in its backward's single all-reduce), ``x`` itself for the
    rest."""
    shared = None
    out = []
    for m in mods:
        dim, comm = tp_dim(m) if m is not None else (None, None)
        if dim is not None and dim == m.w.dim() - 1:
            if shared is None:
                shared = pcomm.copy_to_tp(x, comm)
            out.append(shared)
        else:
            out.append(x)
    return out


def dense(p: Dense, x: torch.Tensor, policy: MiragePolicy) -> torch.Tensor:
    """The Mirage-quantized GEMM. x: (..., d_in) @ w: (d_in, d_out), or
    the installed stationary residues of ``w``. A row-parallel shard (K
    over ``model``) takes the local part of ``x`` (sliced here where the
    caller holds all of it) and all-reduces its output over ``model``."""
    if p.stationary is not None:
        w = p.stationary
    else:
        w = weight(p)
    dim, comm = tp_dim(p)
    if dim == 0 and x.shape[-1] != w.shape[0]:
        k = w.shape[0]
        x = pcomm.select_tp(x, comm, x.dim() - 1, torch.arange(
            comm.tp_rank * k, (comm.tp_rank + 1) * k, device=x.device))
    y = mirage_matmul_auto(x, w, policy)
    if dim == 0:
        y = pcomm.reduce_from_tp(y, comm)
    if p.b is not None:
        y = y + weight(p, "b")
    return y


def vocab_range(p: Embed):
    """(first row, rows) of the rank's vocab shard of ``p.emb``, and the
    comm, or None where the table is not vocab-parallel."""
    dim, comm = tp_dim(p, "emb")
    if dim != 0:
        return None
    v = p.emb.shape[0]
    return comm.tp_rank * v, v, comm


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; a vocab-parallel table looks up the tokens of
    its rows, zeros the rest, and sums the shards over ``model``."""
    emb = weight(p, "emb")
    vr = vocab_range(p)
    if vr is None:
        return torch.nn.functional.embedding(tokens, emb)
    v0, v, comm = vr
    local = tokens - v0
    mine = (local >= 0) & (local < v)
    h = torch.nn.functional.embedding(torch.clamp(local, 0, v - 1), emb)
    h = h * mine[..., None].to(h.dtype)
    return pcomm.reduce_from_tp(h, comm)


def unembed(p: Embed, x: torch.Tensor, policy: MiragePolicy) -> torch.Tensor:
    """Tied output head: x @ emb^T. The embedding table is never
    pre-quantized nor encoded into stationary residues, so the head GEMM
    always quantizes (and, under the RNS backends, encodes) its weight side
    per call. The
    transposed view is passed as is: the card's kernel reads ``(N, K)``
    row-major weights in place. A vocab-parallel table gives the logits of
    its vocab shard (``vocab_range``)."""
    if policy.assume_quantized_weights:
        policy = policy.replace(assume_quantized_weights=False)
    emb = weight(p, "emb")
    vr = vocab_range(p)
    if vr is not None:
        x = pcomm.copy_to_tp(x, vr[2])
    return mirage_matmul_auto(x, emb.T, policy)


def norm(p: Norm, x: torch.Tensor, eps: float = 1e-5,
         norm_type: str = "rmsnorm") -> torch.Tensor:
    x32 = x.to(torch.float32)
    if norm_type == "rmsnorm":
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return x32 * torch.rsqrt(var + eps) * p.scale
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return (x32 - mu) * torch.rsqrt(var + eps) * p.scale + p.bias


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMSNorm over the head_dim axis (qwen3 qk_norm)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


# --------------------------------------------------------------------------
# Rotary position embeddings (half-rotation / llama convention)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a fill, not a copy from the host: the decode tick runs inside a
    # captured CUDA graph, where a synchronizing copy may not
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, L, H, D); positions: (B, L) or (L,) absolute positions."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # (B, L, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp(p: MLP, x: torch.Tensor, policy: MiragePolicy) -> torch.Tensor:
    """SwiGLU, or GELU where ``p`` has no gate. The GELU is the JAX
    package's ``jax.nn.gelu``, whose default is the tanh approximation (the
    exact erf form differs in the last bits, which flips BFP roundings)."""
    xg, xu = tp_inputs(x, p.gate, p.up)
    if p.gate is None:
        h = torch.nn.functional.gelu(dense(p.up, xu, policy),
                                     approximate="tanh")
    else:
        h = torch.nn.functional.silu(dense(p.gate, xg, policy)) * \
            dense(p.up, xu, policy)
    return dense(p.down, h, policy)
