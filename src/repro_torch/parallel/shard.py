"""A model and its train state placed on a mesh.

:func:`shard_model` cuts every parameter of a port model to this rank's
shard, as :func:`repro_torch.parallel.sharding.param_spec` places the JAX
leaf of the same path: FSDP over ``data`` (the shard at rest, gathered
where a layer uses it) and TP over ``model`` (the shard the rank computes
with). Each module that owns a parameter gets a ``placements`` dict (its
attribute name -> :class:`Placement`), which the layers read
(:func:`repro_torch.models.common.dense` and the embedding, attention and
MoE paths); the model gets ``comm`` (:class:`MeshComm`) and
``placements`` by parameter name, which the trainer reads.

BFP groups never straddle a shard boundary: :func:`check_bfp_groups`
refuses a placement whose local extent along a quantized dim is not a
multiple of the group size g, where the dim is cut (the TP-sharded dims
every BFP GEMM groups along, the at-rest K dim that weight-stationary
quantization groups along, the last dim that gradient compression groups
along). The rules keep every group whole at the shapes the configs have
(qwen2-0.5b at tp = 2: o's K is 448 a rank, down's 2,432).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.parallel import sharding
from repro_torch.parallel.comm import MeshComm, gather_dp

#: the leaves that GEMMs read as weights (the trainer's ``_QUANT_LEAF``)
GEMM_LEAVES = ("w", "emb", "gate", "up", "down")


def jax_path(name: str, stacks: Tuple[str, ...]) -> Tuple[str, bool]:
    """The JAX tree path of a port parameter name and whether it leads
    with a layer dim there: ``layers.3.attn.q.w`` -> (``layers/attn/q/w``,
    True)."""
    parts = name.split(".")
    if parts[0] in stacks:
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives: its spec (one entry per dim of the port's
    leaf; the JAX spec less its layer dim) and its full shape."""
    comm: MeshComm
    spec: Tuple[Any, ...]
    shape: Tuple[int, ...]

    def dim_of(self, axis: str) -> Optional[int]:
        for i, ax in enumerate(self.spec):
            if ax == axis or (isinstance(ax, tuple) and axis in ax):
                return i
        return None

    @property
    def data_dim(self) -> Optional[int]:
        return self.dim_of("data")

    @property
    def tp_dim(self) -> Optional[int]:
        return self.dim_of("model")

    @property
    def replicas(self) -> int:
        """Ranks that hold the same shard."""
        n = self.comm.mesh.size()
        for ax in self.spec:
            n //= sharding._axsize(self.comm.sizes, ax)
        return n

    def local_shape(self) -> Tuple[int, ...]:
        return tuple(s // sharding._axsize(self.comm.sizes, ax)
                     for s, ax in zip(self.shape, self.spec))

    def local(self, full):
        """This rank's shard of the full leaf (a tensor or an array)."""
        out = full
        for dim, ax in enumerate(self.spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n, r = 1, 0
            for a in axes:
                n *= self.comm.sizes.get(a, 1)
                r = r * self.comm.sizes.get(a, 1) + self.comm.coord.get(a, 0)
            size = out.shape[dim] // n
            idx = [slice(None)] * out.ndim
            idx[dim] = slice(r * size, (r + 1) * size)
            out = out[tuple(idx)]
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The FSDP gather: the leaf with its ``data`` dim whole (autograd:
        the gradient reduce-scatters back)."""
        d = self.data_dim
        return t if d is None else gather_dp(t, self.comm, d)

    @torch.no_grad()
    def full(self, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the shards (every rank gets it)."""
        for dim, ax in enumerate(self.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,))[::-1]:
                if a is not None:
                    t = self.comm.all_gather(t, a, dim)
        return t


def placements_of(module: nn.Module) -> Dict[str, Placement]:
    return module.__dict__.get("placements") or {}


def shard_model(model: nn.Module, mesh) -> MeshComm:
    """Cut ``model``'s parameters (full, identical on every rank: built
    from one seed) to this rank's shards in place; returns its
    :class:`MeshComm`. Sets ``kv_repeat`` from
    :func:`~repro_torch.parallel.sharding.kv_repeat_for` where the model
    had none."""
    if getattr(model, "comm", None) is not None:
        return model.comm
    if not getattr(model, "supports_mesh", False):
        raise TypeError(f"{type(model).__name__} does not run on a mesh "
                        f"(the decoder-only LM does)")
    comm = mesh if isinstance(mesh, MeshComm) else MeshComm(
        mesh, model.device)
    cfg, stacks = model.cfg, tuple(model.stacks)
    placements = {}
    for name, p in list(model.named_parameters()):
        path, lead = jax_path(name, stacks)
        shape = tuple(p.shape)
        spec = sharding.param_spec(comm.sizes, cfg, path,
                                   ((1,) if lead else ()) + shape)
        pl = Placement(comm, spec[1:] if lead else spec, shape)
        with torch.no_grad():
            p.data = pl.local(p.data).contiguous().clone()
        placements[name] = pl
        owner, leaf = name.rpartition(".")[::2]
        mod = model.get_submodule(owner) if owner else model
        mod.__dict__.setdefault("placements", {})[leaf] = pl
    if model.opt.kv_repeat == 1:
        model.opt = dataclasses.replace(
            model.opt, kv_repeat=sharding.kv_repeat_for(cfg, comm.sizes))
    model.comm = comm
    model.placements = placements
    check_bfp_groups(model, model.policy)
    return comm


def _bfp(policy) -> bool:
    return policy.mode.startswith("mirage")


def check_bfp_groups(model: nn.Module, policy, *, weight_stationary=False,
                     compress_g: Optional[int] = None) -> None:
    """Raise where a shard boundary would cut a BFP group: a TP-sharded dim
    of a GEMM weight under a BFP policy (the forward groups K, the dX GEMM
    groups N), the K dim of a weight-stationary shard, or the last dim of a
    leaf whose gradient is compressed."""
    for name, pl in getattr(model, "placements", {}).items():
        leaf = name.rsplit(".", 1)[-1]
        loc = pl.local_shape()
        cuts = []
        gemm = len(pl.shape) >= 2 and leaf in GEMM_LEAVES
        # a GEMM groups along its weight's last two dims (K, N); an
        # expert stack's leading dim is no GEMM dim
        if gemm and _bfp(policy) and pl.tp_dim is not None and \
                pl.tp_dim >= len(pl.shape) - 2:
            cuts.append((pl.tp_dim, policy.g))
        if gemm and weight_stationary and leaf != "emb":
            k = len(pl.shape) - 2
            if pl.spec[k] is not None:
                cuts.append((k, policy.g))
        if compress_g and pl.shape and pl.spec[-1] is not None:
            cuts.append((len(pl.shape) - 1, compress_g))
        for dim, g in cuts:
            if loc[dim] % g:
                raise ValueError(
                    f"{name}: a shard of {loc[dim]} along dim {dim} (spec "
                    f"{pl.spec}) cuts BFP groups of {g}; pick a mesh whose "
                    f"axes divide it into multiples of {g}")


# --------------------------------------------------------------------------
# batches, caches and train states
# --------------------------------------------------------------------------

def local_rows(x, comm: MeshComm):
    """This rank's rows of a global batch leaf (its coordinate on the batch
    axes, so the ranks of one TP group read the same rows)."""
    n = x.shape[0] // comm.dp
    return x[comm.dp_rank * n:(comm.dp_rank + 1) * n]


def local_batch(batch: Mapping[str, Any], comm: MeshComm) -> Dict[str, Any]:
    return {k: local_rows(v, comm) for k, v in batch.items()}


def shard_cache(cache: Mapping[str, torch.Tensor], comm: MeshComm,
                cfg) -> Dict[str, torch.Tensor]:
    """This rank's shard of a serving cache, placed by
    :func:`~repro_torch.parallel.sharding.cache_spec`."""
    out = {}
    for k, v in cache.items():
        spec = sharding.cache_spec(comm.sizes, cfg, k, tuple(v.shape))
        out[k] = Placement(comm, spec or (None,) * v.dim(),
                           tuple(v.shape)).local(v).contiguous().clone() \
            if v.dim() else v.clone()
    return out


def state_placements(model: nn.Module, state: Mapping[str, Any]
                     ) -> Dict[str, Dict[str, Placement]]:
    """The placement of every leaf of a port train state by the JAX
    package's rules (:func:`~repro_torch.parallel.sharding
    .train_state_shardings`): each moment and error buffer as its
    parameter. Returns {state key: {name: Placement}} for the per-name
    trees (``params``, ``opt/m``, ``opt/v``, ``opt/mom``, ``err``)."""
    comm = model.comm
    stacks = tuple(model.stacks)
    full = {n: pl.shape for n, pl in model.placements.items()}
    trees = {"params": state["params"], "err": state.get("err")}
    for k, v in state["opt"].items():
        if isinstance(v, Mapping):
            trees[f"opt/{k}"] = v
    flat, where = {}, {}
    for key, tree in trees.items():
        if tree is None:
            continue
        for name in tree:
            path, lead = jax_path(name, stacks)
            flat[f"{key}/{path}"] = ((1,) if lead else ()) + full[name]
            where[(key, name)] = (f"{key}/{path}", lead)
    specs = sharding.train_state_shardings(comm.sizes, model.cfg, flat)
    out: Dict[str, Dict[str, Placement]] = {}
    for (key, name), (path, lead) in where.items():
        spec = specs[path]
        out.setdefault(key, {})[name] = Placement(
            comm, spec[1:] if lead else spec, full[name])
    return out


def _tree(state, key):
    if key.startswith("opt/"):
        return state["opt"][key[4:]]
    return state[key]


@torch.no_grad()
def gather_train_state(model: nn.Module, state: Mapping[str, Any]
                       ) -> Dict[str, Any]:
    """The whole train state, every leaf gathered to its unsharded tensor
    (on every rank): what a single-device run would hold."""
    out = {"params": {}, "opt": {}, "step": state["step"]}
    for k, v in state["opt"].items():
        if not isinstance(v, Mapping):
            out["opt"][k] = v
    for key, pls in state_placements(model, state).items():
        tree = _tree(state, key)
        dst = out["opt"].setdefault(key[4:], {}) if key.startswith("opt/") \
            else out.setdefault(key, {})
        for name, pl in pls.items():
            dst[name] = pl.full(tree[name])
    return out


def train_state_shardings_tree(model: nn.Module, state: Mapping[str, Any]
                               ) -> Dict[str, Any]:
    """The placements of a sharded model's train state laid out as the JAX
    package's train-state tree (layers stacked: each stacked leaf's
    placement leads with a whole layer dim), for
    :meth:`repro_torch.checkpoint.Checkpointer.restore`'s ``shardings``;
    the step and count are None (whole)."""
    from repro_torch.interop import _jax_layout

    def stack(pls):
        return Placement(pls[0].comm, (None,) + pls[0].spec,
                         (len(pls),) + pls[0].shape)

    pls = state_placements(model, state)
    out = {"params": _jax_layout(model, pls["params"], lambda p: p, stack),
           "opt": {k: (_jax_layout(model, pls[f"opt/{k}"], lambda p: p,
                                   stack) if isinstance(v, Mapping) else None)
                   for k, v in state["opt"].items()},
           "step": None}
    if "err" in pls:
        out["err"] = _jax_layout(model, pls["err"], lambda p: p, stack)
    return out
