"""Optimizers with FP32 master weights (port of ``repro.optim.optimizers``;
paper Eq. 4 + Section IV-A).

The paper keeps an FP32 copy of the weights and applies updates in FP32
while all GEMMs run in BFP/RNS. The parameters here ARE that master copy:
Mirage quantization happens inside each GEMM. Parameters, gradients and
optimizer state are dicts of tensors keyed by parameter name (the JAX
package's pytrees). The JAX formulas are written out on tensors in the JAX
package's order (``torch._foreach_*`` over the whole dict, a few launches
per step on the card); ``torch.optim`` is not used, since its AdamW orders
the update differently. Where the JAX functions return new trees, these
update the parameters and the optimizer state IN PLACE (the masters and
moments of a full-width model are 2 GB each) and return them.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig

Tree = Dict[str, torch.Tensor]

#: the most f32 bytes of leaves one group of an update's ``torch._foreach_*``
#: calls covers. Each call allocates temporaries the size of its group, so
#: one group of every leaf would add twice the model's f32 size on top of
#: the masters, gradients and moments (a 3 B-parameter MoE depth cut then
#: outgrows one 80 GB card). Every element's arithmetic is the same in any
#: grouping.
UPDATE_GROUP_BYTES = 1 << 30


def _groups(params: Tree):
    """The names of ``params`` in order, cut into runs of at most
    UPDATE_GROUP_BYTES of f32 leaves (a larger leaf is a run of its own)."""
    group, size = [], 0
    for k in params:
        n = 4 * params[k].numel()
        if group and size + n > UPDATE_GROUP_BYTES:
            yield group
            group, size = [], 0
        group.append(k)
        size += n
    if group:
        yield group


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, as an f32 0-d tensor. The
    leaves' norms accumulate in f64: an f32 norm on the CPU sums serially
    and loses ~4e-4 relative over 10 M elements (the tied embedding's
    gradient has 136 M)."""
    leaves = [t.to(torch.float32) for t in tree.values()]
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).to(torch.float32)


def sharded_global_norm(tree: Tree, placements, comm) -> torch.Tensor:
    """:func:`global_norm` of a tree whose leaves are shards on a mesh
    (``placements`` by name, :class:`repro_torch.parallel.shard
    .Placement`): each leaf's local sum of squares (f64) divided by the
    ranks that hold the same shard, so a replicated leaf counts once,
    summed over every rank."""
    names = list(tree)
    leaves = [tree[k].to(torch.float32) for k in names]
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float64)
    sq = torch.stack([n * n / placements[k].replicas
                      for k, n in zip(names, norms)]).sum()
    return torch.sqrt(comm.all_reduce(sq, "world")).to(torch.float32)


def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: torch.Tensor = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)); returns
    (clipped grads, the norm before clipping). No host sync. ``norm``
    defaults to :func:`global_norm` of ``grads`` (a sharded step passes
    :func:`sharded_global_norm`'s)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    leaves = list(grads.values())
    if leaves:
        scaled = torch._foreach_mul(leaves, scale)
        grads = dict(zip(grads.keys(), scaled))
    return grads, norm


def _zeros_like(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _count(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgdm_init(params: Tree) -> Dict:
    return {"mom": _zeros_like(params), "count": _count(params)}


@torch.no_grad()
def sgdm_update(grads: Tree, state: Dict, params: Tree, lr,
                momentum: float = 0.9, weight_decay: float = 0.0):
    """Paper's CNN recipe: SGD + momentum, FP32 updates (Eq. 4):
    mom = momentum * mom + g; p = p - lr * (mom + weight_decay * p)."""
    for keys in _groups(params):
        mom = [state["mom"][k] for k in keys]
        torch._foreach_mul_(mom, momentum)
        torch._foreach_add_(mom, [grads[k].to(torch.float32) for k in keys])
        p = [params[k] for k in keys]
        step = list(mom)
        if weight_decay:
            step = torch._foreach_add(mom,
                                      torch._foreach_mul(p, weight_decay))
        torch._foreach_sub_(p, torch._foreach_mul(step, lr))
    state["count"] += 1
    return params, state


def adam_init(params: Tree) -> Dict:
    return {"m": _zeros_like(params), "v": _zeros_like(params),
            "count": _count(params)}


@torch.no_grad()
def adam_update(grads: Tree, state: Dict, params: Tree, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """Adam/AdamW with FP32 moments (paper's transformer recipe):
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p = p - lr (m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps)
    - lr wd p, with c the step count after this update."""
    state["count"] += 1
    c = state["count"].to(torch.float32)
    mhat_scale = 1.0 / (1.0 - torch.pow(torch.tensor(b1, device=c.device), c))
    vhat_scale = 1.0 / (1.0 - torch.pow(torch.tensor(b2, device=c.device), c))
    for keys in _groups(params):
        g = [grads[k].to(torch.float32) for k in keys]
        m = [state["m"][k] for k in keys]
        v = [state["v"][k] for k in keys]
        p = [params[k] for k in keys]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1 - b2))
        # step = lr * (m * mhat) / (sqrt(v * vhat) + eps)
        den = torch._foreach_mul(v, vhat_scale)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        step = torch._foreach_mul(m, mhat_scale)
        torch._foreach_mul_(step, lr)
        torch._foreach_div_(step, den)
        del den
        if weight_decay:
            torch._foreach_add_(step,
                                torch._foreach_mul(p, lr * weight_decay))
        torch._foreach_sub_(p, step)
    return params, state


def make_optimizer(cfg: TrainConfig) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params), update_fn(grads, state, params, lr))."""
    if cfg.optimizer == "sgdm":
        return sgdm_init, lambda g, s, p, lr: sgdm_update(
            g, s, p, lr, cfg.momentum, cfg.weight_decay)
    if cfg.optimizer in ("adam", "adamw"):
        wd = cfg.weight_decay if cfg.optimizer == "adamw" else 0.0
        return adam_init, lambda g, s, p, lr: adam_update(
            g, s, p, lr, cfg.beta1, cfg.beta2, 1e-8, wd)
    raise ValueError(cfg.optimizer)
