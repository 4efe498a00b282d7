"""Carry the JAX package's parameters into the port's modules.

The JAX LM keeps its parameters as a nested dict whose ``layers`` subtree is
stacked on axis 0 (the ``vmap`` init). Given that tree with numpy leaves
(``jax.tree_util.tree_map(np.asarray, params)`` on the caller's side; this
module imports no JAX), :func:`load_jax_params` copies every leaf into the
parameter of the same name, unstacking the layers, so both packages compute
the same function. The port's module attribute names and layouts are the
JAX tree's, including the tied ``embed.emb``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _load(module: nn.Module, subtree: Mapping[str, Any], path: str) -> int:
    n = 0
    for name, val in subtree.items():
        target = getattr(module, name, None)
        where = f"{path}.{name}" if path else name
        if target is None:
            raise KeyError(f"the port has no parameter for {where}")
        if isinstance(val, Mapping):
            n += _load(target, val, where)
            continue
        src = torch.tensor(np.asarray(val))
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"{where}: JAX shape {tuple(src.shape)} != "
                             f"port shape {tuple(target.shape)}")
        target.copy_(src.to(dtype=target.dtype))
        n += target.numel()
    return n


def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX LM parameter tree (numpy leaves) into ``model`` in place.

    Raises if a leaf has no counterpart, a shape differs, or a parameter of
    the model is left unloaded."""
    layers = tree["layers"]
    loaded = 0
    with torch.no_grad():
        loaded += _load(model, {k: v for k, v in tree.items()
                                if k != "layers"}, "")
        for i, layer in enumerate(model.layers):
            unstacked = _index(layers, i)
            loaded += _load(layer, unstacked, f"layers[{i}]")
    total = sum(p.numel() for p in model.parameters())
    if loaded != total:
        raise ValueError(f"loaded {loaded} of the model's {total} parameter "
                         f"values; the JAX tree does not cover the model")
    return model


def _index(tree: Mapping[str, Any], i: int):
    """Layer ``i`` of a subtree stacked on axis 0."""
    return {k: (_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}
