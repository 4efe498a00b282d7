"""Carry the JAX package's parameters into the port's modules.

The JAX models keep their parameters as a nested dict whose layer subtrees
are stacked on axis 0 (the ``vmap`` init): ``layers`` in the LM,
``enc_layers`` and ``dec_layers`` in the enc-dec model. A port model names
its stacks in ``stacks``, each an ``nn.ModuleList`` of the same name.
Given the tree with numpy leaves (``jax.tree_util.tree_map(np.asarray,
params)`` on the caller's side; this module imports no JAX),
:func:`load_jax_params` copies every leaf into the parameter of the same
name, unstacking the layers, so both packages compute the same function.
The port's module attribute names and layouts are the JAX tree's,
including the tied ``embed.emb``.

:func:`load_jax_train_state` carries a whole JAX train state over (params,
optimizer moments and count, step, and the BFP error-feedback buffer), so a
run can continue in the port where the JAX package left it;
:func:`to_jax_train_state` is its inverse. The checkpointer writes a port
train state in that JAX layout, and :func:`restore_train_state` reads one
back into a port state in place, so each package resumes the other's runs.

:func:`load_jax_stationary` does the same for a tree the JAX package's
``encode_stationary_params`` programmed: its ``StationaryResidues`` leaves
(numpy children, stacked per layer) become the port's containers, so both
packages run identical programmed weights, programming drift included
(the MoE layer's expert stacks too, as ``layers.<i>.moe.<stack>``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
    """Copy a JAX parameter tree (numpy leaves) into ``model`` in place.

    Raises if a leaf has no counterpart, a shape differs, or a parameter of
    the model is left unloaded."""
    names = model.stacks
    loaded = 0
    with torch.no_grad():
        loaded += _load(model, {k: v for k, v in tree.items()
                                if k not in names}, "")
        for stack in names:
            if stack not in tree:
                continue
            for i, layer in enumerate(getattr(model, stack)):
                loaded += _load(layer, _index(tree[stack], i),
                                f"{stack}[{i}]")
    total = sum(p.numel() for p in model.parameters())
    if loaded != total:
        raise ValueError(f"loaded {loaded} of the model's {total} parameter "
                         f"values; the JAX tree does not cover the model")
    return model


def _index(tree: Mapping[str, Any], i: int):
    """Layer ``i`` of a subtree stacked on axis 0."""
    return {k: (_index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}


def load_jax_stationary(model: nn.Module, tree: Mapping[str, Any]
                        ) -> Dict[str, Any]:
    """The port's stationary encodings of a JAX stationary-encoded tree.

    ``tree`` is ``encode_stationary_params(params, policy)`` with numpy
    leaves; each of its ``StationaryResidues`` (read by attribute: this
    module imports no JAX) becomes a
    :class:`repro_torch.core.stationary.StationaryResidues` on the model's
    device, unstacked per layer. Returns ``{module name: residues}``, the
    form :func:`repro_torch.core.stationary.install` takes."""
    from repro_torch.core.stationary import MOE_STACKS, StationaryResidues

    dev = model.device
    names = model.stacks
    out: Dict[str, Any] = {}

    def convert(sr, i=None, stack=False):
        res, scale = np.asarray(sr.residues), np.asarray(sr.scale)
        if i is not None:
            res, scale = res[i], scale[i]
        if stack:      # the JAX vmap's (E, n_mod, ...) as (n_mod, E, ...)
            res = np.moveaxis(res, 0, 1)
        return StationaryResidues(
            residues=torch.from_numpy(np.ascontiguousarray(res)).to(
                dev, torch.int32),
            scale=torch.from_numpy(np.ascontiguousarray(scale)).to(
                dev, torch.float32),
            moduli=tuple(int(m) for m in sr.moduli), b_m=int(sr.b_m),
            g=int(sr.g), orig_k=int(sr.orig_k))

    def walk(subtree, prefix, layer, owner=None):
        for name, val in subtree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + [name], layer, owner)
            elif hasattr(val, "residues") and hasattr(val, "scale"):
                stack = name in MOE_STACKS and prefix[-1:] == ["moe"]
                if name != "w" and not stack:
                    raise KeyError(f"stationary leaf {'/'.join(prefix)}/"
                                   f"{name} is not a Dense weight or an "
                                   f"expert stack")
                key = ".".join(prefix + ([name] if stack else []))
                if layer is not None:
                    key = f"{owner}.{layer}.{key}"
                out[key] = convert(val, layer, stack)

    walk({k: v for k, v in tree.items() if k not in names}, [], None)
    for owner in names:
        for i in range(len(getattr(model, owner))):
            walk(tree[owner], [], i, owner)
    modules = dict(model.named_modules())
    for key in out:
        owner, _, stack = key.rpartition(".")
        if key not in modules and not (stack in MOE_STACKS and
                                       hasattr(modules.get(owner), stack)):
            raise KeyError(f"the port has no module {key}")
    return out


def _by_name(model: nn.Module, tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The leaves of a JAX parameter-shaped tree (stacked layer subtrees)
    keyed by the port's parameter names."""
    names = model.stacks
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        node, layer = tree, None
        if parts[0] in names:
            node, layer, parts = tree[parts[0]], int(parts[1]), parts[2:]
        for part in parts:
            node = node[part]
        val = np.asarray(node)
        out[name] = val[layer] if layer is not None else val
    return out


def load_jax_train_state(model: nn.Module, jstate: Mapping[str, Any],
                         train_cfg) -> Dict[str, Any]:
    """A port train state (:func:`repro_torch.runtime.trainer
    .init_train_state`) from a JAX one with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, state)``): ``params`` are loaded
    into ``model`` (:func:`load_jax_params`), the optimizer's moment trees
    and its count, the step and the error buffer copied over by name."""
    from repro_torch.runtime.trainer import init_train_state

    load_jax_params(model, jstate["params"])
    state = init_train_state(model, train_cfg)
    _copy_train_state(model, state, jstate)
    return state


def _copy_train_state(model: nn.Module, state: Dict[str, Any],
                      jstate: Mapping[str, Any]) -> None:
    """Copy a JAX train state's optimizer state, step and error buffer into
    the port's ``state`` in place (the params are the model's own)."""
    dev = model.device
    with torch.no_grad():
        for key, val in jstate["opt"].items():
            if isinstance(val, Mapping):
                for name, arr in _by_name(model, val).items():
                    state["opt"][key][name].copy_(torch.from_numpy(
                        np.ascontiguousarray(arr)))
            else:
                state["opt"][key] = torch.tensor(np.asarray(val),
                                                 device=dev)
        state["step"] = torch.tensor(np.asarray(jstate["step"]),
                                     device=dev)
        if "err" in jstate:
            if "err" not in state:
                raise ValueError("the JAX state carries an error-feedback "
                                 "buffer; train_cfg has no grad compression")
            for name, arr in _by_name(model, jstate["err"]).items():
                state["err"][name].copy_(torch.from_numpy(
                    np.ascontiguousarray(arr)))


def _jax_layout(model: nn.Module, tree: Mapping[str, torch.Tensor],
                leaf, stack) -> Dict[str, Any]:
    """A name-keyed tree (the port's params, or a moment tree of the same
    names) laid out as the JAX parameter tree: nested by the names' parts,
    with each layer leaf stacked on axis 0 over its stack's layers."""
    n_layers = {s: len(getattr(model, s)) for s in model.stacks}
    out: Dict[str, Any] = {}
    per_layer: Dict[tuple, list] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        val = leaf(tree[name])
        if parts[0] in n_layers:
            per_layer.setdefault((parts[0],) + tuple(parts[2:]),
                                 [None] * n_layers[parts[0]])[
                int(parts[1])] = val
        else:
            _put(out, parts, val)
    for parts, vals in per_layer.items():
        _put(out.setdefault(parts[0], {}), list(parts[1:]), stack(vals))
    return out


def _put(tree: Dict[str, Any], parts, val) -> None:
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = val


def _train_state_layout(model: nn.Module, state: Mapping[str, Any],
                        leaf, stack) -> Dict[str, Any]:
    out = {"params": _jax_layout(model, state["params"], leaf, stack),
           "opt": {k: (_jax_layout(model, v, leaf, stack)
                       if isinstance(v, Mapping) else leaf(v))
                   for k, v in state["opt"].items()},
           "step": leaf(state["step"])}
    if "err" in state:
        out["err"] = _jax_layout(model, state["err"], leaf, stack)
    return out


def to_jax_train_state(model: nn.Module, state: Mapping[str, Any]
                       ) -> Dict[str, Any]:
    """The JAX package's train-state tree, with numpy leaves, of a port
    train state: the inverse of :func:`load_jax_train_state`. Every leaf is
    copied to the host here (the card's tensors included), the layer
    leaves stacked on axis 0, with the JAX state's dtypes (f32 params,
    moments and error buffer; int32 step and count)."""
    from repro_torch.checkpoint.checkpointer import to_host

    if getattr(model, "comm", None) is not None:
        # a sharded model's state: every leaf gathered whole first
        from repro_torch.parallel.shard import gather_train_state
        state = gather_train_state(model, state)
    # to_host copies each tensor: the trainer updates them in place
    return _train_state_layout(model, state, to_host, np.stack)


def restore_train_state(checkpointer, model: nn.Module,
                        state: Dict[str, Any], step=None):
    """Read the checkpoint ``step`` (default: the latest) of ``checkpointer``,
    written in the JAX layout by either package, into the port train state
    ``state`` in place: the params into ``model``'s parameters, the moments,
    count, step and error buffer into ``state``. A sharded model (on any
    mesh, whatever mesh wrote the checkpoint) reads its shards. Returns
    ``(state, metadata)``."""
    template = _train_state_layout(model, state, lambda t: None,
                                   lambda vals: None)
    shardings = None
    if getattr(model, "comm", None) is not None:
        # each rank reads its shards of the stored whole leaves
        from repro_torch.parallel.shard import train_state_shardings_tree
        shardings = train_state_shardings_tree(model, state)
    jstate, meta = checkpointer.restore(template, step, shardings=shardings)
    load_jax_params(model, jstate["params"])
    _copy_train_state(model, state, jstate)
    return state, meta
