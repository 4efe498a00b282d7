"""Stationary-residue weights: the program-once MMVMU dataflow (port of
``repro.core.stationary``).

The photonic core programs a weight tile into its phase shifters ONCE and
streams activations against it (paper §III-A), so BFP quantization,
forward conversion to residues, DAC re-gridding and programming drift are
paid per programming event, not per GEMM. :class:`StationaryResidues` is
that programmed tile in the ``(n_mod, G, g, N)`` group-major layout the RNS
backends consume; backends whose registry entry sets
``supports_stationary_residues`` take it in the ``w`` slot and skip the
weight side. The serving engine encodes every ``Dense`` weight once at
construction (:func:`encode_stationary_params`) and installs the encodings
on the modules (:func:`install`), where ``models.common.dense`` finds them.

The MoE layer's expert stacks (``gate``, ``up``, ``down``: ``(E, K, N)``)
are programmed into stacked residues ``(n_mod, E, G, g, N)``, installed on
the MoE module, with one drift draw per expert (the JAX package splits the
layer's key per expert); the router stays raw, as in the JAX package.

The tied embedding (``embed.emb``) is never encoded: the head GEMM reads
``emb.T`` raw and encodes it per call, as in the JAX package. Clean-channel
encodings equal what the backends compute per call; with
``phase_drift_sigma > 0`` the drift is drawn once, at encoding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import bfp, rns


@dataclasses.dataclass(frozen=True)
class StationaryResidues:
    """A residue-encoded, channel-programmed stationary GEMM weight.

    residues: int32 ``(n_mod, G, g, N)`` programmed residues over ``moduli``
      (``(n_mod, E, G, g, N)`` for a stack of E experts).
    scale: f32 ``(G, 1, N)`` BFP group scales (powers of two); ``(E, G, 1,
      N)`` for a stack.
    b_m / g / orig_k: BFP parameters and the original contraction length.
    """

    residues: torch.Tensor
    scale: torch.Tensor
    moduli: Tuple[int, ...]
    b_m: int
    g: int
    orig_k: int

    @property
    def n_out(self) -> int:
        return int(self.residues.shape[-1])

    @property
    def n_experts(self) -> Optional[int]:
        """E of a stack of expert weights, None for one (K, N) weight."""
        return int(self.residues.shape[1]) if self.residues.dim() == 5 \
            else None

    def __getitem__(self, e: int) -> "StationaryResidues":
        """Expert ``e`` of a stack."""
        return dataclasses.replace(self, residues=self.residues[:, e],
                                   scale=self.scale[e])

    def check_matches(self, policy, moduli: Tuple[int, ...],
                      k_dim: int) -> None:
        """Consistency check against the executing policy."""
        if tuple(self.moduli) != tuple(moduli):
            raise ValueError(
                f"stationary residues were programmed over moduli "
                f"{self.moduli} but the policy executes over {moduli} — "
                f"re-encode with the policy that will run them")
        if (self.b_m, self.g) != (policy.b_m, policy.g):
            raise ValueError(
                f"stationary residues use BFP(b_m={self.b_m}, g={self.g}) "
                f"but the policy is BFP(b_m={policy.b_m}, g={policy.g})")
        if self.orig_k != k_dim:
            raise ValueError(
                f"stationary residues hold a K={self.orig_k} weight but the "
                f"activation contraction dim is K={k_dim}")


def stationary_moduli(policy) -> Tuple[int, ...]:
    """Moduli a stationary weight is programmed over: base + redundant for
    the error-corrected modes, base otherwise."""
    if policy.mode in ("mirage_rrns", "mirage_rrns_ref"):
        from repro_torch.analog import rrns
        return rrns.rrns_moduli(policy)
    return tuple(policy.moduli)


def leaf_generator(policy, path: str,
                   device) -> Optional[torch.Generator]:
    """Deterministic programming generator of one parameter path, seeded
    from ``noise_seed`` and the path (the JAX package folds the same two
    into its key). None without a seed."""
    from repro_torch.analog.channel import seeded_generator
    if policy.noise_seed is None:
        return None
    return seeded_generator(device, "program", policy.noise_seed, path)


def _carries_channel(policy) -> bool:
    return policy.mode in ("mirage_rns_noisy", "mirage_rrns",
                           "mirage_rrns_ref")


def encode_stationary(w: torch.Tensor, policy,
                      moduli: Optional[Sequence[int]] = None,
                      draws=None) -> StationaryResidues:
    """Program one ``(K, N)`` weight into stationary residues: BFP-quantize
    along K, convert to ``moduli`` residues, then (channel-carrying modes)
    the program-side chain, DAC re-grid + drift drawn from ``draws``.

    A stack ``(E, K, N)`` programs each expert with its own drift draw:
    ``draws`` is then a sequence of E draws (the JAX package's split of
    the key per expert), or one that every expert draws from in turn."""
    from repro_torch.analog import channel
    moduli = tuple(moduli) if moduli is not None else \
        stationary_moduli(policy)
    cfg = channel.AnalogChannelConfig.from_policy(policy)
    drift = _carries_channel(policy) and cfg.phase_drift_sigma > 0
    if w.dim() == 3 and drift:
        if draws is None:
            gen = leaf_generator(policy, "stationary", w.device)
            draws = None if gen is None else channel.GeneratorDraws(gen)
        each = list(draws) if isinstance(draws, (list, tuple)) else \
            [draws] * w.shape[0]
        if len(each) != w.shape[0]:
            raise ValueError(f"{len(each)} draws for a stack of "
                             f"{w.shape[0]} experts")
        parts = [encode_stationary(w[e], policy, moduli, each[e])
                 for e in range(w.shape[0])]
        return StationaryResidues(
            residues=torch.stack([p.residues for p in parts], dim=1),
            scale=torch.stack([p.scale for p in parts]), moduli=moduli,
            b_m=policy.b_m, g=policy.g, orig_k=int(w.shape[-2]))
    qw, sw = bfp.bfp_quantize_contract(w, policy.b_m, policy.g,
                                       policy.rounding)   # ([E,] G, g, N)
    wr = rns.to_rns(qw, moduli)                # (n_mod, [E,] G, g, N) int32
    if _carries_channel(policy):
        if drift and draws is None:
            gen = leaf_generator(policy, "stationary", w.device)
            if gen is None:
                raise ValueError(
                    "phase_drift_sigma > 0 needs programming draws: pass "
                    "draws= or set policy.noise_seed")
            draws = channel.GeneratorDraws(gen)
        wr = channel.apply_program_channel(wr, moduli, cfg, draws,
                                           stack=w.dim() == 3)
    return StationaryResidues(residues=wr, scale=sw, moduli=moduli,
                              b_m=policy.b_m, g=policy.g,
                              orig_k=int(w.shape[-2]))


def _dense_modules(model):
    from repro_torch.models.common import Dense
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, Dense)]


def jax_path(module_name: str) -> str:
    """The JAX parameter path of a port ``Dense`` module's weight: layer
    indices dropped (the JAX tree stacks layers), ``/``-joined, ``/w``."""
    parts = [p for p in module_name.split(".") if not p.isdigit()]
    return "/".join(parts + ["w"])


#: the expert stacks of the MoE layer the engine programs (the router's
#: matmul runs plain f32, as in the JAX package)
MOE_STACKS = ("gate", "up", "down")


def _moe_modules(model):
    from repro_torch.models.moe import MoE
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, MoE)]


@torch.no_grad()
def encode_stationary_params(model, policy
                             ) -> Dict[str, StationaryResidues]:
    """Program every GEMM weight of ``model`` into stationary residues,
    keyed by module name (``Dense`` modules) or ``<MoE module>.<stack>``
    (the expert stacks). Norms, biases, the embedding and the MoE router
    stay raw. Programming drift draws from one generator per JAX parameter
    path (:func:`leaf_generator`), layer after layer and, in a stack,
    expert after expert, as the JAX package splits one key per path into
    per-layer, then per-expert keys."""
    from repro_torch.analog import channel
    from repro_torch.models.moe import MoE
    cfg = channel.AnalogChannelConfig.from_policy(policy)
    drift = _carries_channel(policy) and cfg.phase_drift_sigma > 0
    if drift and policy.noise_seed is None:
        raise ValueError("phase_drift_sigma > 0 needs policy.noise_seed to "
                         "program stationary weights")
    gens: Dict[str, torch.Generator] = {}

    def draws_of(path, device):
        if not drift:
            return None
        if path not in gens:
            gens[path] = leaf_generator(policy, path, device)
        return channel.GeneratorDraws(gens[path])

    out = {}
    for name, mod in _dense_modules(model):
        if name.split(".")[-1] == "router" and \
                isinstance(model.get_submodule(name.rsplit(".", 1)[0]), MoE):
            continue
        out[name] = encode_stationary(
            mod.w, policy, draws=draws_of(jax_path(name), mod.w.device))
    for name, mod in _moe_modules(model):
        for stack in MOE_STACKS:
            w = getattr(mod, stack)
            path = "/".join([p for p in name.split(".")
                             if not p.isdigit()] + [stack])
            out[f"{name}.{stack}"] = encode_stationary(
                w, policy, draws=draws_of(path, w.device))
    return out


def install(model, encodings: Optional[Dict[str, StationaryResidues]]
            ) -> None:
    """Attach ``encodings`` (module name, or ``<MoE module>.<stack>``, ->
    residues) to the model's ``Dense`` and MoE modules, clearing every
    other module's; ``None`` clears all. ``models.common.dense`` and
    ``models.moe.moe_apply`` run an installed encoding in place of the
    raw weight."""
    encodings = encodings or {}
    for name, mod in _dense_modules(model):
        mod.stationary = encodings.get(name)
    for name, mod in _moe_modules(model):
        stacks = {k: encodings[f"{name}.{k}"] for k in MOE_STACKS
                  if f"{name}.{k}" in encodings}
        mod.stationary = stacks or None
