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

    residues: int32 ``(n_mod, G, g, N)`` programmed residues over ``moduli``.
    scale: f32 ``(G, 1, N)`` BFP group scales (powers of two).
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
    the program-side chain, DAC re-grid + drift drawn from ``draws``."""
    from repro_torch.analog import channel
    moduli = tuple(moduli) if moduli is not None else \
        stationary_moduli(policy)
    qw, sw = bfp.bfp_quantize_contract(w, policy.b_m, policy.g,
                                       policy.rounding)      # (G, g, N)
    wr = rns.to_rns(qw, moduli)                    # (n_mod, G, g, N) int32
    if _carries_channel(policy):
        cfg = channel.AnalogChannelConfig.from_policy(policy)
        if cfg.phase_drift_sigma > 0 and draws is None:
            gen = leaf_generator(policy, "stationary", w.device)
            if gen is None:
                raise ValueError(
                    "phase_drift_sigma > 0 needs programming draws: pass "
                    "draws= or set policy.noise_seed")
            draws = channel.GeneratorDraws(gen)
        wr = channel.apply_program_channel(wr, moduli, cfg, draws)
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


@torch.no_grad()
def encode_stationary_params(model, policy
                             ) -> Dict[str, StationaryResidues]:
    """Program every ``Dense`` weight of ``model`` into stationary
    residues, keyed by module name. Norms, biases and the embedding stay
    raw. Programming drift draws from one generator per JAX parameter path
    (:func:`leaf_generator`), layer after layer, as the JAX package splits
    one key per path into per-layer keys."""
    from repro_torch.analog import channel
    from repro_torch.core.gemm import MOE_MODES_ITEM
    from repro_torch.models.moe import MoE
    if any(isinstance(m, MoE) for m in model.modules()):
        raise NotImplementedError(
            f"stationary residues of the MoE layer's (E, K, N) expert "
            f"stacks wait in {MOE_MODES_ITEM}")
    cfg = channel.AnalogChannelConfig.from_policy(policy)
    drift = _carries_channel(policy) and cfg.phase_drift_sigma > 0
    if drift and policy.noise_seed is None:
        raise ValueError("phase_drift_sigma > 0 needs policy.noise_seed to "
                         "program stationary weights")
    gens: Dict[str, torch.Generator] = {}
    out = {}
    for name, mod in _dense_modules(model):
        draws = None
        if drift:
            path = jax_path(name)
            if path not in gens:
                gens[path] = leaf_generator(policy, path, mod.w.device)
            draws = channel.GeneratorDraws(gens[path])
        out[name] = encode_stationary(mod.w, policy, draws=draws)
    return out


def install(model, encodings: Optional[Dict[str, StationaryResidues]]
            ) -> None:
    """Attach ``encodings`` (module name -> residues) to the model's
    ``Dense`` modules, clearing every other module's; ``None`` clears all.
    ``models.common.dense`` runs an installed encoding in place of ``w``."""
    encodings = encodings or {}
    for name, mod in _dense_modules(model):
        mod.stationary = encodings.get(name)
