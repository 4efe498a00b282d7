"""GEMM backend protocol + registry (port of ``repro.core.backends.base``).

Every execution mode of the GEMM is a :class:`GemmBackend` registered here by
name. ``core.gemm`` dispatches on ``policy.mode`` through :func:`resolve`, so
new modes plug in by registration alone.

A backend's ``fn`` has signature ``fn(x, w, policy)``, and
``fn(x, w, policy, *, draws=None)`` when it ``supports_noise``:

  x: (..., K) activations   w: (K, N) weights (or a
  :class:`repro_torch.core.stationary.StationaryResidues` where
  ``supports_stationary_residues``; or a stack ``(E, K, N)`` with
  ``x (E, M, K)`` where ``supports_batched_weights``)   policy: MiragePolicy
  draws: the random numbers of the analog channel
  (:class:`repro_torch.analog.channel.Draws`)

Capability flags let consumers reason about a mode without comparing mode
names. Every mode of ``GEMM_MODES`` has a backend.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GemmBackend:
    """A registered GEMM execution strategy.

    Attributes:
      name: registry key; ``MiragePolicy.mode`` strings resolve to this.
      fn: forward implementation ``(x, w, policy) -> (..., N)``.
      description: one-liner for listings.
      quantized: operands are quantized (not an exact-f32 baseline).
      supports_weight_stationary: honours ``policy.assume_quantized_weights``.
      weight_stationary_aligned_only: the weight-stationary skip is exact
        only for an operand quantized along the same contraction grouping.
      supports_noise: honours the analog-noise policy fields.
      supports_stationary_residues: accepts pre-encoded stationary residues.
      supports_batched_weights: takes a stack of E weights ``(E, K, N)``
        with ``x (E, M, K)``, each expert's product the one of its own
        ``(K, N)`` weight (the JAX package's vmap over the MoE experts).
      reference: an oracle kept for parity testing, not a deployment path.
    """

    name: str
    fn: Callable[..., torch.Tensor]
    description: str = ""
    quantized: bool = True
    supports_weight_stationary: bool = False
    weight_stationary_aligned_only: bool = False
    supports_noise: bool = False
    supports_stationary_residues: bool = False
    supports_batched_weights: bool = False
    reference: bool = False

    def forward(self, x: torch.Tensor, w, policy,
                draws=None) -> torch.Tensor:
        if self.supports_noise:
            return self.fn(x, w, policy, draws=draws)
        return self.fn(x, w, policy)


_REGISTRY: Dict[str, GemmBackend] = {}

def register(backend: GemmBackend) -> GemmBackend:
    """Register (or replace) a backend under ``backend.name``."""
    _REGISTRY[backend.name] = backend
    return backend


def register_fn(name: str, **flags):
    """Decorator: register a plain forward function as a backend."""

    def deco(fn):
        register(GemmBackend(name=name, fn=fn, **flags))
        return fn

    return deco


def get_backend(name: str) -> GemmBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no GEMM backend registered under {name!r}; "
            f"available: {sorted(_REGISTRY)}"
        ) from None


def resolve(policy) -> GemmBackend:
    """Backend for a policy's mode string."""
    return get_backend(policy.mode)


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def is_registered(name: str) -> bool:
    return name in _REGISTRY
