"""Mirage GEMM dispatch, forward only (port of ``repro.core.gemm``).

``x @ w`` under a :class:`MiragePolicy`, dispatching on ``policy.mode``
through the backend registry (:mod:`repro_torch.core.backends`). This slice
serves, so only the forward entry points are ported; the differentiable op
comes with the training slice.

Ambient noise (serving): the engine opens :func:`noise_scope` with one of
its device generators around each decode tick and prefill batch, and every
GEMM whose backend ``supports_noise`` and that got no explicit ``draws``
takes its random numbers from it. The JAX package folds a key per call
(``_ambient_subkey``) and per scanned layer (``fold_noise_scope``); a
generator's stream already advances with every draw, so each GEMM and each
layer of the port's Python loop draws fresh numbers without either.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core import backends
from repro_torch.core.precision import MiragePolicy
from repro_torch.core.stationary import StationaryResidues

_AMBIENT = threading.local()


@contextlib.contextmanager
def noise_scope(generator: torch.Generator):
    """Make ``generator`` the randomness of stochastic GEMMs inside the
    block. Re-entrant (inner scopes shadow)."""
    from repro_torch.analog.channel import GeneratorDraws
    stack = getattr(_AMBIENT, "stack", None)
    if stack is None:
        stack = _AMBIENT.stack = []
    stack.append(GeneratorDraws(generator))
    try:
        yield
    finally:
        stack.pop()


def _ambient_draws():
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def _forward_impl(x: torch.Tensor, w, policy: MiragePolicy,
                  draws=None) -> torch.Tensor:
    backend = backends.resolve(policy)
    if isinstance(w, StationaryResidues) and \
            not backend.supports_stationary_residues:
        raise TypeError(
            f"backend {backend.name!r} cannot execute a pre-encoded "
            f"StationaryResidues weight (capability flag "
            f"supports_stationary_residues is unset) — pass the raw FP32 "
            f"weight, or run an RNS-family mode")
    if draws is None and backend.supports_noise:
        draws = _ambient_draws()
    return backend.forward(x, w, policy, draws=draws)


def mirage_matmul_nograd(x: torch.Tensor, w, policy: MiragePolicy,
                         draws=None) -> torch.Tensor:
    """Forward-only GEMM (serving paths). ``w`` is a ``(K, N)`` tensor or a
    :class:`StationaryResidues`. ``draws`` (a
    :class:`repro_torch.analog.channel.Draws`) feeds stochastic backends;
    without it they use the open :func:`noise_scope`, or
    ``policy.noise_seed``."""
    return _forward_impl(x, w, policy, draws)


def mirage_matmul_auto(x: torch.Tensor, w, policy: MiragePolicy
                       ) -> torch.Tensor:
    """The model's GEMM call site. The JAX package picks its differentiable
    op unless a forward-only health scope is open; the port has only the
    forward so far, so every call goes straight to it."""
    return _forward_impl(x, w, policy)
