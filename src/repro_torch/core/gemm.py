"""Mirage GEMM dispatch and its differentiable op (port of ``repro.core.gemm``).

``x @ w`` under a :class:`MiragePolicy`, dispatching on ``policy.mode``
through the backend registry (:mod:`repro_torch.core.backends`).

Training: :func:`mirage_matmul` is a ``torch.autograd.Function``
(:class:`MirageMatmul`, the JAX package's ``custom_vjp``) whose backward
runs BOTH backward GEMMs (paper Eqs. 2-3) through the same backend, each
BFP-grouped along its own contraction: dX = dO @ W^T over N, dW = X^T @ dO
over the tokens. The caller keeps FP32 master weights (Eq. 4).

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
from typing import Optional

import torch

from repro_torch.core import backends
from repro_torch.core.backends import grouped
from repro_torch.core.precision import MiragePolicy
from repro_torch.core.stationary import StationaryResidues
from repro_torch.obs import health as obs_health
from repro_torch.obs import trace as obs_trace

_AMBIENT = threading.local()

@contextlib.contextmanager
def noise_scope(generator: torch.Generator,
                bursts: Optional[torch.Generator] = None):
    """Make ``generator`` the randomness of stochastic GEMMs inside the
    block (``bursts``, where given, that of their burst stages: see
    :class:`repro_torch.analog.channel.GeneratorDraws`). Re-entrant (inner
    scopes shadow)."""
    from repro_torch.analog.channel import GeneratorDraws
    stack = getattr(_AMBIENT, "stack", None)
    if stack is None:
        stack = _AMBIENT.stack = []
    stack.append(GeneratorDraws(generator, bursts))
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
    if grouped.is_stack(w) and not backend.supports_batched_weights:
        raise TypeError(
            f"backend {backend.name!r} takes one (K, N) weight, not a stack "
            f"of expert weights (capability flag supports_batched_weights "
            f"is unset)")
    if draws is None and backend.supports_noise:
        draws = _ambient_draws()
    with obs_trace.get_tracer().span(f"gemm.{policy.mode}"):
        return backend.forward(x, w, policy, draws=draws)


class MirageMatmul(torch.autograd.Function):
    """``x @ w`` with quantized forward AND backward GEMMs (``_mm_fwd`` /
    ``_mm_bwd`` of the JAX package). The forward saves ``(x, w)``; the
    backward keeps the JAX package's two policy swaps.

    A stack of expert weights, ``x (E, C, K) @ w (E, K, N)``, is the JAX
    package's ``vmap`` of ``_mm_bwd`` over the experts: each backward GEMM
    is one call over the whole stack, dX ``(E, C, N) @ (E, N, K)`` grouped
    along N and dW ``(E, K, C) @ (E, C, N)`` grouped along C, under every
    GEMM mode (the RNS family too, with its weight-stationary swap for
    every expert)."""

    @staticmethod
    def forward(ctx, x, w, policy):
        x = x.contiguous()
        ctx.policy = policy
        ctx.save_for_backward(x, w)
        return _forward_impl(x, w, policy)

    @staticmethod
    def backward(ctx, gout):
        x, w = ctx.saved_tensors
        policy = ctx.policy
        gout = gout.to(torch.float32).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dX = dO @ W^T (contraction over N). Under weight-stationary
            # quant the transposed read reuses the SAME stored grid values;
            # backends whose skip is exact only for aligned groupings
            # (group-dot/RNS) re-quantize the transposed read instead.
            dx_policy = policy
            if (policy.assume_quantized_weights and
                    backends.resolve(policy).weight_stationary_aligned_only):
                dx_policy = policy.replace(assume_quantized_weights=False)
            dx = _forward_impl(gout, w.transpose(-1, -2),
                               dx_policy).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # dW = X^T @ dO (contraction over tokens): neither operand is a
            # stationary weight, so both sides are always quantized
            dw_policy = (policy.replace(assume_quantized_weights=False)
                         if policy.assume_quantized_weights else policy)
            if w.dim() == 3:                           # per expert
                xt, gf = x.transpose(-1, -2), gout     # (E, K, C), (E, C, N)
            else:
                xt = x.reshape(-1, x.shape[-1]).T      # (K, M)
                gf = gout.reshape(-1, gout.shape[-1])  # (M, N)
            dw = _forward_impl(xt, gf, dw_policy).to(w.dtype)
        return dx, dw, None


def mirage_matmul(x: torch.Tensor, w: torch.Tensor,
                  policy: MiragePolicy) -> torch.Tensor:
    """``x @ w`` under the Mirage numerics policy, differentiable in both
    operands. x: (..., K), w: (K, N), or x (E, C, K) with a stack of expert
    weights w (E, K, N). A pre-encoded
    :class:`StationaryResidues` weight has no gradient and raises."""
    if isinstance(w, StationaryResidues):
        raise TypeError(
            "a StationaryResidues weight is programmed for serving and has "
            "no gradient; train on the FP32 weight, or run under "
            "torch.no_grad() / torch.inference_mode()")
    return MirageMatmul.apply(x, w, policy)


def mirage_matmul_nograd(x: torch.Tensor, w, policy: MiragePolicy,
                         draws=None) -> torch.Tensor:
    """Forward-only GEMM (serving paths). ``w`` is a ``(K, N)`` tensor, a
    stack ``(E, K, N)`` with ``x (E, M, K)`` (backends that
    ``supports_batched_weights``), or a :class:`StationaryResidues`.
    ``draws`` (a
    :class:`repro_torch.analog.channel.Draws`) feeds stochastic backends;
    without it they use the open :func:`noise_scope`, or
    ``policy.noise_seed``."""
    return _forward_impl(x, w, policy, draws)


def mirage_matmul_auto(x: torch.Tensor, w, policy: MiragePolicy
                       ) -> torch.Tensor:
    """The model's GEMM call site: :func:`mirage_matmul`, except under an
    open analog-health scope (the serving engine's forward-only steps, as
    in the JAX package) or with grad mode off, where the backward is dead
    weight and the forward runs straight."""
    if obs_health.active() or not torch.is_grad_enabled():
        return _forward_impl(x, w, policy)
    return mirage_matmul(x, w, policy)
