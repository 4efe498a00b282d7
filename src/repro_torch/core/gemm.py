"""Mirage GEMM dispatch, forward only (port of ``repro.core.gemm:134-219``).

``x @ w`` under a :class:`MiragePolicy`, dispatching on ``policy.mode``
through the backend registry (:mod:`repro_torch.core.backends`). This slice
serves, so only the forward entry points are ported: the differentiable op
(a ``torch.autograd.Function`` whose backward runs dX and dW through the same
backend) comes with the training slice, and the analog noise-key scopes with
the analog slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import backends
from repro_torch.core.precision import MiragePolicy


def _forward_impl(x: torch.Tensor, w: torch.Tensor,
                  policy: MiragePolicy) -> torch.Tensor:
    return backends.resolve(policy).forward(x, w, policy)


def mirage_matmul_nograd(x: torch.Tensor, w: torch.Tensor,
                         policy: MiragePolicy) -> torch.Tensor:
    """Forward-only GEMM (serving paths)."""
    return _forward_impl(x, w, policy)


def mirage_matmul_auto(x: torch.Tensor, w: torch.Tensor,
                       policy: MiragePolicy) -> torch.Tensor:
    """The model's GEMM call site. In the JAX package it picks the
    differentiable op unless a forward-only health scope is open; the port
    has only the forward so far, so it is :func:`mirage_matmul_nograd`."""
    return _forward_impl(x, w, policy)
