"""Pluggable GEMM backend registry (port of ``repro.core.backends``).

Importing this package registers every ported backend (the fp32/bf16/int8
baselines and ``mirage_fast``); external code adds new modes with
:func:`register` / :func:`register_fn`.
"""

from repro_torch.core.backends.base import (
    GemmBackend,
    available_backends,
    get_backend,
    is_registered,
    register,
    register_fn,
    resolve,
)

# Importing the implementation modules registers the built-in backends.
from repro_torch.core.backends import baselines    # noqa: F401  (fp32 / bf16 / int8)
from repro_torch.core.backends import mirage_fast  # noqa: F401

__all__ = [
    "GemmBackend",
    "available_backends",
    "get_backend",
    "is_registered",
    "register",
    "register_fn",
    "resolve",
]
