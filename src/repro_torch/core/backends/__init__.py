"""Pluggable GEMM backend registry (port of ``repro.core.backends``).

Importing this package registers every backend of the JAX package (the
fp32/bf16/int8 baselines, ``mirage_fast``, ``mirage_faithful``, the RNS
backends ``mirage_rns`` / ``mirage_rns_pallas``, the analog-channel
backends ``mirage_rns_noisy`` / ``mirage_rrns`` / ``mirage_rrns_ref`` and
the seed oracles ``mirage_faithful_ref`` / ``mirage_rns_ref``); external
code adds new modes with :func:`register` / :func:`register_fn`.
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
from repro_torch.core.backends import mirage_faithful  # noqa: F401
from repro_torch.core.backends import mirage_rns   # noqa: F401
from repro_torch.core.backends import mirage_rrns  # noqa: F401
from repro_torch.core.backends import reference    # noqa: F401

__all__ = [
    "GemmBackend",
    "available_backends",
    "get_backend",
    "is_registered",
    "register",
    "register_fn",
    "resolve",
]
