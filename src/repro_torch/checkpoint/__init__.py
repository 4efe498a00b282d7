"""Checkpoints of the port (numpy files plus a manifest, the JAX package's
on-disk format)."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
