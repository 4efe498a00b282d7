"""PyTorch / CUDA port of the Mirage reproduction, for NVIDIA Hopper.

The module layout mirrors the JAX package ``repro`` so each counterpart is
easy to find: ``core`` (precision policies, BFP, RNS, GEMM backends,
stationary weights), ``analog`` (the photonic channel and RRNS),
``kernels`` (hand-written CUDA kernels, their wrappers and plain PyTorch
versions), ``models`` (the dense LM family), ``optim`` (optimizers,
schedules, BFP gradient compression), ``data`` (the synthetic and file
token sources), ``runtime`` (the serving engine and the trainer), ``obs``
(metrics, spans and analog-health counters) and ``launch`` (command-line
entry points for serving and training).

This package imports ``torch`` and never ``jax`` or ``repro``. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`). Inside, the tensor's device
decides the route: a CUDA tensor launches the hand-written kernel, a CPU
tensor takes the kernel's plain PyTorch version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
