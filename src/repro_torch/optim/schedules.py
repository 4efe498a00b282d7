"""LR schedules (port of ``repro.optim.schedules``): the paper's step decay
(x0.1 every N steps), warmup-cosine and constant. Each maps a step (an
int32 0-d tensor or int) to an f32 0-d tensor."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def step_decay(base_lr: float, decay_every: int, factor: float = 0.1):
    """Paper Section V-B: lr scaled down by 10 after each `decay_every` steps."""
    def fn(step):
        k = torch.floor_divide(torch.as_tensor(step), decay_every).to(
            torch.float32)
        return base_lr * torch.pow(torch.tensor(factor, device=k.device), k)
    return fn


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi *
                                                              prog))
        return base_lr * warm * cos
    return fn


def constant(base_lr: float):
    def fn(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), base_lr, dtype=torch.float32, device=dev)
    return fn
