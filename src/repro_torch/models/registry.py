"""Model factory (port of ``repro.models.registry.build_model``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import MiragePolicy, PAPER_POLICY
from repro_torch.models.lm import LM, LMCallOptions


def build_model(cfg: ModelConfig, policy: MiragePolicy = PAPER_POLICY,
                options: LMCallOptions = LMCallOptions(), *,
                device: Optional[Union[str, torch.device]] = None,
                generator: Optional[torch.Generator] = None) -> LM:
    """The model for ``cfg`` on ``device`` (the card unless ``"cpu"``)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.arch_id}: the enc-dec family waits in ROADMAP.md queue 1, "
            f"slice 6")
    return LM(cfg, policy, options, device=device, generator=generator)
