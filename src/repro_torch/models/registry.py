"""Model factory (port of ``repro.models.registry.build_model``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import MiragePolicy, PAPER_POLICY
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, LMCallOptions


def build_model(cfg: ModelConfig, policy: MiragePolicy = PAPER_POLICY,
                options: LMCallOptions = LMCallOptions(), *,
                device: Optional[Union[str, torch.device]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Union[LM, EncDec]:
    """The model for ``cfg`` on ``device`` (the card unless ``"cpu"``):
    :class:`EncDec` for the enc-dec family, else the decoder-only
    :class:`LM`."""
    cls = EncDec if cfg.is_encdec else LM
    return cls(cfg, policy, options, device=device, generator=generator)
