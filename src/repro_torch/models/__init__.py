"""Model zoo of the port: the dense decoder-only LM."""

from repro_torch.models.lm import LM, LMCallOptions
from repro_torch.models.registry import build_model
