"""Model zoo of the port: the decoder-only LM and the enc-dec model."""

from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, LMCallOptions
from repro_torch.models.registry import build_model
