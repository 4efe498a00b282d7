"""Analog signal chain + RRNS fault tolerance (port of ``repro.analog``,
paper §IV-B, §VII).

  device.py   §IV-B device constants and shot/thermal SNR models (a copy)
  channel.py  AnalogChannelConfig + DAC / drift / detector / ADC /
              crosstalk / burst stages on residue tensors
  rrns.py     RRNS encode + fused single-pass majority decode
  sweep.py    accuracy-vs-SNR campaigns (GEMM error and training loss)
"""

from repro_torch.analog.channel import (
    AnalogChannelConfig,
    GeneratorDraws,
    apply_program_channel,
    apply_readout_channel,
    detector_sigma_levels,
)
from repro_torch.analog.rrns import (
    RRNSTables,
    build_tables,
    default_redundant_moduli,
    get_tables,
    rrns_decode,
    rrns_encode,
)

__all__ = [
    "AnalogChannelConfig",
    "GeneratorDraws",
    "apply_program_channel",
    "apply_readout_channel",
    "detector_sigma_levels",
    "RRNSTables",
    "build_tables",
    "default_redundant_moduli",
    "get_tables",
    "rrns_decode",
    "rrns_encode",
]
