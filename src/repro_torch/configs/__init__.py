"""Architecture registry of the port.

The dense qwen2/qwen3 configs, command-r's parallel block, the vlm
(internvl2), the MoE family (mixtral, qwen3-moe), the SSM family (mamba2)
and the hybrid family (zamba2) are ported. The JAX package's other
architecture raises ``NotImplementedError`` naming the ROADMAP queue where
its family waits.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.command_r_plus_104b import \
    CONFIG as command_r_plus_104b
from repro_torch.configs.internvl2_2b import CONFIG as internvl2_2b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b

ARCHS = {c.arch_id: c for c in (qwen2_0_5b, qwen2_1_5b, qwen3_14b,
                                command_r_plus_104b, internvl2_2b,
                                mixtral_8x7b, qwen3_moe_30b_a3b,
                                mamba2_2_7b, zamba2_2_7b)}

#: architectures of the JAX package not ported yet, and where they wait
_NOT_PORTED = {
    "seamless-m4t-large-v2":
        "ROADMAP.md queue 1, slice 6, item 7.5 (enc-dec family)",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; it waits in "
            f"{_NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "command_r_plus_104b", "get_config",
           "internvl2_2b", "mamba2_2_7b", "mixtral_8x7b", "qwen2_0_5b",
           "qwen2_1_5b", "qwen3_14b", "qwen3_moe_30b_a3b", "zamba2_2_7b"]
