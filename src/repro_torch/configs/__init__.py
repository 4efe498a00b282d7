"""Architecture registry of the port: every architecture of the JAX
package (the dense qwen2/qwen3 configs, command-r's parallel block, the vlm
internvl2, the MoE family mixtral and qwen3-moe, the SSM family mamba2, the
hybrid family zamba2 and the enc-dec family seamless-m4t)."""

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
from repro_torch.configs.seamless_m4t_large_v2 import \
    CONFIG as seamless_m4t_large_v2
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b

ARCHS = {c.arch_id: c for c in (qwen2_0_5b, qwen2_1_5b, qwen3_14b,
                                command_r_plus_104b, internvl2_2b,
                                mixtral_8x7b, qwen3_moe_30b_a3b,
                                mamba2_2_7b, zamba2_2_7b,
                                seamless_m4t_large_v2)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "command_r_plus_104b", "get_config",
           "internvl2_2b", "mamba2_2_7b", "mixtral_8x7b", "qwen2_0_5b",
           "qwen2_1_5b", "qwen3_14b", "qwen3_moe_30b_a3b",
           "seamless_m4t_large_v2", "zamba2_2_7b"]
