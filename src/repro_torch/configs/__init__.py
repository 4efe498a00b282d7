"""Architecture registry of the port.

Only qwen2-0.5b (the dense serving slice) is ported. The JAX package's other
architectures raise ``NotImplementedError`` naming the ROADMAP queue where
their family waits.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b

ARCHS = {c.arch_id: c for c in (qwen2_0_5b,)}

#: architectures of the JAX package not ported yet, and where they wait
_NOT_PORTED = {
    "qwen2-1.5b": "ROADMAP.md queue 1, slice 6 (other configs of the dense family)",
    "qwen3-14b": "ROADMAP.md queue 1, slice 6 (qk_norm dense family)",
    "command-r-plus-104b": "ROADMAP.md queue 1, slice 6 (parallel-block dense family)",
    "internvl2-2b": "ROADMAP.md queue 1, slice 6 (vlm frontend)",
    "mixtral-8x7b": "ROADMAP.md queue 1, slice 6 (MoE family)",
    "qwen3-moe-30b-a3b": "ROADMAP.md queue 1, slice 6 (MoE family)",
    "mamba2-2.7b": "ROADMAP.md queue 1, slice 6 (SSM family)",
    "zamba2-2.7b": "ROADMAP.md queue 1, slice 6 (hybrid family)",
    "seamless-m4t-large-v2": "ROADMAP.md queue 1, slice 6 (enc-dec family)",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; it waits in "
            f"{_NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "get_config", "qwen2_0_5b"]
