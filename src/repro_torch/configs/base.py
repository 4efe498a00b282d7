"""Config dataclasses (port of ``repro.configs.base``): the model
architecture and the training run.

``reduced()`` derives the CPU test variant of an architecture (same
family/topology, tiny dims), exactly as the JAX package does, so both
packages build the same reduced model from one config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.precision import MiragePolicy, PAPER_POLICY


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | ssm | hybrid | moe | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    sliding_window: Optional[int] = None   # SWA (mixtral)
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0              # zamba2: shared attn block period (0 = none)
    # --- enc-dec ---
    encoder_layers: int = 0          # >0 -> encoder-decoder (n_layers = decoder)
    # --- modality frontend stubs ---
    frontend: Optional[str] = None   # vit_stub | audio_stub
    frontend_dim: int = 0            # stub embedding width
    frontend_len: int = 0            # patches / frames per example

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the unified decoder stack."""
        if self.family in ("ssm", "hybrid"):
            return ("mamba",) * self.n_layers
        if self.family == "moe":
            return ("attn_moe",) * self.n_layers
        return ("attn_mlp",) * self.n_layers

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the JAX package's cut)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            sliding_window=(32 if self.sliding_window else None),
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            capacity_factor=8.0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=8,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_dim=32 if self.frontend_dim else 0,
            frontend_len=8 if self.frontend_len else 0,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's training config, less its ``remat`` and ``zero1``
    fields, which its trainer does not read either (the model's
    ``LMCallOptions.remat`` checkpoints the layers; on a mesh ZeRO-1 is the
    fsdp component of the sharding rules, which shard every optimizer
    moment as its parameter: ``repro_torch.parallel.sharding
    .train_state_shardings``)."""
    policy: MiragePolicy = PAPER_POLICY
    optimizer: str = "adamw"          # sgdm | adam | adamw
    lr: float = 3e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    momentum: float = 0.9
    grad_clip: float = 1.0
    microbatches: int = 1             # gradient accumulation steps
    grad_compression: str = "none"    # none | bfp (error-feedback BFP)
    # Weight-stationary quantization (paper dataflow: program the tile once,
    # reuse): quantize GEMM weights ONCE per step outside the microbatch
    # loop; GEMMs skip their weight-side quantization; gradients flow
    # straight-through to the FP32 master (Eq. 4).
    weight_stationary_quant: bool = False
    quant_param_dtype: str = "float32"  # storage for pre-quantized weights
    seed: int = 0
