"""Mixtral 8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1].

32L, d_model 4096, 32 heads (8 KV), vocab 32000; MoE: 8 experts, top-2,
per-expert d_ff 14336 (gated); sliding-window attention (4096)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=14336,
)
