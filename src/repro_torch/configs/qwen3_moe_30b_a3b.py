"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L, d_model 2048, 32 heads (4 KV), vocab 151936; MoE: 128 experts, top-8,
per-expert d_ff 768 (gated). QK-norm per qwen3 family."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,               # kept equal to moe_d_ff for reporting
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
)
