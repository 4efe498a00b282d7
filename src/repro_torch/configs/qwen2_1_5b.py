"""Qwen2 1.5B [arXiv:2407.10671; hf:Qwen/Qwen2-1.5B].

28L, d_model 1536, 12 heads (2 KV), d_ff 8960, vocab 151936. QKV bias,
tied embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
