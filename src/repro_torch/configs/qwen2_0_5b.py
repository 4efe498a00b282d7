"""Qwen2 0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B].

24L, d_model 896, 14 heads (2 KV), d_ff 4864, vocab 151936. QKV bias,
tied embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
