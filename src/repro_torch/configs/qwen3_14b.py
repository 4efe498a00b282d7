"""Qwen3 14B [hf:Qwen/Qwen3-14B; config per assignment].

40L, d_model 5120, 40 heads (8 KV), d_ff 17408, vocab 151936. QK-norm
(per-head RMSNorm on q and k), no QKV bias (qwen3 dropped it)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
