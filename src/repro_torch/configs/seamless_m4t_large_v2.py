"""SeamlessM4T large v2 [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large].

Encoder-decoder transformer backbone: 24 encoder + 24 decoder layers,
d_model 1024, 16 heads (kv 16) of 64, d_ff 8192 (GELU), vocab 256206,
LayerNorm, QKV biases. The speech frontend is a STUB: batches carry
precomputed frame embeddings (B, frames, frontend_dim)
(:func:`repro_torch.data.pipeline.with_extras`), which ``frontend_proj``
maps into the encoder's stream."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,             # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    norm_type="layernorm",
    qkv_bias=True,
    frontend="audio_stub",
    frontend_dim=1024,
    frontend_len=1024,       # encoder frames per example
)
