"""InternVL2 2B [arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B].

VLM: InternLM2-1.8B language backbone (24L, d_model 2048, 16 heads / 8 KV,
d_ff 8192, vocab 92553) + InternViT vision frontend. The vision tower is a
STUB: batches carry precomputed patch embeddings (B, patches, frontend_dim)
(:func:`repro_torch.data.pipeline.with_extras`), which an MLP projector
maps into the LM stream ahead of the text tokens."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    frontend="vit_stub",
    frontend_dim=1024,
    frontend_len=256,
)
