"""Zamba2 2.7B [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

Hybrid: 54 Mamba2 layers with a SHARED attention(+MLP) block applied every 6
layers (weights reused at each application; the block input concatenates the
original embeddings with the running hidden state, Zamba-style).
d_model 2560, 32 MHA heads (kv=32), shared-block d_ff 10240, vocab 32000,
ssm_state 64."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
)
