"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified].

Dense GQA decoder-only LM: 64L, d_model 12288, 96 heads (8 KV), d_ff 33792,
vocab 256000. No biases anywhere (Cohere style). Its layers are parallel
blocks: attention and the MLP both read the first norm's output
(:meth:`repro_torch.models.lm.LM._ffn_tail`)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    rope_theta=75_000_000.0,
)
