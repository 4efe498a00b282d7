"""Mamba2 2.7B [arXiv:2405.21060; unverified].

Pure SSM (SSD / state-space duality): 64 layers, d_model 2560 (attention-free),
vocab 50280, ssm_state 128, headdim 64 (=> 80 SSD heads at expand=2)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,             # no MLP blocks in mamba2
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
