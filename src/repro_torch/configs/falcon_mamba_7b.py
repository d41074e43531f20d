"""Falcon-Mamba-7B — attention-free mamba-1 architecture [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig, register

FALCON_MAMBA_7B = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    d_inner=8192,
    dt_rank=256,
    source="arXiv:2410.05355; unverified",
))
