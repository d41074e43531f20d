"""Mixtral-8x7B — MoE: 8 experts, top-2, sliding-window attention [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig, register

MIXTRAL_8X7B = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32_000,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
))
