"""Qwen3-30B-A3B — MoE: 128 experts, top-8, QK-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, register

QWEN3_MOE_30B_A3B = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
