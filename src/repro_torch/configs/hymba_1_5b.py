"""Hymba-1.5B — hybrid: parallel attention + mamba heads [arXiv:2411.13676; hf].

Simplification recorded in DESIGN.md: all layers use the hybrid block with
sliding-window attention (the published model keeps a few global-attention
layers); head fusion is the mean of the attention and SSM branches after
per-branch normalization.
"""
from repro_torch.configs.base import ModelConfig, register

HYMBA_1_5B = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    ssm_conv=4,
    d_inner=3200,
    dt_rank=100,
    sliding_window=2048,
    rope_theta=10_000.0,
    source="arXiv:2411.13676; hf",
))
