"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig, register

MINITRON_8B = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    rope_theta=10_000.0,
    source="arXiv:2407.14679; hf",
))
