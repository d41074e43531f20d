"""InternVL2-76B backbone — InternLM2-style decoder [arXiv:2404.16821].

Backbone only: the InternViT frontend is a stub; ``input_specs()`` provides
``pixel_embeds`` — 256 precomputed patch embeddings prepended to the text
sequence (loss is masked over the vision prefix).
"""
from repro_torch.configs.base import ModelConfig, register

INTERNVL2_76B = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    vision_prefix=256,
    rope_theta=500_000.0,
    source="arXiv:2404.16821; unverified",
))
