"""MusicGen-Large backbone — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a stub; ``input_specs()`` provides
token ids over the 2048-entry codebook. (kv=32 == MHA.)
"""
from repro_torch.configs.base import ModelConfig, register

MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    audio_tokens=True,
    rope_theta=10_000.0,
    source="arXiv:2306.05284; hf",
))
