"""Shared building blocks: norms, RoPE, embeddings, MLP.

Port of ``repro.models.layers`` (``:50-102``). The sharding helpers and
``cross_entropy_chunked`` belong to the training slice.
"""
from __future__ import annotations

import torch


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """QK-norm: normalize over the trailing head_dim. scale: (head_dim,)."""
    return rms_norm(x, scale, eps)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # a Python-scalar base: a tensor made from ``theta`` on a CUDA device
    # would be a host-to-device copy, which waits for the queued work
    return 1.0 / torch.pow(theta, exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    Half-split rotation: the first half of head_dim pairs with the second.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs     # (..., S, hd//2)
    cos = torch.cos(angles)[..., :, None, :]               # (..., S, 1, hd//2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Embedding
# --------------------------------------------------------------------------- #
def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return embedding[tokens].to(compute_dtype)


# --------------------------------------------------------------------------- #
# Dense SwiGLU MLP
# --------------------------------------------------------------------------- #
def swiglu_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); wi/wg: (D, F); wo: (F, D)."""
    h = x @ wi
    g = x @ wg
    h = h * torch.sigmoid(g.float()).to(h.dtype) * g  # silu(g)*h
    return h @ wo
