"""Shared building blocks: norms, RoPE, embeddings, MLP.

Port of ``repro.models.layers`` (``:50-142``), without the sharding
helpers, which wait for the distributed slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint


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


# --------------------------------------------------------------------------- #
# Chunked cross-entropy
# --------------------------------------------------------------------------- #
def _chunk_nll(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
               mc: torch.Tensor) -> torch.Tensor:
    logits = (xc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum((lse - gold) * mc)


def cross_entropy_chunked(
    x: torch.Tensor,
    head: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    *,
    chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded CE over sequence chunks, each chunk's logits
    recomputed in the backward pass (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint``).

    x: (B, S, D) final hidden states; head: (D, V); labels/mask: (B, S).
    Returns (sum_nll, sum_mask), float32 scalars. Logits are computed in
    the type of ``x`` and ``head`` and taken to float32.

    The chunks are the reference's, ``n = max(1, S // chunk)`` chunks of
    ``S // n`` positions, and then one more chunk of the positions they
    leave over. The reference drops those last ``S - n * (S // n)``
    positions from the NLL while counting them in ``sum_mask`` (ROADMAP,
    Queue 3): the port covers every position, and where S is a multiple of
    ``chunk`` both sum the same positions.
    """
    B, S, _ = x.shape
    n_chunks = max(1, S // chunk)
    c = S // n_chunks
    bounds = [(i * c, (i + 1) * c) for i in range(n_chunks)]
    if n_chunks * c < S:
        bounds.append((n_chunks * c, S))
    labels, mask = labels.long(), mask.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in bounds:
        args = (x[:, lo:hi], head, labels[:, lo:hi], mask[:, lo:hi])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total, torch.sum(mask)
