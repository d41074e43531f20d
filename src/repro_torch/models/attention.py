"""GQA attention: full/causal/sliding-window, chunked long-seq path, decode.

Port of ``repro.models.attention``. ``attention_xla`` keeps the reference's
plain math (the additive -1e30 mask, the ``q_chunk`` path) for CPU tensors
and for ``impl="plain"``; on CUDA tensors its core is the flash-attention
kernel (``repro_torch.kernels.flash_attention``), as the reference's
docstring says the Pallas kernel replaces it on the accelerator.
``decode_attention_xla`` is plain PyTorch everywhere.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import attention as flash_attention

NEG_INF = -1e30


def _mask_bias(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int,
    kv_len: Optional[int],
) -> torch.Tensor:
    """Additive mask bias (Sq, Sk) in float32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    if kv_len is not None:
        ok &= k_pos[None, :] < kv_len
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, zero + NEG_INF)


def _sdpa(q, k, v, bias, scale):
    """q: (B,Sq,KV,G,hd), k/v: (B,Sk,KV,hd), bias: (Sq,Sk) -> (B,Sq,KV,G,hd)."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    q_chunk: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """GQA attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd). Returns (B, Sq, H, hd).
    ``impl="auto"`` runs the flash kernel on CUDA tensors and the plain math
    on the CPU; ``impl="plain"`` runs the plain math on any device (the
    on-card reference). ``q_chunk > 0`` splits the plain math over query
    chunks so Sq x Sk scores never materialize at once.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if impl == "auto" and q.is_cuda:
        if q_offset or kv_len is not None:
            raise NotImplementedError("the flash kernel takes q_offset=0, kv_len=None")
        return flash_attention(q, k, v, causal=causal, window=window)

    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scale = 1.0 / (hd ** 0.5)
    Sk = k.shape[1]
    k_pos = torch.arange(Sk, device=q.device)

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        outs = []
        for i in range(Sq // q_chunk):
            q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=q.device)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
            qc = qg[:, i * q_chunk:(i + 1) * q_chunk]
            outs.append(_sdpa(qc, k, v, bias, scale))
        out = torch.cat(outs, dim=1)
    else:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        bias = _mask_bias(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
        out = _sdpa(qg, k, v, bias, scale)
    return out.reshape(B, Sq, H, hd)


def decode_attention_xla(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_index: int,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-token decode. q: (B, 1, H, hd); caches: (B, S, KV, hd).

    ``cur_index`` is the position of the query token; cache entries at
    positions <= cur_index are attended (the new token's k/v must already be
    written). Sliding window limits attention to the last ``window`` keys.
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    scale = 1.0 / (hd ** 0.5)
    S = k_cache.shape[1]
    k_pos = torch.arange(S, device=q.device)
    ok = k_pos <= cur_index
    if window > 0:
        ok &= k_pos > (cur_index - window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, zero + NEG_INF)  # (S,)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, H, hd)
