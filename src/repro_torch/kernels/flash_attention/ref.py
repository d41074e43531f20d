"""Plain PyTorch version of the flash-attention kernel.

Port of ``repro.kernels.flash_attention.ref.attention_ref``: the whole score
matrix in float32, the same -1e30 masks and the same guard for fully masked
rows. The CPU tests run it, and ``chip_smoke.py`` holds the kernel against it
on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,       # (B, H, Sq, hd)
    k: torch.Tensor,       # (B, KV, Sk, hd)
    v: torch.Tensor,       # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float())
    s = s / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    p = p / l
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
