"""Plain PyTorch version of the flash-attention kernel.

Port of ``repro.kernels.flash_attention.ref.attention_ref``: the whole score
matrix in float32, the same -1e30 masks and the same guard for fully masked
rows. The CPU tests run it, and ``chip_smoke.py`` holds the kernel against it
on the card. ``attention_lse_ref`` is the plain version of the per-row
log-sum-exp that the forward kernels store for the backward, and
``attention_bwd_ref`` that of the backward kernels: the gradient of
``attention_ref`` written out in float32.
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


def attention_lse_ref(
    q: torch.Tensor,       # (B, H, Sq, hd)
    k: torch.Tensor,       # (B, KV, Sk, hd)
    v: torch.Tensor,       # (B, KV, Sk, hd), not read: the signature of attention_ref
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """(B, H, Sq) float32: the logsumexp over keys of each query row's
    masked scaled scores, as ``attention_ref`` forms them (masked entries
    -1e30, so a row with every key masked gives -1e30 + log Sk)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def attention_bwd_ref(
    q: torch.Tensor,       # (B, H, S, hd)
    k: torch.Tensor,       # (B, KV, S, hd)
    v: torch.Tensor,       # (B, KV, S, hd)
    o: torch.Tensor,       # (B, H, S, hd), attention_ref's output
    do: torch.Tensor,      # (B, H, S, hd), gradient of the output
    *,
    causal: bool = True,
    window: int = 0,
):
    """(dq, dk, dv) of ``attention_ref`` at (q, k, v) for the output
    gradient ``do``, in the inputs' type, computed in float32:

      P  = softmax(mask(Q K^T / sqrt(hd)))     (the forward's probabilities)
      dV = P^T dO                              (summed over the G heads of a group)
      dP = dO V^T
      dS = P * (dP - D),  D = rowsum(dO * O)
      dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd)

    D uses the output ``o`` as the kernel does (rowsum(P * dP) equals
    rowsum(dO * O) up to the rounding of O)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).float()
    dog = do.reshape(B, KV, G, Sq, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) / math.sqrt(hd)
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
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    dsum = (do.float() * o.float()).sum(dim=-1).reshape(B, KV, G, Sq, 1)
    ds = p * (dp - dsum)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) / math.sqrt(hd)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) / math.sqrt(hd)
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
