"""Plain PyTorch version of the selective-scan kernel.

Port of ``repro.kernels.ssm_scan.ref.ssm_scan_ref``: the mamba-1 recurrence
stepped sequentially over the sequence in float32,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = sum_n h_t * C_t + D * x_t

with y in x's type. It also returns the last state, which the model's
``selective_scan`` hands to decode. The CPU tests run it, ``impl="plain"``
runs it on any device, and ``chip_smoke.py`` holds the kernel against it on
the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(
    x: torch.Tensor,       # (B, S, Di)
    dt: torch.Tensor,      # (B, S, Di), already softplus'd
    b: torch.Tensor,       # (B, S, N)
    c: torch.Tensor,       # (B, S, N)
    a: torch.Tensor,       # (Di, N), negative: -exp(A_log)
    d: torch.Tensor,       # (Di,)
    *,
    h0: Optional[torch.Tensor] = None,   # (B, Di, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, Di) in x's type, h_last (B, Di, N) float32)."""
    Bsz, S, Di = x.shape
    N = a.shape[1]
    xf, dtf = x.float(), dt.float()
    bf, cf, af = b.float(), c.float(), a.float()
    h = torch.zeros((Bsz, Di, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().clone()
    dtx = dtf * xf
    ys = []
    for t in range(S):
        abar = torch.exp(dtf[:, t, :, None] * af)                 # (B, Di, N)
        h = abar * h + dtx[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if S else xf.new_zeros((Bsz, 0, Di))
    y = y + xf * d.float()
    return y.to(x.dtype), h


def ssm_scan_ref(x, dt, b, c, a_log, d) -> torch.Tensor:
    """The Pallas kernel's signature: takes ``a_log`` and returns y only."""
    return selective_scan_ref(x, dt, b, c, -torch.exp(a_log.float()), d)[0]
