"""Plain PyTorch versions of the selective-scan kernels.

``selective_scan_ref`` ports ``repro.kernels.ssm_scan.ref.ssm_scan_ref``:
the mamba-1 recurrence stepped sequentially over the sequence in float32,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = sum_n h_t * C_t + D * x_t

with y in x's type. It also returns the last state, which the model's
``selective_scan`` hands to decode, and, when asked, the state entering
each chunk of ``CHUNK`` steps, which the forward kernel saves for the
backward. ``selective_scan_bwd_ref`` is the backward's plain version: the
reverse recurrence on the adjoint state, chunk by chunk from those states,
as the backward kernel walks it. The CPU path runs both (``ops.
SelectiveScanFn``), ``impl="plain"`` runs the forward on any device under
autograd, and ``chip_smoke.py`` holds the kernels against them on the card.
Float64 inputs are computed in float64 (the gradient tests' reference).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

CHUNK = 64   # steps per chunk of the kernels (scan::T in csrc/scan_common.cuh)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def selective_scan_ref(
    x: torch.Tensor,       # (B, S, Di)
    dt: torch.Tensor,      # (B, S, Di), already softplus'd
    b: torch.Tensor,       # (B, S, N)
    c: torch.Tensor,       # (B, S, N)
    a: torch.Tensor,       # (Di, N), negative: -exp(A_log)
    d: torch.Tensor,       # (Di,)
    *,
    h0: Optional[torch.Tensor] = None,   # (B, Di, N) float32
    return_chunk_states: bool = False,
):
    """Returns (y (B, S, Di) in x's type, h_last (B, Di, N) float32), and
    with ``return_chunk_states`` also the state entering each chunk of
    ``CHUNK`` steps, (B, ceil(S / CHUNK), Di, N) float32 (h0 or 0 first)."""
    Bsz, S, Di = x.shape
    N = a.shape[1]
    wt = _work_dtype(x)
    xf, dtf = x.to(wt), dt.to(wt)
    bf, cf, af = b.to(wt), c.to(wt), a.to(wt)
    h = torch.zeros((Bsz, Di, N), dtype=wt, device=x.device) \
        if h0 is None else h0.to(wt).clone()
    dtx = dtf * xf
    ys, starts = [], []
    for t in range(S):
        if t % CHUNK == 0:
            starts.append(h)
        abar = torch.exp(dtf[:, t, :, None] * af)                 # (B, Di, N)
        h = abar * h + dtx[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if S else xf.new_zeros((Bsz, 0, Di))
    y = y + xf * d.to(wt)
    if not return_chunk_states:
        return y.to(x.dtype), h
    chunks = torch.stack(starts, dim=1) if S else h.new_zeros((Bsz, 0, Di, N))
    return y.to(x.dtype), h, chunks


def selective_scan_bwd_ref(
    x: torch.Tensor,       # (B, S, Di)
    dt: torch.Tensor,      # (B, S, Di)
    b: torch.Tensor,       # (B, S, N)
    c: torch.Tensor,       # (B, S, N)
    a: torch.Tensor,       # (Di, N)
    d: torch.Tensor,       # (Di,)
    dy: torch.Tensor,      # (B, S, Di), the gradient of y
    *,
    h0: Optional[torch.Tensor] = None,          # (B, Di, N)
    dh_last: Optional[torch.Tensor] = None,     # (B, Di, N), the gradient of h_last
    chunk_states: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dx in x's type, ddt, db, dc, da, dd, dh0), the rest float32: the
    gradients of ``selective_scan_ref``'s (y, h_last). With Abar_t =
    exp(dt_t A), per (b, d, n), for t from S-1 down to 0 from g = dh_last
    (or 0):

        g += C_t dy_t
        dC_t = sum_d dy_t h_t          dB_t = sum_d g dt_t x_t
        dx_t = dt_t sum_n g B_t + D dy_t
        ddt_t = sum_n g (A Abar_t h_{t-1} + x_t B_t)
        dA += sum_b g dt_t Abar_t h_{t-1};   g <- Abar_t g

    then dD = sum_{b,t} dy x and dh0 = g. ``chunk_states`` are the states
    entering each chunk (``selective_scan_ref(..., return_chunk_states=
    True)[2]``, or what the forward kernel saved); without them they are
    computed here from h0. Each chunk's states are recomputed from its
    start, as the kernel does."""
    Bsz, S, Di = x.shape
    N = a.shape[1]
    wt = _work_dtype(x)
    xf, dtf, bf, cf, af, dyf = (t.to(wt) for t in (x, dt, b, c, a, dy))
    if chunk_states is None:
        chunk_states = selective_scan_ref(x, dt, b, c, a, d, h0=h0,
                                          return_chunk_states=True)[2]
    g = torch.zeros((Bsz, Di, N), dtype=wt, device=x.device) \
        if dh_last is None else dh_last.to(wt).clone()
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(bf)
    da = torch.zeros_like(af)
    dtx = dtf * xf
    for k in reversed(range(chunk_states.shape[1])):
        t0, t1 = k * CHUNK, min(S, (k + 1) * CHUNK)
        hs = [chunk_states[:, k].to(wt)]
        abars = []
        for t in range(t0, t1):
            abars.append(torch.exp(dtf[:, t, :, None] * af))
            hs.append(abars[-1] * hs[-1] + dtx[:, t, :, None] * bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            i = t - t0
            abar, h_prev, h_t = abars[i], hs[i], hs[i + 1]
            g = g + cf[:, t, None, :] * dyf[:, t, :, None]
            dc[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], h_t)
            db[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
            gb = torch.einsum("bdn,bn->bd", g, bf[:, t])
            w = g * abar * h_prev
            dx[:, t] = dtf[:, t] * gb + d.to(wt) * dyf[:, t]
            ddt[:, t] = torch.einsum("bdn,dn->bd", w, af) + xf[:, t] * gb
            da = da + (w * dtf[:, t, :, None]).sum(0)
            g = abar * g
    dd = (dyf * xf).sum((0, 1))
    return dx.to(x.dtype), ddt, db, dc, da, dd, g


def ssm_scan_ref(x, dt, b, c, a_log, d) -> torch.Tensor:
    """The Pallas kernel's signature: takes ``a_log`` and returns y only."""
    return selective_scan_ref(x, dt, b, c, -torch.exp(a_log.float()), d)[0]
