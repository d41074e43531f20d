"""Mamba-1 selective SSM block, in PyTorch.

Port of ``repro.models.ssm``. The reference's prefill scan is chunked (an
associative scan inside each chunk bounds the (B, chunk, Di, N) tensors it
materializes); here the scan is the selective-scan kernel on CUDA tensors
and the plain sequential recurrence on the CPU or with ``impl="plain"``
(``repro_torch.kernels.ssm_scan``). Neither materializes per-step
tensors larger than (B, Di, N), so there is no chunk size. Under autograd
the default path is ``SelectiveScanFn`` (the backward kernel on the card,
its plain version on the CPU); ``impl="plain"`` leaves the recurrence to
autograd on any device, with no kernel launch. Decode is the
O(1) single-step recurrence, plain PyTorch everywhere, as in the reference.
The casts follow the reference's (bf16 conv and projections, float32
scan), so bf16 drifts from JAX only where the two frameworks round.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.models.layers import counted_kernel, on_shards, scan_flops, spec


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, Di); w: (Di, K); b: (Di,).

    Accumulates in x's type over the taps in the reference's order."""
    K = w.shape[1]
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        shift = K - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * w[:, i][None, None, :]
    return out + b[None, None, :]


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)


def _ssm_params(x: torch.Tensor, p: Dict[str, torch.Tensor], dt_rank: int, n: int):
    """x: (B, S, Di) -> dt (B,S,Di) fp32, B_ (B,S,N) fp32, C (B,S,N) fp32."""
    proj = (x @ p["x_proj"]).float()
    dt_in, B_, C = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = dt_in @ p["dt_proj"].float()
    dt = F.softplus(dt + p["dt_bias"].float()[None, None, :])
    return dt, B_, C


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    B_: torch.Tensor,
    C: torch.Tensor,
    A: torch.Tensor,
    D: torch.Tensor,
    *,
    h0: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = SSM(x) with selective (input-dependent) dynamics.

    x: (B, S, Di); dt: (B, S, Di); B_/C: (B, S, N); A: (Di, N) (negative);
    D: (Di,) skip. Returns (y (B,S,Di) in x.dtype, h_last (B,Di,N) fp32).
    ``impl="auto"`` runs the kernels on CUDA tensors and the plain versions
    on the CPU, through ``SelectiveScanFn`` when autograd records;
    ``impl="plain"`` runs the plain recurrence on any device, differentiated
    by autograd.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if impl == "plain":
        return selective_scan_ref(x, dt, B_, C, A, D, h0=h0)
    return scan_ops.selective_scan(x, dt, B_, C, A, D, h0=h0)


def _scan_outline(x, dt, B_, C, A, D):
    """The scan's outputs, (y (B, S, Di) in x's type, h_last (B, Di, N)
    float32), as elementwise products of its inputs, each input reaching
    both: what a trace on fake tensors (the dry run, which has no values)
    needs of the scan, its shapes, types and autograd graph, without a
    Python loop over S steps. Its work is counted by the kernels' formula
    (``layers.counted_kernel``)."""
    first = (dt[:, :1] + B_.sum(-1, keepdim=True)[:, :1] + C.sum(-1, keepdim=True)[:, :1])
    y = x * (D + A.sum(-1)) + first.to(x.dtype)
    h = (x[:, -1, :, None].float() * A) * dt[:, -1, :, None].float()
    return y.to(x.dtype), h


def sharded_scan(x, dt, B_, C, A, D, *, impl: str = "auto", specs):
    """``selective_scan`` on each rank's shards (``on_shards``): batch on
    the plan's batch axes and the Di channels, which the scan keeps apart,
    on ``model`` when it divides them; S and N whole. ``specs`` is
    ``model._kernel_specs``'s. On fake tensors (the dry run) the shards
    take ``_scan_outline``."""
    sx, m = specs((x.shape[-1],))
    sbc = spec(sx[0], None, None)

    def fn(x, dt, B_, C, A, D):
        if is_fake(x):
            return _scan_outline(x, dt, B_, C, A, D)
        return selective_scan(x, dt, B_, C, A, D, impl=impl)

    return on_shards(counted_kernel("ssm_scan", fn, scan_flops), (x, dt, B_, C, A, D),
                     (sx, sx, sbc, sbc, spec(m, None), spec(m)),
                     (sx, spec(sx[0], m, None)))


def mamba_block(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    *,
    dt_rank: int,
    ssm_state: int,
    impl: str = "auto",
    return_state: bool = False,
    scan=None,
):
    """Full mamba-1 mixer. x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode state after the last
    position, as ``(y, (conv, ssm))``: ``conv`` (B, K-1, Di) is the last K-1
    positions of the conv input (zeros before the first), ``ssm`` (B, Di, N)
    the scan's last state; both in the layout of a decode cache layer.
    ``scan`` replaces ``selective_scan`` (a plan's ``sharded_scan``)."""
    xz = x @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)  # (B,S,Di) each
    conv_in = xi
    xi = _silu(causal_conv1d(xi, p["conv_w"], p["conv_b"]))
    dt, B_, C = _ssm_params(xi, p, dt_rank, ssm_state)
    A = -torch.exp(p["A_log"].float())
    y, h_last = (scan or selective_scan)(xi, dt, B_, C, A, p["D"].float(), impl=impl)
    y = y * _silu(z)  # gate
    out = y @ p["out_proj"]
    if not return_state:
        return out
    K = p["conv_w"].shape[1]
    conv = F.pad(conv_in, (0, 0, K - 1, 0))[:, conv_in.shape[1]:]
    return out, (conv, h_last)


# --------------------------------------------------------------------------- #
# Decode (single-step recurrence)
# --------------------------------------------------------------------------- #
def mamba_decode_step(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    conv_state: torch.Tensor,
    ssm_state_v: torch.Tensor,
    *,
    dt_rank: int,
    ssm_state: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, 1, D); conv_state: (B, K-1, Di); ssm_state_v: (B, Di, N).

    Returns (y (B,1,D), new_conv_state, new_ssm_state)."""
    xz = x @ p["in_proj"]
    xi, z = xz.chunk(2, dim=-1)                                 # (B,1,Di)
    window = torch.cat([conv_state.to(xi.dtype), xi], dim=1)   # (B,K,Di)
    conv = torch.einsum("bkd,dk->bd", window, p["conv_w"]) + p["conv_b"]
    conv = _silu(conv[:, None, :])                              # (B,1,Di)
    dt, B_, C = _ssm_params(conv, p, dt_rank, ssm_state)
    A = -torch.exp(p["A_log"].float())
    cf = conv.float()[:, 0]
    Abar = torch.exp(dt[:, 0, :, None] * A[None])              # (B,Di,N)
    Bx = dt[:, 0, :, None] * B_[:, 0, None, :] * cf[:, :, None]
    h = Abar * ssm_state_v + Bx                                 # (B,Di,N)
    y = torch.einsum("bdn,bn->bd", h, C[:, 0]) + cf * p["D"].float()[None]
    y = y.to(x.dtype)[:, None, :]
    y = y * _silu(z)
    out = y @ p["out_proj"]
    return out, window[:, 1:], h
