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


class _AllReduce(torch.autograd.Function):
    """The sum over ``group`` of each rank's part, in both directions: each
    rank's part feeds a value every rank uses differently."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol

        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


def _ssm_params(x: torch.Tensor, p: Dict[str, torch.Tensor], dt_rank: int, n: int,
                group=None):
    """x: (B, S, Di) -> dt (B,S,Di) fp32, B_ (B,S,N) fp32, C (B,S,N) fp32.
    With ``group``, x and the weights hold this rank's channels, and the
    x_proj product's parts are summed over the group."""
    proj = x @ p["x_proj"]
    if group is not None:
        proj = _AllReduce.apply(proj, group)
    proj = proj.float()
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


def _channels(xi, z, p, dt_rank: int, n: int, scan, group=None):
    """The mixer between its two projections, on (B, S, Di) halves xi and z
    of the input projection: causal conv, SiLU, the selective scan by
    ``scan``, the gate. Returns (y (B, S, Di), conv state (B, K-1, Di),
    last scan state (B, Di, N))."""
    conv_in = xi
    xi = _silu(causal_conv1d(xi, p["conv_w"], p["conv_b"]))
    dt, B_, C = _ssm_params(xi, p, dt_rank, n, group)
    A = -torch.exp(p["A_log"].float())
    y, h_last = scan(xi, dt, B_, C, A, p["D"].float())
    y = y * _silu(z)  # gate
    K = p["conv_w"].shape[1]
    conv = F.pad(conv_in, (0, 0, K - 1, 0))[:, conv_in.shape[1]:]
    return y, conv, h_last


_CHANNEL_PARAMS = ("conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D")


def _channel_specs(m):
    """The specs of ``_CHANNEL_PARAMS`` with their Di channels on ``m``."""
    ch = {"conv_w": spec(m, None), "conv_b": spec(m), "x_proj": spec(m, None),
          "dt_proj": spec(None, m), "dt_bias": spec(m), "A_log": spec(m, None), "D": spec(m)}
    return tuple(ch[k] for k in _CHANNEL_PARAMS)


def _own_channels(w, n: int, r: int, group):
    """Rank r's columns ``[xi_r | z_r]`` (Di / n of each half) of the input
    projection, from the ones it holds as ``in_proj`` split over ``model``,
    ``(xi | z)[:, 2c r : 2c (r + 1)]`` with c = Di / n. Column block b (c
    wide) of ``(xi | z)`` is rank b // 2's and rank b mod n needs it, so
    every rank sends two blocks and receives two (``all_to_all_single``,
    whose backward sends the gradient back the same way)."""
    import torch.distributed._functional_collectives as funcol

    c, D = w.shape[1] // 2, w.shape[0]
    held = sorted((b % n, b - 2 * r) for b in (2 * r, 2 * r + 1))   # by receiver
    send = torch.cat([w[:, j * c:(j + 1) * c] for _, j in held], dim=1).t().contiguous()
    out_split, in_split = [0] * n, [0] * n
    for dst, _ in held:
        in_split[dst] += c
    out_split[r // 2] += c                  # xi_r, from the lower rank
    out_split[(n + r) // 2] += c            # z_r
    got = funcol.all_to_all_single_autograd(send, out_split, in_split, group)
    return funcol.wait_tensor(got).reshape(2 * c, D).t()


def sharded_mixer(x, p, *, dt_rank: int, ssm_state: int, impl: str = "auto", specs):
    """``mamba_block``'s work between its two projections, and the input
    projection, on each rank's shards (``on_shards``): x (B, S, D) with the
    sequence whole and ``in_proj`` on its split over ``model``; each rank
    takes its share of the Di channels of both halves of the projection
    (``_own_channels``) and runs the product, the conv, the scan and the
    gate on them, the x_proj product's parts summed over ``model``. With
    Di not divisible by ``model`` every rank computes all channels,
    ``in_proj`` whole. Returns
    ``_channels``'s three values. ``specs`` is ``model._kernel_specs``'s.
    On fake tensors (the dry run) the scan is ``_scan_outline``."""
    di = p["in_proj"].shape[-1] // 2
    sx, m = specs((di,))
    mesh = x.device_mesh
    n = mesh.size(mesh.mesh_dim_names.index("model")) if m else 1
    group = mesh.get_group("model") if n > 1 else None

    def scan_fn(x, dt, B_, C, A, D):
        if is_fake(x):
            return _scan_outline(x, dt, B_, C, A, D)
        return selective_scan(x, dt, B_, C, A, D, impl=impl)

    scan = counted_kernel("ssm_scan", scan_fn, scan_flops)

    def fn(x, w, *channel_params):
        if n > 1:
            w = _own_channels(w, n, mesh.get_local_rank("model"), group)
        xi, z = (x @ w).chunk(2, dim=-1)
        return _channels(xi, z, dict(zip(_CHANNEL_PARAMS, channel_params)), dt_rank,
                         ssm_state, scan, group)

    return on_shards(fn, (x, p["in_proj"]) + tuple(p[k] for k in _CHANNEL_PARAMS),
                     (spec(sx[0], None, None), spec(None, m)) + _channel_specs(m),
                     (sx, sx, spec(sx[0], m, None)))


def mamba_block(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    *,
    dt_rank: int,
    ssm_state: int,
    impl: str = "auto",
    return_state: bool = False,
    mixer=None,
):
    """Full mamba-1 mixer. x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode state after the last
    position, as ``(y, (conv, ssm))``: ``conv`` (B, K-1, Di) is the last K-1
    positions of the conv input (zeros before the first), ``ssm`` (B, Di, N)
    the scan's last state; both in the layout of a decode cache layer.
    ``mixer`` replaces the input projection and the work after it up to the
    output projection (a plan's ``sharded_mixer``)."""
    if mixer is not None:
        y, conv, h_last = mixer(x, p)
    else:
        xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # (B,S,Di) each
        y, conv, h_last = _channels(
            xi, z, p, dt_rank, ssm_state,
            lambda *a: selective_scan(*a, impl=impl))
    out = y @ p["out_proj"]
    if not return_state:
        return out
    return out, (conv, h_last)


# --------------------------------------------------------------------------- #
# Decode (single-step recurrence)
# --------------------------------------------------------------------------- #
def _decode_channels(xi, z, conv_state, ssm_state_v, p, dt_rank: int, n: int, group=None):
    """One decode step between the two projections, on (B, 1, Di) halves
    xi and z of the input projection: the conv over the state's last K-1
    inputs and xi, SiLU, one step of the recurrence, the gate. With
    ``group`` every tensor holds this rank's channels (``_ssm_params``).
    Returns (y (B, 1, Di), new conv state, new scan state)."""
    window = torch.cat([conv_state.to(xi.dtype), xi], dim=1)   # (B,K,Di)
    conv = torch.einsum("bkd,dk->bd", window, p["conv_w"]) + p["conv_b"]
    conv = _silu(conv[:, None, :])                              # (B,1,Di)
    dt, B_, C = _ssm_params(conv, p, dt_rank, n, group)
    A = -torch.exp(p["A_log"].float())
    cf = conv.float()[:, 0]
    Abar = torch.exp(dt[:, 0, :, None] * A[None])              # (B,Di,N)
    Bx = dt[:, 0, :, None] * B_[:, 0, None, :] * cf[:, :, None]
    h = Abar * ssm_state_v + Bx                                 # (B,Di,N)
    y = torch.einsum("bdn,bn->bd", h, C[:, 0]) + cf * p["D"].float()[None]
    y = y.to(xi.dtype)[:, None, :]
    return y * _silu(z), window[:, 1:], h


def sharded_decode_mixer(x, p, conv_state, ssm_state_v, *, dt_rank: int, ssm_state: int,
                         specs):
    """``sharded_mixer`` for one decode step: the input projection and
    ``_decode_channels`` on each rank's share of the Di channels, the conv
    and scan states (``conv_state`` (B, K-1, Di), ``ssm_state_v``
    (B, Di, N), the plan's cache layout) on their split over ``model``.
    Returns ``_decode_channels``'s three values. torch 2.11's DTensor
    cannot run the step's ops on the split channels itself (the bias of
    the dt projection, split, meets the product's partial sums)."""
    di = p["in_proj"].shape[-1] // 2
    sx, m = specs((di,))
    mesh = x.device_mesh
    n = mesh.size(mesh.mesh_dim_names.index("model")) if m else 1
    group = mesh.get_group("model") if n > 1 else None

    def fn(x, w, conv_state, ssm_state_v, *channel_params):
        if n > 1:
            w = _own_channels(w, n, mesh.get_local_rank("model"), group)
        xi, z = (x @ w).chunk(2, dim=-1)
        return _decode_channels(xi, z, conv_state, ssm_state_v,
                                dict(zip(_CHANNEL_PARAMS, channel_params)), dt_rank,
                                ssm_state, group)

    b = sx[0]
    return on_shards(fn, (x, p["in_proj"], conv_state, ssm_state_v)
                     + tuple(p[k] for k in _CHANNEL_PARAMS),
                     (spec(b, None, None), spec(None, m), spec(b, None, m), spec(b, m, None))
                     + _channel_specs(m),
                     (sx, spec(b, None, m), spec(b, m, None)))


def mamba_decode_step(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    conv_state: torch.Tensor,
    ssm_state_v: torch.Tensor,
    *,
    dt_rank: int,
    ssm_state: int,
    mixer=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, 1, D); conv_state: (B, K-1, Di); ssm_state_v: (B, Di, N).

    Returns (y (B,1,D), new_conv_state, new_ssm_state). ``mixer`` replaces
    the input projection and the work after it up to the output projection
    (a plan's ``sharded_decode_mixer``)."""
    if mixer is not None:
        y, conv, h = mixer(x, p, conv_state, ssm_state_v)
    else:
        xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)            # (B,1,Di)
        y, conv, h = _decode_channels(xi, z, conv_state, ssm_state_v, p, dt_rank, ssm_state)
    return y @ p["out_proj"], conv, h
