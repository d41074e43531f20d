"""Public wrapper: layout adaptation and dispatch to the CUDA kernels.

Model code uses (B, S, H, hd); the kernels want (B, H, S, hd), each
(batch, head) a contiguous (S, hd) slab. A tensor on the CPU takes the plain
version (``ref.attention_ref``), which autograd differentiates; a CUDA
tensor goes through ``FlashAttentionFn``, whose forward launches one of the
two kernels of ``csrc/flash_attention.cu`` and whose backward launches one
of the two routes of ``csrc/flash_attention_bwd.cu``, or the call raises.
bf16 at head_dim 64 or 128 goes to the tensor-core kernels (``fa_fwd_sm90``;
the backward's ``fa_bwd_dkdv_sm90`` and ``fa_bwd_dq_sm90``, for groups of at
most 8 query heads per KV head), float32 and bf16 at head_dim 16 or 32 to
the CUDA-core ones (``fa_fwd_kernel``; ``fa_bwd_dkdv`` and ``fa_bwd_dq``).
The forward stores each row's log-sum-exp, which the backward reads.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
SM90_HEAD_DIMS = (64, 128)     # head dims of the tensor-core kernel (bf16)
SM90_BWD_MAX_GROUP = 8         # query heads per KV head: one thread-block cluster
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_flash_attention_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_flash_attention_bwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def uses_sm90(dtype: torch.dtype, hd: int) -> bool:
    """Whether (dtype, head_dim) goes to the tensor-core kernel."""
    return dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS


def uses_sm90_bwd(dtype: torch.dtype, hd: int, group: int) -> bool:
    """Whether the backward of (dtype, head_dim, query heads per KV head)
    goes to the tensor-core kernels: the forward's rule, and a group that
    fits one thread-block cluster."""
    return uses_sm90(dtype, hd) and group <= SM90_BWD_MAX_GROUP


def flash_attention(
    q: torch.Tensor,       # (B, H, Sq, hd)
    k: torch.Tensor,       # (B, KV, Sk, hd)
    v: torch.Tensor,       # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
    return_lse: bool = False,
):
    """Launch the CUDA kernel on (B, H, S, hd) tensors of the card. With
    ``return_lse``, returns (out, lse): lse (B, H, Sq) float32 is each row's
    log-sum-exp of its masked scaled scores (natural log), stored by the
    kernel's epilogue (``ref.attention_lse_ref`` is its plain version)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention launches on CUDA tensors only")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS or k.shape != (B, KV, Sk, hd) or v.shape != k.shape \
            or H % KV != 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse \
        else None
    lse_ptr = lse.data_ptr() if return_lse else None
    lib = _lib()
    sm90 = uses_sm90(q.dtype, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if sm90:
            rc = lib.repro_flash_attention_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                B, H, KV, Sq, Sk, hd, int(causal), int(window),
                1.0 / math.sqrt(hd), stream)
        else:
            rc = lib.repro_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                B, H, KV, Sq, Sk, hd, int(causal), int(window),
                1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention launch")
    flash_attention.launches += 1
    if sm90:
        flash_attention.launches_sm90 += 1
    else:
        flash_attention.launches_simt += 1
    return (out, lse) if return_lse else out


# Kernel launches, in all and per kernel; callers reset them to 0.
flash_attention.launches = 0
flash_attention.launches_sm90 = 0    # fa_fwd_sm90 (tensor cores)
flash_attention.launches_simt = 0    # fa_fwd_kernel (CUDA cores)


def flash_attention_bwd(
    q: torch.Tensor,       # (B, H, S, hd)
    k: torch.Tensor,       # (B, KV, S, hd)
    v: torch.Tensor,       # (B, KV, S, hd)
    o: torch.Tensor,       # (B, H, S, hd), the forward's output
    do: torch.Tensor,      # (B, H, S, hd), gradient of the output
    lse: torch.Tensor,     # (B, H, S) float32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: int = 0,
):
    """Launch the backward kernels on (B, H, S, hd) tensors of the card.
    Returns (dq, dk, dv) in the inputs' type; D = rowsum(dO * O) lives in
    float32 scratch for the length of the call. ``lse`` is what
    ``flash_attention(..., return_lse=True)`` returned for the same q, k, v.
    Queries and keys must be of one length (the training shape), as the
    plain ``attention_bwd_ref``."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    ts = (q, k, v, o, do)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_bwd launches on CUDA tensors only")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention_bwd takes one of float32 or bf16, got "
                        f"{[t.dtype for t in ts]}")
    if hd not in HEAD_DIMS or k.shape != (B, KV, S, hd) or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape or H % KV != 0:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} do {tuple(do.shape)}")
    if not (isinstance(lse, torch.Tensor) and lse.shape == (B, H, S)
            and lse.dtype == torch.float32 and lse.device == q.device):
        raise ValueError(f"flash_attention_bwd needs the forward's lse: float32 "
                         f"{(B, H, S)} on {q.device}")
    sm90 = uses_sm90_bwd(q.dtype, hd, H // KV)
    dq, dk, dv = _launch_bwd(q, k, v, o, do, lse, causal=causal, window=window, sm90=sm90)
    flash_attention_bwd.launches += 1
    if sm90:
        flash_attention_bwd.launches_sm90 += 1
    else:
        flash_attention_bwd.launches_simt += 1
    return dq, dk, dv


def _launch_bwd(q, k, v, o, do, lse, *, causal: bool, window: int, sm90: bool):
    """One backward call on the named route, on checked tensors; counts
    nothing (``chip_smoke.py`` also times the CUDA-core route on bf16). The
    tensor-core route runs its dQ kernel on a stream of its own beside the
    dK/dV kernel, joined back to the current stream before it returns."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(lse)
    lib = _bwd_lib()
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, dsum, dq, dk, dv)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if sm90:
            rc = lib.repro_flash_attention_bwd_sm90(
                *ptrs, B, H, KV, S, hd, int(causal), int(window), 1.0 / math.sqrt(hd),
                stream)
        else:
            rc = lib.repro_flash_attention_bwd(
                *ptrs, B, H, KV, S, hd, int(causal), int(window), math.sqrt(hd),
                _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention_bwd launch")
    return dq, dk, dv


# Backward calls (three kernels each), in all and per route; callers reset them.
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_sm90 = 0    # fa_bwd_dkdv_sm90 + fa_bwd_dq_sm90 (tensor cores)
flash_attention_bwd.launches_simt = 0    # fa_bwd_dkdv + fa_bwd_dq (CUDA cores)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on (B, H, S, hd) CUDA tensors with a kernel for each
    direction: the forward kernels of ``flash_attention`` and the backward
    kernels of ``flash_attention_bwd``. Saves q, k, v, the output and the
    forward's per-row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def attention(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,       # (B, S, KV, hd)
    v: torch.Tensor,       # (B, S, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = attention_ref(qt, kt, vt, causal=causal, window=window)
    else:
        out = FlashAttentionFn.apply(qt, kt, vt, causal, window)
    return out.transpose(1, 2)
