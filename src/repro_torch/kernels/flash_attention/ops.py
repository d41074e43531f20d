"""Public wrapper: layout adaptation and dispatch to the CUDA kernels.

Model code uses (B, S, H, hd); the kernels want (B, H, S, hd), each
(batch, head) a contiguous (S, hd) slab. A tensor on the CPU takes the plain
version (``ref.attention_ref``), which autograd differentiates; a CUDA
tensor goes through ``FlashAttentionFn``, whose forward launches one of the
two kernels of ``csrc/flash_attention.cu`` and whose backward launches the
kernel of ``csrc/flash_attention_bwd.cu``, or the call raises. bf16 at
head_dim 64 or 128 goes to the tensor-core forward (``fa_fwd_sm90``),
float32 and bf16 at head_dim 16 or 32 to the CUDA-core one
(``fa_fwd_kernel``); the backward runs on the CUDA cores for all of them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
SM90_HEAD_DIMS = (64, 128)     # head dims of the tensor-core kernel (bf16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_flash_attention_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def uses_sm90(dtype: torch.dtype, hd: int) -> bool:
    """Whether (dtype, head_dim) goes to the tensor-core kernel."""
    return dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS


def flash_attention(
    q: torch.Tensor,       # (B, H, Sq, hd)
    k: torch.Tensor,       # (B, KV, Sk, hd)
    v: torch.Tensor,       # (B, KV, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel on (B, H, S, hd) tensors of the card."""
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
    lib = _lib()
    sm90 = uses_sm90(q.dtype, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if sm90:
            rc = lib.repro_flash_attention_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, KV, Sq, Sk, hd, int(causal), int(window),
                1.0 / math.sqrt(hd), stream)
        else:
            rc = lib.repro_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, KV, Sq, Sk, hd, int(causal), int(window),
                1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention launch")
    flash_attention.launches += 1
    if sm90:
        flash_attention.launches_sm90 += 1
    else:
        flash_attention.launches_simt += 1
    return out


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
    *,
    causal: bool = True,
    window: int = 0,
):
    """Launch the backward kernel on (B, H, S, hd) tensors of the card.
    Returns (dq, dk, dv) in the inputs' type; the per-row lse and D live in
    float32 scratch for the length of the call. Queries and keys must be of
    one length (the training shape), as the plain ``attention_bwd_ref``."""
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
    q, k, v, o, do = (t.contiguous() for t in ts)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, KV, S, hd, int(causal), int(window), math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # kernel launches (three stages each); callers reset it


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on (B, H, S, hd) CUDA tensors with a kernel for each
    direction: the forward kernels of ``flash_attention`` and the backward
    kernel of ``flash_attention_bwd``. Saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, causal=ctx.causal,
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
