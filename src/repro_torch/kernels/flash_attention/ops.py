"""Public wrapper: layout adaptation and dispatch to the CUDA kernel.

Model code uses (B, S, H, hd); the kernels want (B, H, S, hd), each
(batch, head) a contiguous (S, hd) slab. A tensor on the CPU takes the plain
version (``ref.attention_ref``); a CUDA tensor launches one of the two
kernels of ``csrc/flash_attention.cu`` or the call raises: bf16 at head_dim
64 or 128 goes to the tensor-core kernel (``fa_fwd_sm90``), float32 and bf16
at head_dim 16 or 32 to the CUDA-core one (``fa_fwd_kernel``).
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
        out = flash_attention(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)
