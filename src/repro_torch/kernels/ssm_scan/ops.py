"""Public wrappers for the selective-scan kernel.

``selective_scan`` is the model's form (takes A = -exp(A_log), returns y and
the last state); ``ssm_scan`` has the Pallas kernel's signature (takes
``a_log``, returns y). A tensor on the CPU takes the plain version
(``ref.selective_scan_ref``); a CUDA tensor launches the kernel of
``csrc/ssm_scan.cu`` through ``selective_scan_fwd`` or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

STATE_SIZES = (1, 2, 4, 8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    fn = lib.repro_ssm_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def selective_scan_fwd(
    x: torch.Tensor,       # (B, S, Di) float32 or bf16
    dt: torch.Tensor,      # (B, S, Di)
    b: torch.Tensor,       # (B, S, N)
    c: torch.Tensor,       # (B, S, N)
    a: torch.Tensor,       # (Di, N), negative
    d: torch.Tensor,       # (Di,)
    *,
    h0: Optional[torch.Tensor] = None,   # (B, Di, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on tensors of the card. dt, b, c, a, d and h0
    are cast to float32 (exact for bf16 inputs). Returns (y in x's type,
    h_last (B, Di, N) float32)."""
    Bsz, S, Di = x.shape
    N = a.shape[-1]
    args = (x, dt, b, c, a, d) + (() if h0 is None else (h0,))
    if not all(t.is_cuda for t in args):
        raise ValueError("selective_scan_fwd launches on CUDA tensors only")
    if x.dtype not in _DTYPES:
        raise TypeError(f"selective_scan_fwd takes float32 or bf16 x, got {x.dtype}")
    if N not in STATE_SIZES or dt.shape != x.shape or b.shape != (Bsz, S, N) \
            or c.shape != b.shape or a.shape != (Di, N) or d.shape != (Di,) \
            or (h0 is not None and h0.shape != (Bsz, Di, N)) or Bsz > 65535:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"b {tuple(b.shape)} c {tuple(c.shape)} a {tuple(a.shape)} "
                         f"d {tuple(d.shape)}")
    x = x.contiguous()
    dt, b, c, a, d = (t.float().contiguous() for t in (dt, b, c, a, d))
    h0 = None if h0 is None else h0.float().contiguous()
    y = torch.empty_like(x)
    h_last = torch.empty((Bsz, Di, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
            d.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), Bsz, S, Di, N, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ssm_scan launch")
    selective_scan_fwd.launches += 1
    return y, h_last


selective_scan_fwd.launches = 0  # kernel launches; callers reset it to 0


def selective_scan(x, dt, b, c, a, d, *, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_last): the plain version for CPU tensors, the kernel otherwise.
    The kernel has no backward yet, so a CUDA call that autograd would
    differentiate raises instead of returning outputs without a gradient."""
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, b, c, a, d, h0=h0)
    args = (x, dt, b, c, a, d) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "the selective-scan kernel has no backward yet: training the ssm and "
            "hybrid families on the card waits for it (ROADMAP, Queue 1)")
    return selective_scan_fwd(x, dt, b, c, a, d, h0=h0)


def ssm_scan(x, dt, b, c, a_log, d) -> torch.Tensor:
    """The Pallas kernel's signature (``repro.kernels.ssm_scan.kernel``):
    A = -exp(a_log) in float32, returns y only."""
    return selective_scan(x, dt, b, c, -torch.exp(a_log.float()), d)[0]
