"""Public wrapper of the grouped expert products (``csrc/grouped_mm.cu``).

``grouped_mm(x, w, offs)`` multiplies rows sorted by expert, expert e's
rows ``offs[e]:offs[e + 1]``, by their own expert's weights: (M, K) rows
and (E, K, N) weights -> (M, N). bf16 tensors on the card go through
``GroupedMMFn``: its forward and input gradient launch ``grouped_mm_vm``
(variable M; the input gradient reads w transposed), its weight gradient
``grouped_mm_vk`` (variable K), and ``offs`` (int32) is read on the device
only. CPU, meta and fake tensors take the plain loop over experts of
``ref.py``, which autograd differentiates; a card tensor of another type
raises (the loop would multiply every row by every expert on the card).
``takes`` says whether ``grouped_mm`` takes a tensor, for a caller that
has another route. ``grouped_mm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels.grouped_mm.ref import grouped_mm_ref


def _lib() -> ctypes.CDLL:
    lib = _build.load("grouped_mm")
    fn = lib.repro_grouped_mm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_grouped_mm_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16 \
                or t.shape[-1] % 8:
            raise ValueError("grouped_mm takes contiguous 16-byte aligned bf16 tensors whose "
                             f"last dim is a multiple of 8, got {t.dtype} {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
              trans_w: bool = False) -> torch.Tensor:
    """The variable-M kernel: x (M, K) @ w[e] (w (E, K, N)), or @ w[e]^T
    (w (E, N, K)) with ``trans_w``, on CUDA bf16 tensors."""
    x, w = x.contiguous(), w.contiguous()
    _check(x, w)
    E = w.shape[0]
    N, K = (w.shape[1], w.shape[2]) if trans_w else (w.shape[2], w.shape[1])
    if x.shape[1] != K or offs.shape != (E + 1,) or offs.dtype != torch.int32:
        raise ValueError(f"grouped_mm: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"offs {tuple(offs.shape)} {offs.dtype}")
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().repro_grouped_mm(x.data_ptr(), w.data_ptr(), offs.data_ptr(),
                                     out.data_ptr(), x.shape[0], K, N, E, int(trans_w),
                                     _stream(x))
    _build.check(rc, "grouped_mm launch")
    grouped_mm.launches += 1
    return out


def launch_wgrad(x: torch.Tensor, dy: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The variable-K kernel: (E, K, N), x_e^T dy_e over each expert's
    rows of x (M, K) and dy (M, N), on CUDA bf16 tensors."""
    x, dy = x.contiguous(), dy.contiguous()
    _check(x, dy)
    E = offs.shape[0] - 1
    M, K, N = x.shape[0], x.shape[1], dy.shape[1]
    if dy.shape[0] != M or offs.dtype != torch.int32:
        raise ValueError(f"grouped_mm wgrad: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    out = torch.empty((E, K, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().repro_grouped_mm_wgrad(x.data_ptr(), dy.data_ptr(), offs.data_ptr(),
                                           out.data_ptr(), M, K, N, E, _stream(x))
    _build.check(rc, "grouped_mm wgrad launch")
    grouped_mm.launches += 1
    return out


class GroupedMMFn(torch.autograd.Function):
    """y = x @ w[e] row by row; dx = dy @ w[e]^T, dw[e] = x_e^T dy_e."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return launch_mm(x, w, offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = launch_mm(dy, w, offs, trans_w=True) if ctx.needs_input_grad[0] else None
        dw = launch_wgrad(x, dy, offs) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _plain_route(t: torch.Tensor) -> bool:
    return not t.is_cuda or is_fake(t)


def takes(t: torch.Tensor) -> bool:
    """Whether ``grouped_mm`` takes ``t`` (rows or weights): a CPU, meta or
    fake tensor, or a bf16 tensor on the card."""
    return _plain_route(t) or t.dtype == torch.bfloat16


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows x (M, K) sorted by expert, weights w (E, K, N), offs (E + 1,)
    int32 with offs[0] = 0 and offs[E] = M -> (M, N), each row times its
    expert's weights."""
    if _plain_route(x) and _plain_route(w):
        return grouped_mm_ref(x, w, offs)
    if not (x.is_cuda and w.is_cuda and takes(x) and takes(w)):
        raise ValueError(f"grouped_mm runs bf16 on the card, got x {x.dtype} on {x.device}, "
                         f"w {w.dtype} on {w.device}")
    return GroupedMMFn.apply(x, w, offs)


# Kernel launches (forward and both gradients); callers reset it to 0.
grouped_mm.launches = 0
