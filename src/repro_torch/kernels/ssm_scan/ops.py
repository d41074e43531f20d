"""Public wrappers for the selective-scan kernels.

``selective_scan`` is the model's form (takes A = -exp(A_log), returns y and
the last state); ``ssm_scan`` has the Pallas kernel's signature (takes
``a_log``, returns y). A call that autograd would differentiate goes
through ``SelectiveScanFn``: the forward saves the state entering each
chunk, and the backward steps the adjoint back from them. On CUDA tensors
the two directions launch the kernels of ``csrc/ssm_scan.cu``
(``selective_scan_fwd``) and ``csrc/ssm_scan_bwd.cu``
(``selective_scan_bwd``), or the call raises; on CPU tensors they are the
plain versions of ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import (CHUNK, selective_scan_bwd_ref,
                                              selective_scan_ref)

STATE_SIZES = (1, 2, 4, 8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    fn = lib.repro_ssm_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan_bwd")
    fn = lib.repro_ssm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_ssm_scan_bwd_work_floats.argtypes = [ctypes.c_int] * 4
    lib.repro_ssm_scan_bwd_work_floats.restype = ctypes.c_longlong
    lib.repro_ssm_scan_bwd_geometry.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.repro_ssm_scan_bwd_geometry.restype = ctypes.c_int
    return lib


def _check_args(what: str, x, dt, b, c, a, d, h0, *more) -> None:
    """Device, type and shapes the kernels take; ``more`` are further
    (B, S, Di) or (B, Di, N) tensors by name."""
    Bsz, S, Di = x.shape
    N = a.shape[-1]
    tensors = [t for t in (x, dt, b, c, a, d, h0, *(t for _, t in more)) if t is not None]
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} launches on CUDA tensors only")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bf16 x, got {x.dtype}")
    want = {"bsd": (Bsz, S, Di), "bdn": (Bsz, Di, N),
            "chunks": (Bsz, -(-S // CHUNK), Di, N)}
    if N not in STATE_SIZES or dt.shape != x.shape or b.shape != (Bsz, S, N) \
            or c.shape != b.shape or a.shape != (Di, N) or d.shape != (Di,) \
            or (h0 is not None and h0.shape != (Bsz, Di, N)) or Bsz > 65535 \
            or any(t is not None and t.shape != want[kind] for kind, t in more):
        raise ValueError(f"{what}: unsupported shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"b {tuple(b.shape)} c {tuple(c.shape)} a {tuple(a.shape)} "
                         f"d {tuple(d.shape)}; " + ", ".join(
                             f"{kind} {None if t is None else tuple(t.shape)}"
                             for kind, t in more))


def selective_scan_fwd(
    x: torch.Tensor,       # (B, S, Di) float32 or bf16
    dt: torch.Tensor,      # (B, S, Di)
    b: torch.Tensor,       # (B, S, N)
    c: torch.Tensor,       # (B, S, N)
    a: torch.Tensor,       # (Di, N), negative
    d: torch.Tensor,       # (Di,)
    *,
    h0: Optional[torch.Tensor] = None,   # (B, Di, N)
    chunk_states: bool = False,
):
    """Launch the CUDA kernel on tensors of the card. dt, b, c, a, d and h0
    are cast to float32 (exact for bf16 inputs). Returns (y in x's type,
    h_last (B, Di, N) float32), and with ``chunk_states`` also the state
    entering each chunk of ``CHUNK`` steps, (B, ceil(S / CHUNK), Di, N)
    float32, which ``selective_scan_bwd`` takes."""
    Bsz, S, Di = x.shape
    N = a.shape[-1]
    _check_args("selective_scan_fwd", x, dt, b, c, a, d, h0)
    x = x.contiguous()
    dt, b, c, a, d = (t.float().contiguous() for t in (dt, b, c, a, d))
    h0 = None if h0 is None else h0.float().contiguous()
    y = torch.empty_like(x)
    h_last = torch.empty((Bsz, Di, N), dtype=torch.float32, device=x.device)
    hc = torch.empty((Bsz, -(-S // CHUNK), Di, N), dtype=torch.float32, device=x.device) \
        if chunk_states else None
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
            d.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), None if hc is None else hc.data_ptr(), Bsz, S, Di, N,
            _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ssm_scan launch")
    selective_scan_fwd.launches += 1
    return (y, h_last) if hc is None else (y, h_last, hc)


selective_scan_fwd.launches = 0  # kernel launches; callers reset it to 0


def selective_scan_bwd(
    x: torch.Tensor,       # (B, S, Di) float32 or bf16
    dt: torch.Tensor,      # (B, S, Di)
    b: torch.Tensor,       # (B, S, N)
    c: torch.Tensor,       # (B, S, N)
    a: torch.Tensor,       # (Di, N), negative
    d: torch.Tensor,       # (Di,)
    dy: torch.Tensor,      # (B, S, Di), the gradient of y
    *,
    chunk_states: torch.Tensor,                 # from selective_scan_fwd
    dh_last: Optional[torch.Tensor] = None,     # (B, Di, N), the gradient of h_last
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernels on tensors of the card: returns (dx in
    x's type, ddt, db, dc, da, dd, dh0) float32, as
    ``ref.selective_scan_bwd_ref``. dy is cast to x's type; dt, b, c, a, d
    and dh_last to float32."""
    Bsz, S, Di = x.shape
    N = a.shape[-1]
    _check_args("selective_scan_bwd", x, dt, b, c, a, d, None, ("bsd", dy),
                ("chunks", chunk_states), ("bdn", dh_last))
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    dt, b, c, a, d, hc = (t.float().contiguous() for t in (dt, b, c, a, d, chunk_states))
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da, dd = torch.empty_like(a), torch.empty_like(d)
    dh0 = torch.empty((Bsz, Di, N), dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    work = torch.empty(lib.repro_ssm_scan_bwd_work_floats(Bsz, S, Di, N), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_ssm_scan_bwd(
            *(t.data_ptr() for t in (x, dt, b, c, a, d, dy, hc)),
            None if dh_last is None else dh_last.data_ptr(),
            *(t.data_ptr() for t in (dx, ddt, db, dc, da, dd, dh0, work)),
            Bsz, S, Di, N, _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ssm_scan_bwd launch")
    selective_scan_bwd.launches += 1
    return dx, ddt, db, dc, da, dd, dh0


selective_scan_bwd.launches = 0  # backward calls (two kernels each); callers reset it to 0

_GEOMETRY = ("blocks", "threads", "cluster", "blocks_per_sm", "clusters_resident", "sms",
             "registers", "local_bytes", "smem_bytes")


def selective_scan_bwd_geometry(B: int, S: int, Di: int, N: int,
                                dtype: torch.dtype = torch.bfloat16) -> dict:
    """How ``selective_scan_bwd`` launches its scan kernel on the current
    card for these sizes (16-byte aligned tensors): {blocks, threads (a
    block), cluster (blocks a cluster), blocks_per_sm (resident, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor), clusters_resident
    (cudaOccupancyMaxActiveClusters), sms, registers and local_bytes (a
    thread), smem_bytes (a block), warps_per_sm, waves}."""
    out = (ctypes.c_int * len(_GEOMETRY))()
    rc = _bwd_lib().repro_ssm_scan_bwd_geometry(B, S, Di, N, _DTYPES[dtype], out)
    _build.check(rc, "ssm_scan_bwd geometry")
    geo = dict(zip(_GEOMETRY, out))
    geo["warps_per_sm"] = geo["blocks_per_sm"] * geo["threads"] // 32
    geo["waves"] = geo["blocks"] / geo["cluster"] / max(geo["clusters_resident"], 1)
    return geo


class SelectiveScanFn(torch.autograd.Function):
    """(y, h_last) of the selective scan with a backward of its own: on CUDA
    tensors the forward kernel, which also saves the state entering each
    chunk, and the backward kernel; on CPU tensors their plain versions,
    with the same saved states. A gradient on h_last, where one arrives,
    seeds the adjoint; inputs that need no gradient get None."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, h0):
        if x.device.type == "cpu":
            y, h_last, hc = selective_scan_ref(x, dt, b, c, a, d, h0=h0,
                                               return_chunk_states=True)
        else:
            y, h_last, hc = selective_scan_fwd(x, dt, b, c, a, d, h0=h0, chunk_states=True)
        ctx.save_for_backward(x, dt, b, c, a, d, hc)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, b, c, a, d, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        bwd = selective_scan_bwd_ref if x.device.type == "cpu" else selective_scan_bwd
        grads = bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh_last)
        inputs = (x, dt, b, c, a, d)
        out = [g.to(t.dtype) if need else None
               for g, t, need in zip(grads, inputs, ctx.needs_input_grad)]
        out.append(grads[6] if ctx.needs_input_grad[6] else None)
        return tuple(out)


def selective_scan(x, dt, b, c, a, d, *, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_last). A call that autograd would differentiate runs
    ``SelectiveScanFn`` (kernels on the card, plain versions on the CPU);
    otherwise the plain version for CPU tensors and the forward kernel for
    CUDA tensors."""
    args = (x, dt, b, c, a, d) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SelectiveScanFn.apply(x, dt, b, c, a, d, h0)
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, b, c, a, d, h0=h0)
    return selective_scan_fwd(x, dt, b, c, a, d, h0=h0)


def ssm_scan(x, dt, b, c, a_log, d) -> torch.Tensor:
    """The Pallas kernel's signature (``repro.kernels.ssm_scan.kernel``):
    A = -exp(a_log) in float32, returns y only."""
    return selective_scan(x, dt, b, c, -torch.exp(a_log.float()), d)[0]
