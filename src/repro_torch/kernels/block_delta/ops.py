"""Public wrapper for the block-delta kernel, plus block layout helpers.

A tensor on the CPU takes the plain version (``ref.block_delta_ref``); a CUDA
tensor launches the kernel of ``csrc/block_delta.cu`` or the call raises.
``pack_dirty`` and ``blockify`` are the torch forms of the reference's numpy
helpers and run on the tensors' own device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_delta.ref import block_delta_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_delta")
    fn = lib.repro_block_delta_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def block_delta(new: torch.Tensor, old: torch.Tensor):
    """Launch the CUDA kernel on (nblocks, block_elems) tensors of the card.
    Returns (q int8 (nb, be), norm2 f32 (nb,), scale f32 (nb,))."""
    if not (new.is_cuda and old.is_cuda):
        raise ValueError("block_delta launches on CUDA tensors only")
    if new.dim() != 2 or new.shape != old.shape:
        raise ValueError(f"block_delta takes two equal (nblocks, block_elems) "
                         f"tensors, got {tuple(new.shape)} and {tuple(old.shape)}")
    if new.dtype not in _DTYPES or old.dtype != new.dtype:
        raise TypeError(f"block_delta takes float32 or bf16, got {new.dtype}/{old.dtype}")
    nb, be = new.shape
    new, old = new.contiguous(), old.contiguous()
    q = torch.empty((nb, be), dtype=torch.int8, device=new.device)
    norm2 = torch.empty((nb,), dtype=torch.float32, device=new.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=new.device)
    if nb == 0 or be == 0:
        return q, norm2.zero_(), scale.fill_(1.0)
    lib = _lib()
    with torch.cuda.device(new.device):
        rc = lib.repro_block_delta_fwd(
            new.data_ptr(), old.data_ptr(), q.data_ptr(), norm2.data_ptr(),
            scale.data_ptr(), nb, be, _DTYPES[new.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "block_delta launch")
    block_delta.launches += 1
    return q, norm2, scale


block_delta.launches = 0  # kernel launches; callers reset it to 0


def compute_block_delta(new: torch.Tensor, old: torch.Tensor):
    """new/old: (nblocks, block_elems) -> (q int8, norm2 f32, scale f32)."""
    if new.device.type == "cpu":
        return block_delta_ref(new, old)
    return block_delta(new, old)


def pack_dirty(
    q: torch.Tensor, norm2: torch.Tensor, scale: torch.Tensor, threshold: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select blocks whose delta norm^2 clears ``threshold``.

    Returns (dirty_indices, q_dirty, scales_dirty) — what a commit ships.
    """
    idx = torch.nonzero(norm2 > threshold).flatten()
    return idx, q[idx], scale[idx]


def blockify(flat: torch.Tensor, block_elems: int) -> torch.Tensor:
    """Pad a flat tensor to a whole number of blocks and reshape. A length
    that is already a multiple of ``block_elems`` gives a view, no copy."""
    n = flat.numel()
    nb = -(-n // block_elems)
    if nb * block_elems == n:
        return flat.reshape(nb, block_elems)
    out = torch.zeros((nb * block_elems,), dtype=flat.dtype, device=flat.device)
    out[:n] = flat
    return out.reshape(nb, block_elems)
