"""Public wrappers for the block-delta kernels, plus block layout helpers.

A tensor on the CPU takes the plain version (``ref.py``); a CUDA tensor
launches a kernel of ``csrc/block_delta.cu`` or the call raises. Two
kernels compute the same function: the cluster kernel, which reads each
element once (a row split over a thread-block cluster), and the two-pass
kernel, which reads each row twice and takes any row length and alignment.
``cluster_shape`` routes: the cluster kernel for every row it takes, the
two-pass kernel for the rest (rows longer than 16 x 1,024 x 16 elements, a
length that is not a whole number of 16-byte loads, inputs not aligned to
16 bytes). ``block_delta.launches`` counts every launch, split into
``launches_cluster`` and ``launches_two_pass``.

``pack_dirty`` and ``blockify`` are the torch forms of the reference's
numpy helpers and run on the tensors' own device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_delta.ref import (  # noqa: F401  (blockify is public here)
    block_delta_flat_ref, block_delta_ref, blockify,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VALUES_PER_THREAD = 16
MAX_CLUSTER = 16                  # above 8 a non-portable cluster size, which Hopper has
# Block sizes in order of preference: on the H100 at the serving rows
# (65,536 float32), 256 threads x 16 blocks per row ran fastest, then 512 x 8,
# then 1,024 x 4 (PERF.md, Findings). Longer rows take the first that fits.
CLUSTER_THREADS = (256, 512, 1024)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("block_delta")
    lib.repro_block_delta_cluster.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_block_delta_two_pass.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.repro_block_delta_cluster.restype = ctypes.c_int
    lib.repro_block_delta_two_pass.restype = ctypes.c_int
    return lib


def cluster_shape(block_elems: int, dtype: torch.dtype) -> Optional[Tuple[int, int]]:
    """(threads per block, blocks per cluster) of the cluster kernel for rows
    of ``block_elems``, or None where it does not take them."""
    if (block_elems * torch.finfo(dtype).bits // 8) % 16:
        return None
    for nt in CLUSTER_THREADS:
        c = -(-block_elems // (nt * VALUES_PER_THREAD))
        if c <= MAX_CLUSTER:
            return nt, c
    return None


def _check(new: torch.Tensor, old: torch.Tensor) -> None:
    if not (new.is_cuda and old.is_cuda):
        raise ValueError("block_delta launches on CUDA tensors only")
    if new.dtype not in _DTYPES or old.dtype != new.dtype:
        raise TypeError(f"block_delta takes float32 or bf16, got {new.dtype}/{old.dtype}")


def _launch(new: torch.Tensor, old: torch.Tensor, n: int, be: int,
            kernel: Optional[str]):
    """Both inputs contiguous, n elements each, rows of ``be``."""
    nb = -(-n // be)
    dev = new.device
    q = torch.empty((nb, be), dtype=torch.int8, device=dev)
    norm2 = torch.empty((nb,), dtype=torch.float32, device=dev)
    scale = torch.empty((nb,), dtype=torch.float32, device=dev)
    dirty = torch.empty((nb,), dtype=torch.bool, device=dev)
    if n == 0:
        return q, norm2, scale, dirty
    shape = cluster_shape(be, new.dtype)
    aligned = new.data_ptr() % 16 == 0 and old.data_ptr() % 16 == 0
    if kernel is None:
        kernel = "cluster" if shape and aligned else "two_pass"
    if kernel == "cluster" and not (shape and aligned):
        raise ValueError(f"the cluster kernel does not take rows of {be} {new.dtype} "
                         f"or inputs not aligned to 16 bytes")
    lib = _lib()
    ptrs = (new.data_ptr(), old.data_ptr(), q.data_ptr(), norm2.data_ptr(),
            scale.data_ptr(), dirty.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "cluster":
            rc = lib.repro_block_delta_cluster(*ptrs, n, be, _DTYPES[new.dtype], shape[0],
                                               stream)
        elif kernel == "two_pass":
            rc = lib.repro_block_delta_two_pass(*ptrs, n, be, _DTYPES[new.dtype], stream)
        else:
            raise ValueError(f"unknown block_delta kernel {kernel!r}")
    _build.check(rc, f"block_delta {kernel} launch")
    block_delta.launches += 1
    if kernel == "cluster":
        block_delta.launches_cluster += 1
    else:
        block_delta.launches_two_pass += 1
    return q, norm2, scale, dirty


def block_delta(new: torch.Tensor, old: torch.Tensor):
    """Launch a kernel on (nblocks, block_elems) tensors of the card.
    Returns (q int8 (nb, be), norm2 f32 (nb,), scale f32 (nb,))."""
    _check(new, old)
    if new.dim() != 2 or new.shape != old.shape:
        raise ValueError(f"block_delta takes two equal (nblocks, block_elems) "
                         f"tensors, got {tuple(new.shape)} and {tuple(old.shape)}")
    nb, be = new.shape
    if nb == 0 or be == 0:
        z = torch.zeros((nb,), dtype=torch.float32, device=new.device)
        return torch.zeros((nb, be), dtype=torch.int8, device=new.device), z, z + 1
    return _launch(new.contiguous(), old.contiguous(), nb * be, be, None)[:3]


def block_delta_flat(new: torch.Tensor, old: torch.Tensor, block_elems: int, *,
                     kernel: Optional[str] = None):
    """Launch a kernel on two equal leaves of the card, read flat as rows of
    ``block_elems``, the last padded with zeros (no padded copy is made).
    Returns (q int8 (nb, block_elems), norm2, scale, dirty bool (nb,)):
    dirty is set where any element's bits differ between new and old.
    ``kernel`` ("cluster" or "two_pass") overrides the route, to time or
    test one kernel."""
    _check(new, old)
    if new.shape != old.shape or block_elems <= 0:
        raise ValueError(f"block_delta_flat takes two equal tensors and rows > 0, got "
                         f"{tuple(new.shape)}, {tuple(old.shape)}, {block_elems}")
    return _launch(new.contiguous(), old.contiguous(), new.numel(), block_elems, kernel)


block_delta.launches = 0            # every kernel launch; callers reset it to 0
block_delta.launches_cluster = 0    # of which the cluster kernel
block_delta.launches_two_pass = 0   # of which the two-pass kernel


def compute_block_delta(new: torch.Tensor, old: torch.Tensor):
    """new/old: (nblocks, block_elems) -> (q int8, norm2 f32, scale f32)."""
    if new.device.type == "cpu":
        return block_delta_ref(new, old)
    return block_delta(new, old)


def compute_block_delta_flat(new: torch.Tensor, old: torch.Tensor, block_elems: int):
    """Equal leaves read flat as rows of ``block_elems`` -> (q int8, norm2,
    scale, dirty bool)."""
    if new.device.type == "cpu":
        return block_delta_flat_ref(new, old, block_elems)
    return block_delta_flat(new, old, block_elems)


def pack_dirty(
    q: torch.Tensor, norm2: torch.Tensor, scale: torch.Tensor, threshold: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select blocks whose delta norm^2 clears ``threshold``.

    Returns (dirty_indices, q_dirty, scales_dirty) — what a commit ships.
    """
    idx = torch.nonzero(norm2 > threshold).flatten()
    return idx, q[idx], scale[idx]
