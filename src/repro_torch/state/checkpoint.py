"""Dirty-block detection for block-granular FaaSFS saves of device tensors.

Port of ``repro.state.checkpoint.dirty_block_indices`` (``:50-97``). The
reference's ``CheckpointManager`` waits for the training slice: its delta
save writes only the dirty blocks into a NEW ``step_{n}`` directory, so
the clean blocks of that file read back as zeros (ROADMAP, Queue 3). The
serving slice publishes in place instead, with
``TensorStore.save(name, tree, dirty_blocks=...)`` on the same name.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels.block_delta.ops import blockify, compute_block_delta_flat


def exact_dirty_blocks(new: torch.Tensor, old: torch.Tensor, block_bytes: int) -> List[int]:
    """Blocks (``block_bytes`` granularity over the raw leaf bytes) where
    the bytes of ``new`` and ``old`` differ, compared on their device."""
    a = new.contiguous().reshape(-1).view(torch.uint8)
    b = old.contiguous().reshape(-1).view(torch.uint8)
    diff = blockify(a != b, block_bytes).any(dim=1)
    return torch.nonzero(diff).flatten().tolist()


def dirty_block_indices(
    new: torch.Tensor,
    old: torch.Tensor,
    block_bytes: int,
) -> Optional[List[int]]:
    """Block indices where ``new`` differs from ``old``; ``None`` means
    "unknown, write conservatively" (shape or dtype changed).

    A float32 leaf at least one block long goes through the block-delta
    kernel (its plain version for CPU tensors), read flat with the ragged
    last block padded inside the kernel, and a block is dirty where the
    kernel's exact flag is set: the bits of some element differ between
    ``new`` and ``old``. Any other leaf gets the exact byte compare. So the
    answer is the byte compare's, ``exact_dirty_blocks`` and the
    reference's default ``impl="auto"``, also where the kernel's norm^2 and
    q see nothing: a zero whose sign flips, a NaN whose payload changes, a
    finite value that becomes NaN (norm^2 NaN, scale 1, q 0), a delta whose
    square underflows. The kernel is only the detector: ``TensorStore.save``
    writes the dirty blocks' exact new bytes, never the lossy int8 delta."""
    if new.dtype != old.dtype or new.shape != old.shape:
        return None
    if new.numel() == 0:
        return []
    if new.dtype == torch.float32 and block_bytes % 4 == 0 \
            and new.numel() >= block_bytes // 4:
        _, _, _, dirty = compute_block_delta_flat(new.reshape(-1), old.reshape(-1),
                                                  block_bytes // 4)
        return torch.nonzero(dirty).flatten().tolist()
    return exact_dirty_blocks(new, old, block_bytes)
