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

from repro_torch.kernels.block_delta.ops import blockify, compute_block_delta


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
    kernel (its plain version for CPU tensors) and a block is dirty where
    its delta norm^2 is above 0 or any of its int8 q is non-zero; any other
    leaf gets the exact byte compare. The q test catches what the
    reference's norm^2 rule misses: a block whose every delta is so small
    that its square underflows float32 has norm^2 0, but its largest delta
    quantizes to +-127. The kernel is only the detector: ``TensorStore.save``
    writes the dirty blocks' exact new bytes, never the lossy int8 delta.
    The kernel detector still does not see a block whose only change is the
    sign of a zero (the float difference is 0), nor NaN payloads."""
    if new.dtype != old.dtype or new.shape != old.shape:
        return None
    if new.numel() == 0:
        return []
    if new.dtype == torch.float32 and block_bytes % 4 == 0 \
            and new.numel() >= block_bytes // 4:
        block_elems = block_bytes // 4
        nb = blockify(new.contiguous().reshape(-1), block_elems)
        ob = blockify(old.contiguous().reshape(-1), block_elems)
        q, norm2, _ = compute_block_delta(nb, ob)
        return torch.nonzero((norm2 > 0) | (q != 0).any(dim=1)).flatten().tolist()
    return exact_dirty_blocks(new, old, block_bytes)
