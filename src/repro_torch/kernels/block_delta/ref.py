"""Plain PyTorch version of the block-delta kernel.

Port of ``repro.kernels.block_delta.ref``. ``torch.round`` rounds half to
even like ``jnp.round`` and the quotient is an IEEE division, so q is the
int8 that float32 arithmetic gives, and the CUDA kernel's q equals it. The
JAX reference on XLA:CPU divides through an approximate reciprocal and can
land one step away where the quotient is within a few ulps of a
half-integer (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import torch


def block_delta_ref(new: torch.Tensor, old: torch.Tensor):
    diff = new.float() - old.float()
    norm2 = (diff * diff).sum(dim=1)
    maxabs = diff.abs().amax(dim=1)
    # a tensor divisor: with a Python scalar divisor torch's CUDA division
    # multiplies by the reciprocal, one ulp away from the IEEE quotient
    scale = torch.where(maxabs > 0, maxabs / torch.full_like(maxabs, 127.0),
                        torch.ones_like(maxabs))
    q = torch.clamp(torch.round(diff / scale[:, None]), -127, 127).to(torch.int8)
    return q, norm2, scale


def apply_delta_ref(old: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize + apply: reconstruct new params from the shipped delta."""
    return (old.float() + q.float() * scale[:, None]).to(old.dtype)
