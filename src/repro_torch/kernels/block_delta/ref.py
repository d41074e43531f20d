"""Plain PyTorch version of the block-delta kernel.

Port of ``repro.kernels.block_delta.ref``. ``torch.round`` rounds half to
even like ``jnp.round`` and the quotient is an IEEE division, so q is the
int8 that float32 arithmetic gives, and the CUDA kernel's q equals it. The
JAX reference on XLA:CPU divides through an approximate reciprocal and can
land one step away where the quotient is within a few ulps of a
half-integer (ROADMAP.md, Queue 3).

Special values follow the reference as XLA:CPU (and the TPU) computes it:

* subnormal inputs and results are flushed to zero (``_ftz``), as XLA
  flushes them, so a row of subnormal deltas has scale 1.0 and q 0, and a
  row whose max|d| / 127 is below the smallest normal float32 has scale 0;
* max|d| propagates NaN, so a row with a NaN delta has scale 1.0;
* a quotient that is NaN (a NaN delta, inf / inf, 0 / 0) gives q = 0,
  stated here rather than left to the cast of NaN to int8; +-inf
  quotients clip to +-127.

``block_delta_flat_ref`` also returns the exact per-row dirty flag: a row
is dirty iff the bit pattern of any element differs between ``new`` and
``old`` (the kernel computes it in the same pass).
"""
from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to a zero of the same sign."""
    return torch.where(x.abs() < _TINY, x * 0, x)


def block_delta_ref(new: torch.Tensor, old: torch.Tensor):
    """new/old (nblocks, block_elems) -> (q int8, norm2 f32, scale f32)."""
    diff = _ftz(_ftz(new.float()) - _ftz(old.float()))
    norm2 = _ftz(diff * diff).sum(dim=1)
    maxabs = diff.abs().amax(dim=1)
    # a tensor divisor: with a Python scalar divisor torch's CUDA division
    # multiplies by the reciprocal, one ulp away from the IEEE quotient
    scale = torch.where(maxabs > 0, _ftz(maxabs / torch.full_like(maxabs, 127.0)),
                        torch.ones_like(maxabs))
    quot = diff / scale[:, None]
    q = torch.where(torch.isnan(quot), torch.zeros_like(quot),
                    torch.clamp(torch.round(quot), -127, 127)).to(torch.int8)
    return q, norm2, scale


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


def block_delta_flat_ref(new: torch.Tensor, old: torch.Tensor, block_elems: int):
    """Flat leaves of n elements, cut into rows of ``block_elems``, the last
    one padded with zeros on both sides -> (q int8 (nb, block_elems), norm2,
    scale, dirty bool (nb,))."""
    a = blockify(new.reshape(-1), block_elems)
    b = blockify(old.reshape(-1), block_elems)
    q, norm2, scale = block_delta_ref(a, b)
    bits = _BITS[new.dtype]
    return q, norm2, scale, (a.view(bits) != b.view(bits)).any(dim=1)


def apply_delta_ref(old: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize + apply: reconstruct new params from the shipped delta."""
    return (old.float() + q.float() * scale[:, None]).to(old.dtype)
