"""Plain versions of the grouped expert products: a loop over the experts.

Rows sorted by expert: expert e owns rows ``offs[e]:offs[e + 1]``. Each
expert's product runs over every row and is kept on its own rows only
(``torch.where`` on a mask made from ``offs``), so the offsets are never
read back to the host and the loop runs on meta and fake tensors too.
Products are in float32, rounded once to the inputs' type, as the kernels
accumulate. These are the CPU route of ``ops`` and the tests' yardstick.
"""
from __future__ import annotations

import torch


def segment_mask(offs: torch.Tensor, rows: int) -> torch.Tensor:
    """(E, rows) bool: row r lies in expert e's segment."""
    r = torch.arange(rows, device=offs.device)
    return (r[None, :] >= offs[:-1, None]) & (r[None, :] < offs[1:, None])


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
                   trans_w: bool = False) -> torch.Tensor:
    """x (M, K), w (E, K, N) (or (E, N, K) with ``trans_w``), offs (E + 1,)
    -> (M, N): each row times its expert's w (w^T with ``trans_w``)."""
    mask = segment_mask(offs, x.shape[0])
    xf = x.float()
    n = w.shape[1] if trans_w else w.shape[2]
    out = xf.new_zeros(x.shape[0], n)
    for e in range(w.shape[0]):
        we = w[e].float()
        out = out + torch.where(mask[e, :, None], xf @ (we.T if trans_w else we), 0.0)
    return out.to(x.dtype)


def grouped_mm_wgrad_ref(x: torch.Tensor, dy: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x (M, K), dy (M, N), offs (E + 1,) -> (E, K, N): each expert's
    x_e^T dy_e over its rows (zeros for an expert with none)."""
    mask = segment_mask(offs, x.shape[0])
    xf, dyf = x.float(), dy.float()
    out = [torch.where(mask[e, :, None], xf, 0.0).T @ dyf for e in range(mask.shape[0])]
    return torch.stack(out).to(x.dtype)
