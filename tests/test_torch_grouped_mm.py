"""The grouped expert products (``repro_torch.kernels.grouped_mm``) on the
CPU: the plain loop over experts (``ref.py``, the CPU route and the card
tests' yardstick) against a slice-by-slice loop that reads the offsets on
the host, in both forms (rows times their expert's weights, or their
transposes, and the weight gradient), with empty experts, one expert
taking every row and segments of one row; ``GroupedMMFn``'s backward
formulas (its launches replaced by the plain versions) against autograd
of the plain loop; and the loop on meta tensors, where nothing can be
read back. The kernels themselves run in ``tests/test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.kernels.grouped_mm import ops
from repro_torch.kernels.grouped_mm.ref import (grouped_mm_ref, grouped_mm_wgrad_ref,
                                                segment_mask)

COUNTS = {"spread": [3, 0, 5, 1, 7, 0, 2, 6], "one_takes_all": [0, 0, 24, 0],
          "all_empty_but_last": [0, 0, 0, 9], "single_rows": [1, 1, 1, 1, 1]}


def _offs(counts):
    return torch.tensor([0] + counts, dtype=torch.int32).cumsum(0).to(torch.int32)


def _sliced(x, w, offs, trans_w=False):
    out = []
    for e, (lo, hi) in enumerate(zip(offs[:-1].tolist(), offs[1:].tolist())):
        we = w[e].float()
        out.append(x[lo:hi].float() @ (we.T if trans_w else we))
    return torch.cat(out).to(x.dtype)


def _close(got, want):
    """Equal up to the summation order of float32 products (one bf16 step
    where the result is rounded to bf16)."""
    tol = 1e-5 if got.dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _case(counts, K=12, N=8, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    M, E = sum(counts), len(counts)
    x = torch.randn(M, K, generator=g).to(dtype)
    w = torch.randn(E, K, N, generator=g).to(dtype)
    dy = torch.randn(M, N, generator=g).to(dtype)
    return x, w, dy, _offs(counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("counts", list(COUNTS.values()), ids=list(COUNTS))
def test_ref_matches_slices_in_both_forms(counts, dtype):
    x, w, dy, offs = _case(counts, dtype=dtype)
    _close(grouped_mm_ref(x, w, offs), _sliced(x, w, offs))
    wt = w.transpose(1, 2).contiguous()                  # (E, N, K)
    _close(grouped_mm_ref(x, wt, offs, trans_w=True), _sliced(x, wt, offs, True))
    dw = grouped_mm_wgrad_ref(x, dy, offs)
    assert dw.shape == w.shape and dw.dtype == dtype
    for e, (lo, hi) in enumerate(zip(offs[:-1].tolist(), offs[1:].tolist())):
        want = (x[lo:hi].float().T @ dy[lo:hi].float()).to(dtype)
        _close(dw[e], want)
        if lo == hi:
            assert not dw[e].any()


def test_segment_mask_marks_each_row_once():
    offs = _offs(COUNTS["spread"])
    mask = segment_mask(offs, int(offs[-1]))
    assert mask.shape == (8, 24) and torch.equal(mask.sum(0), torch.ones(24, dtype=torch.long))
    assert mask.sum(1).tolist() == COUNTS["spread"]


@pytest.mark.parametrize("counts", list(COUNTS.values()), ids=list(COUNTS))
def test_fn_backward_matches_autograd_of_the_loop(monkeypatch, counts):
    """``GroupedMMFn``'s input and weight gradients, its launches replaced
    by the plain loop, against autograd through ``grouped_mm_ref``."""
    monkeypatch.setattr(ops, "launch_mm", grouped_mm_ref)
    monkeypatch.setattr(ops, "launch_wgrad", grouped_mm_wgrad_ref)
    x, w, dy, offs = _case(counts, seed=1)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ops.GroupedMMFn.apply(xa, wa, offs)
    y.backward(dy)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    grouped_mm_ref(xb, wb, offs).backward(dy)
    torch.testing.assert_close(y, grouped_mm_ref(x, w, offs), rtol=0, atol=0)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-6, atol=1e-6)


def test_cpu_and_meta_take_the_loop():
    x, w, _, offs = _case(COUNTS["spread"])
    assert torch.equal(ops.grouped_mm(x, w, offs), grouped_mm_ref(x, w, offs))
    xm, wm = x.to("meta"), w.to("meta")
    y = ops.grouped_mm(xm, wm, offs.to("meta"))
    assert y.shape == (24, 8) and y.device.type == "meta"
