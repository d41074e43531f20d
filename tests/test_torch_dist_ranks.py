"""The distribution plan on four ranks: one planned float32 train step and
one planned prefill of the reduced qwen2-1.5b, hymba-1.5b and
qwen3-moe-30b-a3b on a 2 x 2 ``data`` x ``model`` mesh of gloo processes
(``repro_torch.launch.ranks``, one group for the whole file), against the
same steps on plain tensors with the MoE tokens routed in the plan's groups.

Bounds are ``test_torch_dist.py``'s one-device plan's: loss and grad norm
1e-5 relative, new params 1e-6 wherever the gradient is above 1e-3 of its
leaf's largest, every new param on its placements; prefill logits 1e-5.
Neither planned step may make a ``_StridedShard`` placement (a sequence
split over ``model`` folded into a batch split over ``data``), which the
plan avoids by gathering the sequence before the column-parallel products
and reduce-scattering it after the row-parallel ones.

The last test pins the DTensor fault behind the train step's old failure:
the backward of ``index_select`` on a sharded input keeps the whole shape
in its local gradient on torch 2.13.0, and torch 2.11 has no sharding rule
for it at all; the test is a strict expected failure on both, before
torch 2.14. The attention therefore slices its KV heads on each rank's
shards.
"""
import pytest
import torch

from repro_torch.launch import ranks as RK

TIMEOUT_S = 80


@pytest.fixture(scope="module")
def reports():
    out = RK.run_ranks(RK.ARCHS, timeout=TIMEOUT_S)
    for r in out:
        assert "error" not in r, (r["rank"], r.get("error"), r.get("trace"))
    return out


def _cells(reports, arch):
    cells = [next(c for c in r["cells"] if c["arch"] == arch) for r in reports]
    for c in cells:
        assert "error" not in c, (c["error"], c["trace"])
    return cells


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_train_step_on_four_ranks_matches_one_device(arch, reports):
    for c in _cells(reports, arch):
        (wl, gl), (wn, gn) = c["loss"], c["grad_norm"]
        assert gl == pytest.approx(wl, rel=1e-5)
        assert gn == pytest.approx(wn, rel=1e-5)
        assert c["param_err"] <= 1e-6 and c["placements_kept"], c
        assert c["train_strided"] == 0, c


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_prefill_on_four_ranks_matches_one_device(arch, reports):
    for c in _cells(reports, arch):
        assert c["prefill_err"] <= 1e-5 and c["prefill_strided"] == 0, c


def _torch_before(major: int, minor: int) -> bool:
    return tuple(int(v) for v in torch.__version__.split(".")[:2]) < (major, minor)


@pytest.mark.xfail(_torch_before(2, 14), strict=True,
                   raises=(AssertionError, NotImplementedError),
                   reason="torch 2.13.0: DTensor's index_select backward on a "
                          "(Shard(0), Replicate()) input keeps the whole shape locally "
                          "(AssertionError); torch 2.11: DTensor has no rule for its "
                          "index_add_ (NotImplementedError)")
def test_dtensor_index_select_backward_keeps_shards():
    """Rank 0 of a fake world of 4 on a 2 x 2 mesh (shapes only): the
    gradient of ``index_select`` over a replicated dim of a batch-split
    input should hold the rank's shard. torch 2.13.0 keeps the whole
    shape; torch 2.11's DTensor has no rule for it (``index_add_`` raises
    NotImplementedError)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    try:
        pl = [Shard(0), Replicate()]
        x = DTensor.from_local(torch.ones(1, 8, 1, 4), mesh, pl,
                               run_check=False).requires_grad_(True)
        with implicit_replication():
            y = x.index_select(2, torch.tensor([0, 0]))
            dy = DTensor.from_local(torch.ones(1, 8, 2, 4), mesh, pl, run_check=False)
            g, = torch.autograd.grad(y, x, dy)
        want, _ = compute_local_shape_and_global_offset(g.shape, mesh, g.placements)
        assert tuple(g.to_local().shape) == tuple(want)
    finally:
        dist.destroy_process_group()
