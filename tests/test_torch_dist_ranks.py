"""The distribution plan on four ranks: the cases of
``repro_torch.launch.ranks`` on its ``pod`` mesh, a 2 x 2 ``data`` x
``model`` mesh of gloo processes (one group for the whole file), each
against the same computation on plain tensors with the MoE tokens routed in
the plan's groups. ``test_torch_dist_multipod.py`` runs the same checks on
the eight-rank ``multipod`` mesh, with this file's helpers.

Bounds, for every rank:

* train step (``train``, and the hill-climb's overrides ``rules_v2``,
  ``dots``, ``q_chunk``, ``a2a``): ``test_torch_dist.py``'s one-device
  plan's: loss and grad norm 1e-5 relative, new params 1e-6 wherever the
  gradient is above 1e-3 of its leaf's largest, every new param on its
  placements; the ``a2a`` case drops no slot (``ranks.A2A_CF``);
* prefill: logits 1e-5;
* decode, 10 steps over 16 positions, batch 4 (the steps cross the
  ``model`` split of the cache): float32 cache, logits and cache 1e-5;
  int8 cache at float32 compute: every int8 K/V value identical, scales
  1e-6 relative, logits 1e-5 (the split decode attention once rounded
  the unnormalized exponentials and each rank's product to bf16, and
  left 58 (qwen2-1.5b) and 190 (hymba-1.5b) int8 values a level off);
  bf16
  cache and compute, the planned serving path: logits within two bf16
  epsilons (2 x 2^-7) of the largest logit, ``BF16_LOGIT_REL``: a bf16
  step rounds every product, and the plan's products split their sums
  over ranks, so the two decodes may differ by a rounding of the logits
  (0.33 to 1.14 epsilons measured, torch 2.11 and 2.13).
  qwen3-moe-30b-a3b's int8 decode holds its logits to the bf16 bound
  too: the int8 cache attends in bf16, and at one of its steps one
  element of the float32 query, 6e-7 apart on the two paths (the plan's
  products sum in another order), rounds to the neighbouring bf16 value
  (2.3e-4 on the logits at that step; its cache stays identical).

No planned step may make a ``_StridedShard`` placement (a sequence split
over ``model`` folded into a batch split over ``data``), which the plan
avoids by gathering the sequence before the column-parallel products and
reduce-scattering it after the row-parallel ones.

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

TIMEOUT_S = 600
BF16_LOGIT_REL = 2 * 2.0 ** -7
# int8 decodes whose logits are held to the bf16 bound (module docstring)
INT8_AT_BF16 = ("qwen3-moe-30b-a3b",)
OVERRIDES = [(case, arch) for case in ("rules_v2", "dots", "q_chunk", "a2a")
             for arch in RK.CASES[case][2]]


def _reports(mesh: str):
    out = RK.run_ranks(RK.ARCHS, timeout=TIMEOUT_S, mesh=mesh)
    for r in out:
        assert "error" not in r, (r["rank"], r.get("error"), r.get("trace"))
    return out


@pytest.fixture(scope="module")
def reports():
    return _reports("pod")


def _cells(reports, arch, case):
    cells = [next(c for c in r["cells"] if (c["arch"], c["case"]) == (arch, case))
             for r in reports]
    for c in cells:
        assert "error" not in c, (c["error"], c["trace"])
    return cells


def _check_train(reports, arch, case):
    for c in _cells(reports, arch, case):
        (wl, gl), (wn, gn) = c["loss"], c["grad_norm"]
        assert gl == pytest.approx(wl, rel=1e-5)
        assert gn == pytest.approx(wn, rel=1e-5)
        assert c["param_err"] <= 1e-6 and c["placements_kept"], c
        assert c["strided"] == 0, c
        if case == "a2a":
            assert c["dropped"] == 0, c


def _check_prefill(reports, arch):
    for c in _cells(reports, arch, "prefill"):
        assert c["err"] <= 1e-5 and c["strided"] == 0, c


def _check_decode(reports, arch, case):
    for c in _cells(reports, arch, case):
        assert c["strided"] == 0, c
        bf16 = BF16_LOGIT_REL * c["logit_max"]
        if case == "decode_f32":
            assert c["logit_err"] <= 1e-5 and c["cache_err"] <= 1e-5, c
        elif case == "decode_int8":
            assert c["int8_off"] == 0 and c["scale_rel"] <= 1e-6, c
            assert c["logit_err"] <= (bf16 if arch in INT8_AT_BF16 else 1e-5), c
        else:
            assert c["logit_err"] <= bf16, c


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_train_step_on_four_ranks_matches_one_device(arch, reports):
    _check_train(reports, arch, "train")


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_prefill_on_four_ranks_matches_one_device(arch, reports):
    _check_prefill(reports, arch)


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_int8_decode_on_four_ranks_matches_one_device(arch, reports):
    _check_decode(reports, arch, "decode_int8")


@pytest.mark.parametrize("case", ["decode_f32", "decode_bf16"])
@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_decode_on_four_ranks_matches_one_device(arch, case, reports):
    _check_decode(reports, arch, case)


@pytest.mark.parametrize("case,arch", OVERRIDES)
def test_hill_climb_override_on_four_ranks_matches_one_device(case, arch, reports):
    _check_train(reports, arch, case)


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
