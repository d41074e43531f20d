"""The distribution plan on eight ranks: the cases of
``repro_torch.launch.ranks`` on its ``multipod`` mesh, a 2 x 2 x 2
``pod`` x ``data`` x ``model`` mesh of gloo processes (one group for the
whole file), with the train and prefill batch (4) split over ``("pod",
"data")`` as ``plan_cell`` splits it on the production multipod mesh. The
checks and bounds are ``test_torch_dist_ranks.py``'s (its docstring),
whose helpers this file runs; a file of its own, so that the eight
processes' group runs on a worker of its own.
"""
import pytest

from repro_torch.launch import ranks as RK
from test_torch_dist_ranks import (OVERRIDES, _check_decode, _check_prefill, _check_train,
                                   _reports)


@pytest.fixture(scope="module")
def reports():
    return _reports("multipod")


def test_multipod_batch_splits_over_pod_and_data():
    from repro_torch.models.layers import batch_axes_for

    shape, axes = RK.MESHES["multipod"]
    assert batch_axes_for(RK.TRAIN_BATCH["multipod"], dict(zip(axes, shape))) == ("pod", "data")
    assert batch_axes_for(RK.DECODE_BATCH, dict(zip(axes, shape))) == ("pod", "data")


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_train_step_on_eight_ranks_matches_one_device(arch, reports):
    _check_train(reports, arch, "train")


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_prefill_on_eight_ranks_matches_one_device(arch, reports):
    _check_prefill(reports, arch)


@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_int8_decode_on_eight_ranks_matches_one_device(arch, reports):
    _check_decode(reports, arch, "decode_int8")


@pytest.mark.parametrize("case", ["decode_f32", "decode_bf16"])
@pytest.mark.parametrize("arch", RK.ARCHS)
def test_planned_decode_on_eight_ranks_matches_one_device(arch, case, reports):
    _check_decode(reports, arch, case)


@pytest.mark.parametrize("case,arch", OVERRIDES)
def test_hill_climb_override_on_eight_ranks_matches_one_device(case, arch, reports):
    _check_train(reports, arch, case)
