"""The port's distribution plan against the JAX package's.

* ``param_partition_specs``: all ten configs x {``train_rules``,
  ``train_rules_v2``, ``decode_rules``} x the pod (16, 16) and multipod
  (2, 16, 16) axis sizes, leaf by leaf, exactly (the reference's function
  is pure Python given the axis sizes; its ``PartitionSpec`` compared as the
  tuple it normalizes to).
* On a fake (16, 16) mesh (``torch.distributed``'s ``fake`` backend, fake
  tensors), every DTensor leaf of ``abstract_sharded_params`` has the global
  shape divided, dim by dim, by the product of its reference spec's axis
  sizes; the per-device parameter, gradient and AdamW bytes of
  ``abstract_train_state`` are that sum, exactly. The same on a fake
  (2, 16, 16) multipod mesh, where that sum is the pod's and the batch
  splits over ``pod`` too (H2b).
* ``plan_cell``: all ten configs x ``SHAPES`` x both meshes give the
  reference's batch axes, ``q_chunk``, ``ce_chunk``, rules and every
  ``ActSharding`` spec; with ``moe_impl="a2a"`` the same ``moe_a2a`` axes.
  The reference's ``plan_cell`` reads only ``mesh.axis_names`` and
  ``mesh.devices.shape``, the port's only a ``DeviceMesh``'s
  ``mesh_dim_names`` and ``shape``, so stand-ins with those serve both
  without 256 devices.
"""
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models import runtime as JR
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.models import model as M
from repro_torch.models import runtime as R

ARCHS = list_configs()
MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}
RULES = {"train": (JR.train_rules, R.train_rules),
         "train_v2": (JR.train_rules_v2, R.train_rules_v2),
         "decode": (JR.decode_rules, R.decode_rules)}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def _ref_specs(arch, rules, sizes):
    specs = JM.param_partition_specs(jget_config(arch), rules, sizes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {tuple(k.key for k in path): tuple(s) for path, s in flat}


def _axes(entry):
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_partition_specs_match_reference(arch, rules, mesh):
    names, shape = MESHES[mesh]
    sizes = dict(zip(names, shape))
    jrules, trules = RULES[rules]
    want = _ref_specs(arch, jrules(), sizes)
    got = _flat(M.param_partition_specs(get_config(arch), trules(), sizes))
    assert got == want


@pytest.fixture(scope="module")
def pod_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_shape(shape, s, sizes):
    return tuple(d // math.prod(sizes[a] for a in _axes(e)) for d, e in zip(shape, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_on_a_fake_pod(arch, pod_mesh):
    """Each leaf's shard is the reference spec's; the state's bytes on one
    device are params + grads + two AdamW moments, float32, + the count."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    sizes = dict(zip(*MESHES["pod"]))
    want = _ref_specs(arch, JR.train_rules(), sizes)
    plan = R.plan_cell(cfg, SHAPES[0], pod_mesh)
    with FakeTensorMode():
        state = R.abstract_train_state(plan, pod_mesh)
    params = _flat(state["params"])
    assert sorted(params) == sorted(want)
    leaf_bytes = 0
    for path, t in params.items():
        local = _local_shape(t.shape, want[path], sizes)
        assert tuple(t.to_local().shape) == local, path
        assert t.dtype == torch.float32
        leaf_bytes += math.prod(local) * 4
    for tree in ("m", "v"):
        for path, t in _flat(state["opt"][tree]).items():
            assert t.to_local().shape == params[path].to_local().shape, (tree, path)
    state_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in _flat(state).values())
    grads = leaf_bytes           # a gradient is sharded as its param
    assert state_bytes + grads == 4 * leaf_bytes + 4     # params, m, v, grads; int32 count


@pytest.fixture(scope="module")
def multipod_mesh():
    """The fake (2, 16, 16) mesh: a fake world of 512, which replaces the
    pod's (the pod's tests run first)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=True)
    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_bytes(arch, mesh):
    """One device's float32 parameter bytes under the reference's train
    rules on ``mesh``'s axis sizes."""
    sizes = dict(zip(*MESHES[mesh]))
    shapes = _flat(M.abstract_params(get_config(arch), torch.float32))
    return sum(math.prod(_local_shape(shapes[path].shape, s, sizes)) * 4
               for path, s in _ref_specs(arch, JR.train_rules(), sizes).items())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_state_on_a_fake_multipod(arch, multipod_mesh):
    """H2b: on the fake (2, 16, 16) mesh each leaf's shard is the
    reference spec's, the state's bytes on one device are params + grads +
    two AdamW moments, float32, + the count, exactly the sum the reference
    specs give, and the parameter and optimizer bytes are the pod's (the
    train rules split params over ``data`` and ``model`` only); the
    per-device batch is half the pod's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    sizes = dict(zip(*MESHES["multipod"]))
    want = _ref_specs(arch, JR.train_rules(), sizes)
    plan = R.plan_cell(cfg, SHAPES[0], multipod_mesh)
    assert plan.batch_axes == ("pod", "data")
    with FakeTensorMode():
        state = R.abstract_train_state(plan, multipod_mesh)
        batch = R.input_specs(plan, multipod_mesh)
    params = _flat(state["params"])
    assert sorted(params) == sorted(want)
    for path, t in params.items():
        assert tuple(t.to_local().shape) == _local_shape(t.shape, want[path], sizes), path
    leaf_bytes = _spec_bytes(arch, "multipod")
    assert leaf_bytes == _spec_bytes(arch, "pod")
    state_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in _flat(state).values())
    assert state_bytes + leaf_bytes == 4 * leaf_bytes + 4
    tokens = batch["tokens"].to_local()
    assert tokens.shape[0] * 2 * 16 == SHAPES[0].global_batch    # pod: / 16


def _stand_ins(mesh):
    """(the reference's ``Mesh``, the port's ``DeviceMesh``) as far as
    ``plan_cell`` reads them."""
    names, shape = MESHES[mesh]
    return (SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=np.int8)),
            SimpleNamespace(mesh_dim_names=names, shape=shape))


def _spec(s):
    return None if s is None else tuple(s)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_cell_matches_reference(arch, shape, mesh):
    jshape = next(s for s in JSHAPES if s.name == shape)
    tshape = next(s for s in SHAPES if s.name == shape)
    jm, tm = _stand_ins(mesh)
    for overrides in (None, {"moe_impl": "a2a"}):
        want = JR.plan_cell(jget_config(arch), jshape, jm, overrides=overrides)
        got = R.plan_cell(get_config(arch), tshape, tm, overrides=overrides)
        assert got.batch_axes == want.batch_axes
        assert (got.q_chunk, got.ce_chunk) == (want.q_chunk, want.ce_chunk)
        assert got.rules == want.rules
        for field in ("residual", "logits", "moe_tokens", "moe_buf", "kv_cache",
                      "decode_residual"):
            assert _spec(getattr(got.act, field)) == _spec(getattr(want.act, field)), field
        assert got.act.moe_groups == want.act.moe_groups
        if want.act.moe_a2a is None:
            assert got.act.moe_a2a is None
        else:
            strip = lambda d: {k: v for k, v in d.items() if k != "mesh"}  # noqa: E731
            assert strip(got.act.moe_a2a) == strip(want.act.moe_a2a)
            assert got.act.moe_a2a["mesh"] is tm
