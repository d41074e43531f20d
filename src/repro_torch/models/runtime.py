"""Step builders and the distribution plan: the bridge between model code
and the trainer, the server and the dry run.

Port of ``repro.models.runtime``: the sharding rules (``train_rules``,
``train_rules_v2``, ``decode_rules``), ``CellPlan`` and ``plan_cell``, the
abstract input and state trees, and the step builders. The plan is the
reference's, re-grounded on DTensor: a spec names mesh axes per tensor dim
as a ``PartitionSpec`` does, and over a ``DeviceMesh`` with the axes
``(pod,) data, model`` it becomes DTensor placements
(``layers.placements``). The steps run eagerly on whatever the state holds:
plain tensors on one device, or DTensors under a plan, whose ops DTensor
partitions and whose constraint points (``ActSharding``) redistribute;
there is no ``jit`` to build.

``trace_cell`` is the dry run's counterpart of the reference's
``lower_cell``: nothing is lowered; it runs the cell's real step once on
fake-tensor DTensors (``FakeTensorMode``, nothing allocated) over a mesh
whose process group may be the ``fake`` backend, under the caller's
dispatch modes, which count what runs. The kernels behind ctypes cannot
take a fake tensor: the dry run runs the plain attention (``attn_impl=
"plain"``), as the reference's dry run lowers ``attention_xla``, and for
the scan its outline on fake shards (``ssm._scan_outline``: a sequential
recurrence of S steps on values that do not exist would only cost time);
``layers.counted_kernel`` counts both by the kernels' formulas.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core import obs
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import Spec, batch_axes_for, placements, spec
from repro_torch.optim import adamw
from repro_torch.tracing import span

PyTree = Any

_TRAIN_STEPS = obs.REGISTRY.counter(
    "faasfs_ml_train_steps_total", help="train steps taken (make_train_step)").labels()
_TRAIN_TOKENS = obs.REGISTRY.counter(
    "faasfs_ml_train_tokens_total", unit="tokens",
    help="tokens that took the loss in those steps (the mask's sum)").labels()
_MOE_LOAD = obs.REGISTRY.gauge(
    "faasfs_ml_moe_load_max_ratio",
    help="the last train step's busiest expert's rows over the mean rows an expert, "
         "worst dropless MoE layer").labels()


# --------------------------------------------------------------------------- #
# Sharding rules (logical axis -> mesh axis)
# --------------------------------------------------------------------------- #
def train_rules(fsdp_axis: Any = "data", tensor_axis: str = "model") -> Dict:
    """FSDP on the data axis + tensor/expert parallel on the model axis."""
    return {
        "vocab": tensor_axis,
        "residual": fsdp_axis,
        "heads": tensor_axis,
        "kv": tensor_axis,
        "ffn": tensor_axis,
        "experts": tensor_axis,
        "expert_ffn": tensor_axis,  # fallback when E doesn't divide (mixtral)
        "dinner": tensor_axis,
        "layers": None,
        None: None,
    }


def train_rules_v2() -> Dict:
    """FSDP over output dims only: contraction dims unsharded, output dims
    over ("data", "model"), so a product all-gathers the weight shard and
    the weight gradients reduce-scatter (ZeRO). Per-device weight memory is
    that of ``train_rules``."""
    return {
        "vocab": ("data", "model"),
        "residual": None,
        "heads": ("data", "model"),
        "kv": ("data", "model"),
        "ffn": ("data", "model"),
        "experts": "model",
        "expert_ffn": "data",
        "dinner": ("data", "model"),
        "layers": None,
        None: None,
    }


def decode_rules(fsdp_axis: Any = "data", tensor_axis: str = "model") -> Dict:
    """Inference keeps the same 2-D weight layout (the reference's baseline)."""
    return train_rules(fsdp_axis, tensor_axis)


@dataclass(frozen=True)
class CellPlan:
    """One (arch x shape x mesh) cell. ``compute_dtype`` is the
    reference's ``loss_fn`` default, bf16; ``attn_impl="plain"`` and
    ``scan_impl="plain"`` run the plain attention and scan math on the
    card, the on-card reference of the kernels. ``remat_policy`` (None or
    "dots") and ``kv_dtype`` (None for the compute type, or ``torch.int8``
    for the quantized KV cache) are the reference's fields, and so are the
    sharding ones: ``batch_axes`` (the mesh axes the batch splits over),
    ``rules`` (logical axis -> mesh axes) and ``act`` (the activation
    specs). Their defaults are one device's: no axes, no rules,
    ``NO_SHARDING``."""

    cfg: ModelConfig
    shape: ShapeCell
    q_chunk: int = 0
    ce_chunk: int = 512
    remat: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    scan_impl: str = "auto"
    remat_policy: Optional[str] = None
    kv_dtype: Optional[torch.dtype] = None
    batch_axes: Optional[Tuple[str, ...]] = None
    rules: Dict = field(default_factory=dict)
    act: M.ActSharding = M.NO_SHARDING


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def plan_cell(
    cfg: ModelConfig,
    shape: ShapeCell,
    mesh,
    *,
    overrides: Optional[Dict] = None,
) -> CellPlan:
    """The reference's baseline plan for a cell: batch over the largest
    prefix of ("pod", "data") that divides it, the sequence of train and
    prefill activations over ``model``, the train or decode rules, the
    reference's ``q_chunk`` and ``ce_chunk`` defaults. ``overrides`` feed
    the reference's hill-climbs: ``seq_axis``, ``rules``, ``act``,
    ``remat_policy``, ``q_chunk``, ``ce_chunk``, ``kv_dtype`` and
    ``moe_impl="a2a"`` (``moe_ffn_a2a`` where the experts split over
    ``model``); the port's own ``attn_impl``/``scan_impl`` too."""
    overrides = overrides or {}
    sizes = mesh_axis_sizes(mesh)
    baxes = batch_axes_for(shape.global_batch, sizes)
    seq_axis = overrides.get("seq_axis", "model")
    rules = overrides.get("rules") or (
        train_rules() if shape.kind == "train" else decode_rules()
    )
    groups = 1
    if baxes is not None:
        for a in baxes:
            groups *= sizes[a]
    moe_a2a = None
    if overrides.get("moe_impl") == "a2a" and cfg.num_experts % sizes.get("model", 1) == 0:
        moe_a2a = dict(
            mesh=mesh, batch_axes=baxes, model_axis="model",
            seq_axis=seq_axis if shape.kind in ("train", "prefill") else None,
        )
    if shape.kind in ("train", "prefill"):
        act = M.ActSharding(
            residual=spec(baxes, seq_axis, None),
            logits=spec(baxes, None, "model"),
            moe_tokens=spec(baxes, None, None),
            moe_buf=spec(baxes, "model", None, None),
            moe_groups=groups,
            moe_a2a=moe_a2a,
            kv_cache=spec(None, baxes, seq_axis, None, None),
        )
    else:  # decode
        act = M.ActSharding(
            decode_residual=spec(baxes, None, None),
            moe_tokens=spec(baxes, None, None),
            moe_buf=spec(baxes, "model", None, None),
            moe_groups=groups,
            kv_cache=spec(None, baxes, "model", None, None),
        )
    act = overrides.get("act", act)
    default_qc = 1024 if shape.seq_len >= 4096 else 0
    if shape.kind == "train" and cfg.d_model >= 7168:
        default_qc = 512  # bound f32 score transients for the widest models
    return CellPlan(
        cfg, shape,
        q_chunk=overrides.get("q_chunk", default_qc),
        ce_chunk=overrides.get("ce_chunk", 512),
        remat_policy=overrides.get("remat_policy"),
        kv_dtype=overrides.get("kv_dtype"),
        attn_impl=overrides.get("attn_impl", "auto"),
        scan_impl=overrides.get("scan_impl", "auto"),
        batch_axes=baxes, rules=rules, act=act,
    )


# --------------------------------------------------------------------------- #
# Abstract inputs and state (DTensors over the mesh; fake under FakeTensorMode)
# --------------------------------------------------------------------------- #
def _distribute(full: torch.Tensor, mesh, s: Spec) -> DTensor:
    """``full``, which every rank holds whole, as a DTensor on the spec
    ``s``: each rank keeps its shard, cut locally (no exchange). Over mesh
    axes of one rank the shard is ``full`` itself, placed whole and then
    redistributed (which over one rank moves nothing), where
    ``distribute_tensor`` would copy it."""
    want = placements(tuple(s) + (None,) * (full.dim() - len(s)), mesh)
    cut = tuple(Replicate() if mesh.size(m) == 1 else p for m, p in enumerate(want))
    t = distribute_tensor(full, mesh, cut, src_data_rank=None)
    return t if cut == want else t.redistribute(mesh, want)


def _dt(shape, dtype, mesh, s: Spec, device) -> DTensor:
    """A DTensor of ``shape`` on the spec ``s``: each rank's shard of a
    zero tensor, cut locally (no exchange). Under ``FakeTensorMode`` nothing
    is allocated."""
    return _distribute(torch.zeros(shape, dtype=dtype, device=device), mesh, s)


def _device(mesh) -> str:
    return mesh.device_type


def input_specs(plan: CellPlan, mesh) -> Dict[str, Any]:
    """DTensor stand-ins for every model input of this cell (zeros): tokens,
    labels, mask and a vlm config's pixel_embeds for train and prefill;
    tokens (B, 1) and ``cur_index`` (a Python int, the reference's replicated
    scalar) for decode."""
    cfg, shape = plan.cfg, plan.shape
    B, dev = shape.global_batch, _device(mesh)
    b = spec(plan.batch_axes, None)
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        text = S - cfg.vision_prefix if cfg.vision_prefix else S
        specs = {"tokens": _dt((B, text), torch.long, mesh, b, dev)}
        if cfg.vision_prefix:
            specs["pixel_embeds"] = _dt((B, cfg.vision_prefix, cfg.d_model), torch.bfloat16,
                                        mesh, b, dev)
        if shape.kind == "train":
            specs["labels"] = _dt((B, text), torch.long, mesh, b, dev)
            specs["mask"] = _dt((B, text), torch.float32, mesh, b, dev)
        return specs
    return {"tokens": _dt((B, 1), torch.long, mesh, b, dev), "cur_index": 0}


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def abstract_sharded_params(plan: CellPlan, mesh, dtype=torch.float32) -> PyTree:
    """The params as DTensors on ``param_partition_specs`` of the plan's
    rules."""
    specs = M.param_partition_specs(plan.cfg, plan.rules, mesh_axis_sizes(mesh))
    dev = _device(mesh)
    return _map_specs(lambda p, s: _dt(p.shape, dtype, mesh, s, dev),
                      M.abstract_params(plan.cfg, dtype), specs)


def abstract_train_state(plan: CellPlan, mesh) -> Dict[str, PyTree]:
    """float32 params and AdamW moments sharded alike (ZeRO), a replicated
    int32 count."""
    params = abstract_sharded_params(plan, mesh, torch.float32)
    moments = [_tree_like(params) for _ in range(2)]
    count = _dt((), torch.int32, mesh, (), _device(mesh))
    return {"params": params, "opt": {"m": moments[0], "v": moments[1], "count": count}}


def _tree_like(tree):
    if isinstance(tree, dict):
        return {k: _tree_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def cache_partition_specs(plan: CellPlan) -> Dict[str, Spec]:
    cfg = plan.cfg
    specs: Dict[str, Spec] = {}
    if cfg.has_attention:
        kv = spec(None, plan.batch_axes, "model", None, None)  # seq over model
        specs["k"] = kv
        specs["v"] = kv
        if plan.kv_dtype is not None and plan.kv_dtype != torch.bfloat16:
            sc = spec(None, plan.batch_axes, "model", None)
            specs["k_scale"] = sc
            specs["v_scale"] = sc
    if cfg.has_ssm:
        specs["conv"] = spec(None, plan.batch_axes, None, "model")
        specs["ssm"] = spec(None, plan.batch_axes, "model", None)
    return specs


def abstract_sharded_cache(plan: CellPlan, mesh) -> PyTree:
    """The cell's decode cache (``plan.kv_dtype`` or bf16) as DTensors on
    ``cache_partition_specs``."""
    cache = M.make_decode_cache(plan.cfg, plan.shape.global_batch, plan.shape.seq_len,
                                plan.kv_dtype or torch.bfloat16, device="meta")
    specs = cache_partition_specs(plan)
    dev = _device(mesh)
    return {k: _dt(t.shape, t.dtype, mesh, specs[k], dev) for k, t in cache.items()}


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Plain tensors (every rank holding the whole) -> DTensors on
    ``specs``, each rank keeping its shard (``_distribute``: on a mesh of
    one rank the tensors themselves)."""
    return _map_specs(lambda t, s: _distribute(t, mesh, s), tree, specs)


def shard_state(plan: CellPlan, mesh, state: Dict[str, PyTree]) -> Dict[str, PyTree]:
    """A one-device train state -> the plan's DTensor state."""
    specs = M.param_partition_specs(plan.cfg, plan.rules, mesh_axis_sizes(mesh))
    opt = state["opt"]
    return {"params": shard_tree(state["params"], specs, mesh),
            "opt": {"m": shard_tree(opt["m"], specs, mesh),
                    "v": shard_tree(opt["v"], specs, mesh),
                    "count": shard_tree(opt["count"], (), mesh)}}


def shard_batch(plan: CellPlan, mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """A train batch (numpy or tensors) -> DTensors on the mesh's device,
    split over the plan's batch axes."""
    b = batch_to_device(batch, _device(mesh))
    return {k: shard_tree(t, spec(plan.batch_axes, None), mesh) for k, t in b.items()}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy or tensor batch leaves -> tensors on ``device``: token ids and
    labels as int64 (the index type of gathers), the rest (mask, a vlm
    batch's pixel_embeds) as they are."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(np.asarray(val)) if not isinstance(val, torch.Tensor) else val
        if key in ("tokens", "labels"):
            t = t.long()
        out[key] = t.to(device)
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _unflatten(pairs):
    tree: Dict = {}
    for path, t in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def _sharded(tree) -> contextlib.AbstractContextManager:
    """DTensor's implicit replication (plain tensors such as positions and
    masks taken as replicated) when the step's state holds DTensors; else
    nothing, so a one-device step runs as it did without a plan."""
    if any(isinstance(t, DTensor) for _, t in _leaves(tree)):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def train_step_tensors(plan: CellPlan, opt_cfg: adamw.AdamWConfig, *,
                       donate: Optional[bool] = None):
    """``make_train_step``'s step with its metrics left as tensors (the dry
    run traces it on fake tensors, which have no values). With ``donate``
    the update consumes the state it is given (``adamw_update``'s
    ``donate``): the state's param and moment containers come back empty;
    None, the default, donates a state that lives on an accelerator, not
    on the CPU. A state that an earlier step consumed raises. A MoE
    model's dropless layers add ``moe_load_max_ratio``, the worst layer's
    busiest expert over the mean (``moe.collect_load``)."""
    cfg = plan.cfg

    def train_step(state: Dict[str, PyTree], batch: Dict[str, Any]):
        leaves = _leaves(state["params"])
        if not leaves:
            raise ValueError("train step: the state has no params; a donating step consumed "
                             "it (step from the state it returned, or make the step with "
                             "donate=False)")
        dev = leaves[0][1].device
        b = batch_to_device(batch, dev)
        ps = [t.detach().requires_grad_(True) for _, t in leaves]
        params = _unflatten([(path, t) for (path, _), t in zip(leaves, ps)])
        with torch.enable_grad(), _sharded(state["params"]):
            with span("train.forward"), moe.collect_load() as loads:
                total, metrics = M.loss_fn(
                    cfg, params, b, shardings=plan.act, compute_dtype=plan.compute_dtype,
                    q_chunk=plan.q_chunk, ce_chunk=plan.ce_chunk, remat=plan.remat,
                    remat_policy=plan.remat_policy, attn_impl=plan.attn_impl,
                    scan_impl=plan.scan_impl)
            with span("train.backward"):
                grads = torch.autograd.grad(total, ps)
        del params, ps, total
        if loads:
            metrics["moe_load_max_ratio"] = torch.stack(loads).max()
        # under a plan each gradient takes its param's placement (the
        # reduce-scatter of FSDP), so the update stays on each shard
        grads = _unflatten([(path, g.redistribute(t.device_mesh, t.placements)
                             if isinstance(g, DTensor) else g)
                            for ((path, t), g) in zip(leaves, grads)])
        del leaves      # a donating update then holds the last reference
        with _sharded(state["params"]), span("train.adamw"):
            new_params, new_opt, opt_metrics = adamw.adamw_update(
                opt_cfg, state["params"], grads, state["opt"],
                donate=dev.type != "cpu" if donate is None else donate)
        return {"params": new_params, "opt": new_opt}, dict(metrics, **opt_metrics)

    return train_step


def make_train_step(plan: CellPlan, opt_cfg: adamw.AdamWConfig, *,
                    donate: Optional[bool] = None):
    """``train_step(state, batch) -> ({"params", "opt"}, metrics)``: the
    gradient of ``loss_fn`` over the params by ``torch.autograd.grad``,
    then ``adamw_update``. The new state is made of new tensors, and no
    tensor of the state given is written. By default (``donate=None``) a
    state on an accelerator is consumed, as the reference's step donates
    it: each leaf's old param and moments leave ``state["params"]`` and
    ``state["opt"]``'s "m" and "v" once its new ones exist, so the step
    holds one state and one leaf more, not two states on the card. A state
    on the CPU is left whole unless ``donate=True``: host code reads the
    state it stepped from, and there the second copy costs host memory. A
    caller that reads the old state afterwards on the card asks for
    ``donate=False``; the new state is the same either way.
    ``metrics`` are Python floats, read back in one transfer: loss,
    aux_loss, tokens, lr and grad_norm, and ``moe_load_max_ratio`` for a
    model with dropless MoE layers. Under a plan the state and batch are
    DTensors (``shard_state``, ``shard_batch``) and the loss runs on the
    plan's ``act``. Each step counts itself and its tokens in
    ``faasfs_ml_train_steps_total`` and ``faasfs_ml_train_tokens_total``
    and sets ``faasfs_ml_moe_load_max_ratio`` where it has that metric."""
    step = train_step_tensors(plan, opt_cfg, donate=donate)

    def train_step(state: Dict[str, PyTree], batch: Dict[str, Any]):
        with span("train.step"):
            new, metrics = step(state, batch)
            with span("train.readback"):
                # a DTensor metric may be a partial sum over ranks: read it whole
                vals = [(v.full_tensor() if isinstance(v, DTensor) else v).detach()
                        for v in metrics.values()]
                out = dict(zip(metrics, torch.stack([v.double() for v in vals]).tolist()))
        _TRAIN_STEPS.inc()
        _TRAIN_TOKENS.inc(int(out["tokens"]))
        if "moe_load_max_ratio" in out:
            _MOE_LOAD.set(out["moe_load_max_ratio"])
        return new, out

    return train_step


def make_prefill_step(plan: CellPlan):
    cfg = plan.cfg

    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        with _sharded(params):
            return M.prefill(cfg, params, batch["tokens"],
                             pixel_embeds=batch.get("pixel_embeds"), shardings=plan.act,
                             compute_dtype=plan.compute_dtype, q_chunk=plan.q_chunk or 1024,
                             attn_impl=plan.attn_impl, scan_impl=plan.scan_impl)

    return prefill_step


def make_decode_cache(plan: CellPlan, device) -> PyTree:
    """The cell's zero decode cache, (global batch, seq_len), in
    ``plan.kv_dtype`` or else the compute type (the reference's
    ``abstract_sharded_cache``, allocated)."""
    return M.make_decode_cache(plan.cfg, plan.shape.global_batch, plan.shape.seq_len,
                               plan.kv_dtype or plan.compute_dtype, device=device)


def make_decode_step(plan: CellPlan):
    cfg = plan.cfg

    def dstep(params: PyTree, cache: PyTree, batch: Dict[str, Any]):
        with _sharded(params):
            return M.decode_step(cfg, params, cache, batch["tokens"], int(batch["cur_index"]),
                                 shardings=plan.act, compute_dtype=plan.compute_dtype)

    return dstep


def trace_cell(plan: CellPlan, mesh, *, opt_cfg: Optional[adamw.AdamWConfig] = None,
               modes: Sequence[contextlib.AbstractContextManager] = ()) -> Dict[str, Any]:
    """Run the cell's real step once over ``mesh`` on the abstract inputs and
    state under ``FakeTensorMode``, with ``modes`` (e.g.
    ``launch.cost_analysis.CostMode``) entered around the step only; a mode
    with a ``track`` method is handed the step's arguments once entered (a
    memory tracker counts them live). Returns {"args": the step's
    arguments, "out": what it returned}: a train step takes (state, batch)
    with float32 params and moments, prefill (bf16 params, batch), decode
    (bf16 params, cache, batch), as the reference's ``lower_cell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    opt_cfg = opt_cfg or adamw.AdamWConfig()
    # the kernels behind ctypes take no fake tensor
    plan = dataclasses.replace(plan, attn_impl="plain", scan_impl="plain")
    kind = plan.shape.kind
    with FakeTensorMode(allow_non_fake_inputs=True):
        if kind == "train":
            args = (abstract_train_state(plan, mesh), input_specs(plan, mesh))
            # undonated: the arguments are returned and read after the step
            fn = train_step_tensors(plan, opt_cfg, donate=False)
        elif kind == "prefill":
            args = (abstract_sharded_params(plan, mesh, torch.bfloat16), input_specs(plan, mesh))
            fn = make_prefill_step(plan)
        else:
            args = (abstract_sharded_params(plan, mesh, torch.bfloat16),
                    abstract_sharded_cache(plan, mesh), input_specs(plan, mesh))
            fn = make_decode_step(plan)
        with contextlib.ExitStack() as stack:
            for m in modes:
                stack.enter_context(m)
                if hasattr(m, "track"):
                    m.track(args)
            out = fn(*args)
    return {"args": args, "out": out}
