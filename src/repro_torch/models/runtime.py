"""Step builders: the bridge between model code and the trainer and server.

Port of the step builders of ``repro.models.runtime`` (``make_train_step``
:242, ``make_prefill_step`` :265, ``make_decode_step`` :279) for one device.
``CellPlan`` keeps what a step on one device needs: the reference's plan
also carries sharding rules and activation PartitionSpecs, which wait for
the distributed slice (ROADMAP, Queue 1). The steps run eagerly; there is
no ``jit`` to build.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import model as M
from repro_torch.optim import adamw

PyTree = Any


@dataclass(frozen=True)
class CellPlan:
    """One (arch x shape) cell on one device. ``compute_dtype`` is the
    reference's ``loss_fn`` default, bf16; ``attn_impl="plain"`` and
    ``scan_impl="plain"`` run the plain attention and scan math on the
    card, the on-card reference of the kernels. ``remat_policy`` (None or
    "dots") and ``kv_dtype`` (None for the compute type, or ``torch.int8``
    for the quantized KV cache) are the reference's fields."""

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


def make_train_step(plan: CellPlan, opt_cfg: adamw.AdamWConfig):
    """``train_step(state, batch) -> ({"params", "opt"}, metrics)``: the
    gradient of ``loss_fn`` over the params by ``torch.autograd.grad``,
    then ``adamw_update``. The state's tensors are read, never written; the
    new state is made of new tensors. ``metrics`` are Python floats: loss,
    aux_loss, tokens, lr and grad_norm."""
    cfg = plan.cfg

    def train_step(state: Dict[str, PyTree], batch: Dict[str, Any]):
        leaves = _leaves(state["params"])
        dev = leaves[0][1].device
        b = batch_to_device(batch, dev)
        ps = [t.detach().requires_grad_(True) for _, t in leaves]
        params = _unflatten([(path, t) for (path, _), t in zip(leaves, ps)])
        with torch.enable_grad():
            total, metrics = M.loss_fn(
                cfg, params, b, compute_dtype=plan.compute_dtype, q_chunk=plan.q_chunk,
                ce_chunk=plan.ce_chunk, remat=plan.remat, remat_policy=plan.remat_policy,
                attn_impl=plan.attn_impl, scan_impl=plan.scan_impl)
            grads = torch.autograd.grad(total, ps)
        del params, ps, total
        grads = _unflatten([(path, g) for (path, _), g in zip(leaves, grads)])
        new_params, new_opt, opt_metrics = adamw.adamw_update(
            opt_cfg, state["params"], grads, state["opt"])
        metrics = {k: float(v.detach()) for k, v in dict(metrics, **opt_metrics).items()}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(plan: CellPlan):
    cfg = plan.cfg

    def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor]):
        return M.prefill(cfg, params, batch["tokens"],
                         pixel_embeds=batch.get("pixel_embeds"),
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
        return M.decode_step(cfg, params, cache, batch["tokens"], int(batch["cur_index"]),
                             compute_dtype=plan.compute_dtype)

    return dstep
