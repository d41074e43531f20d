"""AdamW with decoupled weight decay and global-norm clipping, in PyTorch.

Port of ``repro.optim.adamw``: the same warmup + cosine ``lr_schedule``,
clipping by the global gradient norm, bias correction, and decay only for
leaves with ``ndim >= 2``. The optimizer state has the reference's layout,
``{"m": tree, "v": tree, "count": int32 scalar}`` with float32 moments, so a
state moves between the two packages unchanged (``repro_torch.bridge``).

Updates are functional: ``adamw_update`` returns new tensors and writes
none of its inputs, because the transactional trainer compares the new
state with the old one to find the dirty blocks. With ``donate`` it also
drops each leaf's old param, moments and gradient from the containers it
was handed once that leaf's new ones exist, as the reference's step
donates its state (``lower_cell(donate=True)``): where the caller holds no
other reference, the old leaf's memory goes back before the next leaf's
update, and the update's peak is the new state, the gradients not yet
used and one leaf's new triple, not old and new state together. The
values are the same either way. A leaf's update runs over slices of at
most ``CHUNK`` elements written into its new tensors, so its scratch is
bounded by a slice, not by the leaf. The reference computes this in plain
XLA and has no kernel here; plain torch ops are the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor

PyTree = Any
CHUNK = 1 << 25     # elements of a leaf updated at once (128 MiB in float32)


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to lr_min, in float32 as the reference."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = ((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def init_opt_state(params: PyTree) -> Dict[str, PyTree]:
    """Zero moments (float32, on each leaf's device) and a zero int32 count."""
    dev = _leaves(params)[0].device
    return {
        "m": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "v": _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


def adamw_update(
    cfg: AdamWConfig,
    params: PyTree,
    grads: PyTree,
    opt_state: Dict[str, PyTree],
    *,
    donate: bool = False,
) -> Tuple[PyTree, Dict[str, PyTree], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, {"lr", "grad_norm"})
    as new tensors; ``params``, ``grads`` and ``opt_state`` are not
    written. With ``donate`` each leaf's old param, gradient and moments
    are deleted from ``params``, ``grads`` and ``opt_state``'s "m" and "v"
    as soon as its new ones are made, which leaves those containers empty.
    Each leaf is updated in slices of at most ``CHUNK`` elements, with the
    temporaries of one slice at a time."""
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        newp, new_m, new_v = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
        for pc, gc, mc, vc, out_p, out_m, out_v in _slices(p, g, m, v, newp, new_m, new_v):
            gc = gc.float() * scale
            torch.add(cfg.b1 * mc, (1 - cfg.b1) * gc, out=out_m)
            torch.square(gc, out=out_v).mul_(1 - cfg.b2).add_(cfg.b2 * vc)
            del gc
            # step = (m / b1c) / (sqrt(v / b2c) + eps)
            step = torch.div(out_v, b2c).sqrt_().add_(cfg.eps)
            step = torch.div(out_m, b1c).div_(step)
            if p.dim() >= 2:
                step.add_(cfg.weight_decay * pc.float())
            if out_p.dtype == torch.float32:
                torch.sub(pc, lr * step, out=out_p)
            else:
                out_p.copy_(pc.float() - lr * step)
        return newp, new_m, new_v

    new_p, new_m, new_v = _update(upd, params, grads, opt_state["m"], opt_state["v"], donate)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics


def _slices(*ts: torch.Tensor):
    """Matching flat slices of at most ``CHUNK`` elements of tensors of one
    shape; the tensors whole where they are small, DTensors or not
    contiguous."""
    n = ts[0].numel()
    if n <= CHUNK or isinstance(ts[0], DTensor) or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for lo in range(0, n, CHUNK):
        yield tuple(f[lo:lo + CHUNK] for f in flat)


def _update(upd, p, g, m, v, donate: bool):
    """(new params, new m, new v) trees of ``upd`` over the leaves; with
    ``donate`` each leaf's old entries leave the four input containers
    once its new ones are made."""
    if not isinstance(p, dict):
        return upd(p, g, m, v)
    out: Tuple[Dict, Dict, Dict] = ({}, {}, {})
    for key in list(p):
        new = _update(upd, p[key], g[key], m[key], v[key], donate)
        for tree, t in zip(out, new):
            tree[key] = t
        if donate:
            for tree in (p, g, m, v):
                del tree[key]
    return out
