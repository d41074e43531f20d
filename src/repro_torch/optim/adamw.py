"""AdamW with decoupled weight decay and global-norm clipping, in PyTorch.

Port of ``repro.optim.adamw``: the same warmup + cosine ``lr_schedule``,
clipping by the global gradient norm, bias correction, and decay only for
leaves with ``ndim >= 2``. The optimizer state has the reference's layout,
``{"m": tree, "v": tree, "count": int32 scalar}`` with float32 moments, so a
state moves between the two packages unchanged (``repro_torch.bridge``).

Updates are functional: ``adamw_update`` returns new tensors and leaves its
inputs as they were, because the transactional trainer compares the new
state with the old one to find the dirty blocks. The reference computes
this in plain XLA and has no kernel here; plain torch ops are the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

PyTree = Any


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
) -> Tuple[PyTree, Dict[str, PyTree], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, {"lr", "grad_norm"})
    as new tensors; ``params``, ``grads`` and ``opt_state`` are not written.
    Each leaf's temporaries are made in place on its fresh outputs, so the
    step needs about one leaf of scratch beyond the old and new state."""
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = torch.square(g).mul_(1 - cfg.b2)
        v_new.add_(cfg.b2 * v)
        del g
        # step = (m / b1c) / (sqrt(v / b2c) + eps)
        step = torch.div(v_new, b2c).sqrt_().add_(cfg.eps)
        step = torch.div(m, b1c).div_(step)
        if p.dim() >= 2:
            step.add_(cfg.weight_decay * p.float())
        newp = p.float() - lr * step
        return newp.to(p.dtype), m, v_new

    out = _map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = _pick(out, 0), _pick(out, 1), _pick(out, 2)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics


def _pick(tree, i: int):
    """The i-th entry of each (param, m, v) tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
