"""Token-choice MoE with group-local, capacity-bounded dispatch, in PyTorch.

Port of ``repro.models.moe`` (``top_k_routing`` :27, ``load_balance_loss``
:35, ``moe_ffn`` :47) as plain functions on tensors, with the reference's
semantics:

* **Top-k.** ``jax.lax.top_k`` puts the lower expert index first when two
  gates are equal; ``torch.topk`` promises no order on ties. The top k come
  from a stable descending sort instead, which keeps the lower index first.
  The order matters beyond the weights: it decides which slots lose their
  place when an expert is full.
* **Capacity** is ``max(k, int(cf * Tg * k / E))``, a Python float floored,
  as the reference's code computes it (``moe.py:77``); the reference's
  module docstring says ceil, its code floors.
* **Position in expert** is the exclusive cumulative sum over the slots in
  token-major, k-minor order, within each group. A slot is kept when its
  position is below the capacity.
* **Dispatch** writes the kept slots into a (G, E * C + 1, D) buffer whose
  spare last row takes every dropped slot, so the kept rows are written
  once each (``index_copy``, no accumulation) and the spare row is cut off;
  the reference adds zeros at position C - 1 instead, which leaves the same
  buffer. Nothing is read back to the host: no boolean indexing, no
  ``.item()``.
* **Expert products** stay ``torch.einsum`` (the reference computes them
  outside any Pallas kernel), with the activation ``h * g * sigmoid(g)``
  in float32 and cast back, as ``:106``.
* **Combine** gathers each slot's row at its position clamped to C - 1,
  weights it by ``weight * keep`` and sums the k slots.
* **Gradients** flow as XLA differentiates the reference: the routing ids
  and the keep mask are integers and carry none; the normalized top-k
  weights carry theirs back through the softmax to the router, and the
  load-balance term through the mean of the gates.

``moe_ffn_a2a`` (the reference's expert-parallel all-to-all, ``:142``) is
not ported: it needs a process group and a sharded expert plan, and waits
for the DTensor/FSDP plan (ROADMAP, Queue 1 item 7). Nothing on the port's
paths calls it.

The layer's three parts run inside ``record_function`` ranges,
``moe_routing``, ``moe_dispatch`` (the scatter and the combine's gather) and
``moe_experts``, by which ``tools/train_profile.py`` splits a step's device
time; outside a profiler a range costs a few microseconds of host time.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function


def top_k_routing(router_logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """router_logits: (..., E) -> (weights (..., k) float32 normalized,
    ids (..., k) int64), the larger gates first, the lower id first on
    ties."""
    gates = torch.softmax(router_logits.float(), dim=-1)
    weights, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, ids = weights[..., :k], ids[..., :k]
    return weights / weights.sum(dim=-1, keepdim=True), ids


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss over all tokens: E * sum(mean gate *
    mean count) over the experts."""
    gates = torch.softmax(logits.float(), dim=-1)
    me = gates.reshape(-1, num_experts).mean(dim=0)
    ce = _one_hot(ids, num_experts).float().sum(dim=-2).reshape(-1, num_experts).mean(dim=0)
    return num_experts * (me * ce).sum()


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot`` without its range check, which reads the ids' min and
    max back to the host on the CPU."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots an expert takes from a group of ``num_tokens`` tokens."""
    return max(top_k, int(capacity_factor * num_tokens * top_k / num_experts))


def moe_ffn(
    x: torch.Tensor,
    router: torch.Tensor,
    wi: torch.Tensor,
    wg: torch.Tensor,
    wo: torch.Tensor,
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss float32 scalar).

    router: (D, E); wi, wg: (E, D, F); wo: (E, F, D). The B * S tokens are
    routed in ``groups`` groups of batch rows (one group when ``groups``
    does not divide B), each with its own capacity count.
    """
    B, S, D = x.shape
    E, k = num_experts, top_k
    G = groups if B % max(groups, 1) == 0 else 1
    Tg = (B // G) * S
    xg = x.reshape(G, Tg, D)

    with record_function("moe_routing"):
        logits = xg @ router                                # (G, Tg, E)
        weights, ids = top_k_routing(logits, k)             # (G, Tg, k)
        aux = load_balance_loss(logits, ids, E)

    C = capacity(Tg, E, k, capacity_factor)
    with record_function("moe_dispatch"):
        flat_ids = ids.reshape(G, Tg * k)
        flat_w = weights.reshape(G, Tg * k)
        onehot = _one_hot(flat_ids, E)                      # (G, Tg*k, E)
        pos = (onehot.cumsum(dim=1) - onehot).gather(2, flat_ids[..., None])[..., 0]
        keep = pos < C
        pos = torch.where(keep, pos, C - 1)
        # kept slots to their (expert, position) row, dropped ones to the
        # group's spare row E * C
        rows = E * C + 1
        base = torch.arange(G, device=x.device)[:, None] * rows
        dest = base + torch.where(keep, flat_ids * C + pos, E * C)
        tok = torch.arange(Tg * k, device=x.device) // k    # slot -> token
        xs = xg[:, tok].reshape(G * Tg * k, D)
        buf = xs.new_zeros(G * rows, D).index_copy(0, dest.reshape(-1), xs)
        buf = buf.view(G, rows, D)[:, :E * C].reshape(G, E, C, D)

    with record_function("moe_experts"):
        h = torch.einsum("gecd,edf->gecf", buf, wi)
        g = torch.einsum("gecd,edf->gecf", buf, wg)
        h = h * g * torch.sigmoid(g.float()).to(h.dtype)    # h * silu(g)
        ye = torch.einsum("gecf,efd->gecd", h, wo)

    with record_function("moe_dispatch"):
        # combine: each slot's row (a dropped slot reads position C - 1 at
        # weight 0), weighted, summed over the k slots
        src = torch.arange(G, device=x.device)[:, None] * (E * C) + flat_ids * C + pos
        ys = ye.reshape(G * E * C, D).index_select(0, src.reshape(-1)).view(G, Tg * k, D)
        ys = ys * (flat_w * keep)[..., None].to(ye.dtype)
        out = ys.view(G, Tg, k, D).sum(dim=2)
    return out.reshape(B, S, D), aux
