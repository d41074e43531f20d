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

**Dropless.** Where a group's capacity takes all its tokens (``capacity(Tg,
E, k, cf) >= Tg``, which ``capacity_factor >= E / k`` gives) no slot can be
dropped, and ``_dispatch`` of a plain ``x`` that the grouped products take
(``grouped_mm.takes``: on the CPU, or bf16 on the card; a float32 ``x`` on
the card fills the buffer as below) sorts instead of filling the
capacity buffer: the B S k slots sorted by expert (stably: token-major within an
expert), each expert's row offsets found on the device
(``searchsorted``), the rows gathered once, the three expert products run
as grouped products over the experts' contiguous segments
(``kernels/grouped_mm``: a hand-written kernel on the card, the plain loop
over experts elsewhere), and each token's k outputs put back in slot order
and combined by their weights. It makes no (G, E, C, D) buffer, runs no
cumulative sum over (slots, E), and computes exactly the routed rows;
its outputs and gradients are the capacity path's at that capacity, up to
the products' summation order. The dispatch's gather and the combine are
each other's inverse permutations, so both gradients are gathers (a
token's k slot gradients summed in slot order). While ``collect_load`` is
entered each such layer adds its load ratio (busiest expert's rows over
the mean) to the collected list, which the train step reads back with its
other metrics (gauge ``faasfs_ml_moe_load_max_ratio``, the worst layer);
counter ``faasfs_ml_moe_rows_total`` counts the routed rows from shapes.

Under a plan (DTensor ``x``) ``moe_ffn`` keeps the reference's global
view: each batch group routes and dispatches its own tokens on its shards,
the (G, E, C, D) buffer is constrained to ``buf_spec`` (experts on
``model``, a free slice), the expert products run as DTensor products, and
the combine reads the outputs gathered back on each group's shard.

``moe_ffn_a2a`` is the reference's expert-parallel all-to-all (``:142``),
the plan's ``moe_impl="a2a"``: each rank routes its own tokens, scatters
them into per-expert send slabs, exchanges them over the ``model`` process
group with ``all_to_all_single`` (its autograd form: the backward is the
reverse exchange), runs its own experts, exchanges back and combines. The
load-balance vectors are averaged over ``model`` and the batch axes before
their product, so the aux loss is the global batch's. It reuses
``moe_ffn``'s dispatch, expert and combine code, so on a group of one rank
its outputs and routing are ``moe_ffn``'s bit for bit.

The layer's three parts run inside ``record_function`` ranges,
``moe_routing`` (router, softmax, top-k, aux), ``moe_dispatch`` (the
scatter and the combine's gather; the dropless sort, offsets, gather and
combine) and ``moe_experts`` (the products and the activation), by
which ``launch/perf.py`` and ``tools/train_profile.py``
split a step's device time. Unlike ``repro_torch.tracing``'s ranges they
are entered with the profiler off too, at a few microseconds of host time
each: the dry run (``launch/cost_analysis.py``) reads them as scopes
without a profiler, and its output must not change.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.core import obs
from repro_torch.kernels.grouped_mm.ops import grouped_mm, takes
from repro_torch.models.layers import Spec, constrain, on_shards, spec


_MOE_ROWS = obs.REGISTRY.counter(
    "faasfs_ml_moe_rows_total", unit="rows",
    help="routed rows (tokens x top-k) the dropless MoE layer computed, counted from shapes "
         "in a train step's forward and in inference, never in a remat recompute").labels()
_loads: contextvars.ContextVar = contextvars.ContextVar("moe_loads", default=None)


@contextlib.contextmanager
def collect_load():
    """Collects, while entered, each dropless MoE layer's load ratio (its
    busiest expert's rows over the mean, a float32 device scalar) into the
    list it yields. A train step enters it around its forward only, so a
    remat recompute in the backward adds nothing."""
    sink: List[torch.Tensor] = []
    token = _loads.set(sink)
    try:
        yield sink
    finally:
        _loads.reset(token)


def _note_load(offs: torch.Tensor, rows: int, E: int) -> None:
    sink = _loads.get()
    if sink is not None:
        sink.append((offs[1:] - offs[:-1]).max().float() * (E / max(rows, 1)))
    if sink is not None or not torch.is_grad_enabled():
        _MOE_ROWS.inc(rows)


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
    me, ce = _balance_vectors(logits, ids, num_experts)
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
    token_spec: Optional[Spec] = None,
    buf_spec: Optional[Spec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss float32 scalar).

    router: (D, E); wi, wg: (E, D, F); wo: (E, F, D). The B * S tokens are
    routed in ``groups`` groups of batch rows (one group when ``groups``
    does not divide B), each with its own capacity count. ``token_spec``
    ((G, Tg, D)) and ``buf_spec`` ((G, E, C, D)) are the plan's constraint
    points, read when ``x`` is a DTensor.
    """
    B, S, D = x.shape
    E, k = num_experts, top_k
    G = groups if B % max(groups, 1) == 0 else 1
    Tg = (B // G) * S
    C = capacity(Tg, E, k, capacity_factor)
    if isinstance(x, DTensor):
        return _moe_sharded(x, router, wi, wg, wo, E, k, C, Tg,
                            token_spec or spec(None, None, None), buf_spec)
    # no expert is offered more slots than it takes: sort all tokens
    dropless = C >= Tg and takes(x)
    if dropless:
        G, Tg = 1, B * S
        C = Tg
    xg = x.reshape(G, Tg, D)

    with record_function("moe_routing"):
        logits = xg @ router                                # (G, Tg, E)
        weights, ids = top_k_routing(logits, k)             # (G, Tg, k)
        aux = load_balance_loss(logits, ids, E)

    buf, src, w = _dispatch(xg, weights, ids, E, C)
    if dropless:
        y = _combine_sorted(_experts_grouped(buf, wi, wg, wo), src, w, k)
    else:
        y = _combine(_experts(buf, wi, wg, wo), src, w, k)
    return y.reshape(B, S, D), aux


def _dispatch(xg, weights, ids, E: int, C: int):
    """``moe_ffn``'s dispatch of the groups' tokens xg (G, Tg, D), routed
    to ``ids`` (G, Tg, k) at ``weights``: sorted by expert where the
    capacity C takes every token and the grouped products take xg
    (``_dispatch_sorted``; G is 1 there), else into the capacity buffer
    (``_dispatch_capacity``). Returns (buf, src, w), w (G, Tg*k) each
    slot's combine weight in slot order."""
    if C >= xg.shape[1] and takes(xg):
        return _dispatch_sorted(xg[0], weights[0], ids[0], E)
    return _dispatch_capacity(xg, weights, ids, E, C)


class _Gather(torch.autograd.Function):
    """``src.index_select(0, index)`` whose gradient is the gather
    ``g.index_select(0, back)`` summed over runs of ``k`` rows: for a
    permutation (``k`` 1) ``back`` is its inverse; for the dispatch of
    tokens to their k slots in expert order, the slots' inverse order, so
    each token's k slot gradients are summed in slot order, not by
    atomic adds."""

    @staticmethod
    def forward(ctx, src, index, back, k: int):
        ctx.save_for_backward(back)
        ctx.k = k
        return src.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        g = g.index_select(0, back)
        if ctx.k > 1:
            g = g.view(-1, ctx.k, g.shape[-1]).sum(dim=1)
        return g, None, None, None


def _dispatch_sorted(x, weights, ids, E: int):
    """The dropless dispatch of the tokens x (T, D): the T k slots sorted by
    expert (stably, so token-major within an expert), each expert's row
    offsets found on the device, the rows gathered once. Returns ((rows
    (T k, D) in expert order, offs (E + 1,) int32), (order, its inverse),
    w (1, T k) the slots' weights in slot order)."""
    T, D = x.shape
    k = ids.shape[-1]
    with record_function("moe_dispatch"):
        expert, order = torch.sort(ids.reshape(-1), stable=True)
        offs = torch.searchsorted(expert, torch.arange(E + 1, device=x.device),
                                  out_int32=True)
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device))
        xs = _Gather.apply(x, order // k, inv, k)
    _note_load(offs, T * k, E)
    return (xs, offs), (order, inv), weights.reshape(1, T * k)


def _experts_grouped(buf, wi, wg, wo):
    """The expert FFNs on the rows sorted by expert, each expert's segment
    by its own weights (``kernels.grouped_mm``)."""
    xs, offs = buf
    with record_function("moe_experts"):
        h = grouped_mm(xs, wi, offs)
        g = grouped_mm(xs, wg, offs)
        h = h * g * torch.sigmoid(g.float()).to(h.dtype)    # h * silu(g)
        return grouped_mm(h, wo, offs)


def _combine_sorted(ys, src, w, k: int):
    """The sorted rows' outputs ys (T k, D) back in slot order, weighted
    by w (1, T k) and summed over each token's k slots: (T, D)."""
    order, inv = src
    with record_function("moe_dispatch"):
        ys = _Gather.apply(ys, inv, order, 1)
        ys = ys * w.reshape(-1, 1).to(ys.dtype)
        return ys.view(-1, k, ys.shape[-1]).sum(dim=1)


def _dispatch_capacity(xg, weights, ids, E: int, C: int):
    """Scatter the kept slots of the groups' tokens xg (G, Tg, D) routed to
    ``ids`` (G, Tg, k) at ``weights`` into the (G, E, C, D) buffer. Returns
    (buf, src, w): src (G, Tg*k) each slot's row in the flattened
    (G*E*C, D) outputs (a dropped slot's at C - 1), w (G, Tg*k) its
    combine weight (zero when dropped)."""
    G, Tg, D = xg.shape
    k = ids.shape[-1]
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
        base = torch.arange(G, device=xg.device)[:, None] * rows
        dest = base + torch.where(keep, flat_ids * C + pos, E * C)
        tok = torch.arange(Tg * k, device=xg.device) // k   # slot -> token
        xs = xg[:, tok].reshape(G * Tg * k, D)
        buf = xs.new_zeros(G * rows, D).index_copy(0, dest.reshape(-1), xs)
        buf = buf.view(G, rows, D)[:, :E * C].reshape(G, E, C, D)
        src = torch.arange(G, device=xg.device)[:, None] * (E * C) + flat_ids * C + pos
    return buf, src, flat_w * keep


def _experts(buf, wi, wg, wo):
    """The expert FFNs on the (G, E, C, D) buffer."""
    with record_function("moe_experts"):
        h = torch.einsum("gecd,edf->gecf", buf, wi)
        g = torch.einsum("gecd,edf->gecf", buf, wg)
        h = h * g * torch.sigmoid(g.float()).to(h.dtype)    # h * silu(g)
        return torch.einsum("gecf,efd->gecd", h, wo)


def _combine(ye, src, w, k: int):
    """Each slot's row of the expert outputs ye (G, E, C, D) (a dropped
    slot reads position C - 1 at weight 0), weighted, summed over the k
    slots: (G, Tg, D)."""
    G, E, C, D = ye.shape
    with record_function("moe_dispatch"):
        ys = ye.reshape(G * E * C, D).index_select(0, src.reshape(-1)).view(G, -1, D)
        ys = ys * w[..., None].to(ye.dtype)
        return ys.view(G, -1, k, D).sum(dim=2)


def _balance_vectors(logits, ids, E: int):
    """The load-balance loss's mean gate and mean count per expert over the
    tokens of ``logits`` (..., E): (me, ce) float32 (E,)."""
    gates = torch.softmax(logits.float(), dim=-1)
    me = gates.reshape(-1, E).mean(dim=0)
    ce = _one_hot(ids, E).float().sum(dim=-2).reshape(-1, E).mean(dim=0)
    return me, ce


def _moe_sharded(x, router, wi, wg, wo, E: int, k: int, C: int, Tg: int, token_spec: Spec,
                 buf_spec: Optional[Spec]):
    """``moe_ffn``'s global view on DTensors: x (B, S, D), its groups of
    Tg tokens (whole batch rows) split as ``token_spec`` splits (G, Tg, D).
    Routing, dispatch and combine run on each rank's groups; the
    load-balance vectors of the groups (equal in size) are averaged before
    their product."""
    # one group is split over no axis: DTensor cannot drop or move a split
    # singleton dim, which the expert products' views do (on a mesh whose
    # batch axes hold one rank, where one group can take a split)
    b = token_spec[0] if x.shape[0] * x.shape[1] > Tg else None
    rows = spec(b, None, None)

    def route(x, router):
        xg = x.reshape(-1, Tg, x.shape[-1])
        logits = xg @ router
        weights, ids = top_k_routing(logits, k)
        buf, src, w = _dispatch_capacity(xg, weights, ids, E, C)
        me, ce = _balance_vectors(logits, ids, E)
        return buf, src, w, me[None], ce[None]

    per_group = spec(b, None)
    if buf_spec is not None and isinstance(buf_spec[1], str):
        # experts over ``model`` only where they divide it (as the params'
        # specs): an uneven split would fold the capacity dim into the
        # batch groups' split in the expert products (a ``_StridedShard``)
        mesh = x.device_mesh
        if E % mesh.size(mesh.mesh_dim_names.index(buf_spec[1])):
            buf_spec = (buf_spec[0], None) + tuple(buf_spec[2:])
    if buf_spec is not None and b is None:
        buf_spec = (None,) + tuple(buf_spec[1:])
    buf, src, w, me, ce = on_shards(
        route, (x, router), (rows, spec(None, None)),
        (spec(b, None, None, None), per_group, per_group, per_group, per_group))
    ye = constrain(_experts(constrain(buf, buf_spec), wi, wg, wo), buf_spec)
    out = on_shards(lambda ye, src, w: _combine(ye, src, w, k).reshape(-1, x.shape[1], x.shape[2]),
                    (ye, src, w), (spec(b, None, None, None), per_group, per_group), (rows,))
    return out, E * (me.mean(dim=0) * ce.mean(dim=0)).sum()


class _AllMean(torch.autograd.Function):
    """The mean of a replicated value's per-rank parts over ``group``;
    the gradient of each part is the output's over the group's size."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol

        ctx.n = group.size()     # a sum, then / n: gloo has no average
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group)) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_ffn_a2a(
    x: torch.Tensor,
    router: torch.Tensor,
    wi: torch.Tensor,
    wg: torch.Tensor,
    wo: torch.Tensor,
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    mesh,
    batch_axes: Optional[Tuple[str, ...]],
    model_axis: str = "model",
    seq_axis: Optional[str] = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropped-token-bounded MoE with an explicit expert-parallel
    all-to-all over the ``model`` axis of ``mesh`` (a ``DeviceMesh``).

    DTensor inputs are redistributed to tokens on (batch_axes, seq_axis,
    None) and experts on ``model_axis``; plain ones are this rank's tokens
    and experts already. Each rank routes its t tokens, scatters them into
    (E, cap, D) send slabs, cap = max(1, int(cf * t * k / E)) as the
    reference, exchanges them (``all_to_all_single``), runs its E / n
    experts on the n * cap rows it received, exchanges the outputs back and
    combines its tokens. Returns (y, aux), DTensors when ``x`` is one, aux
    a float32 scalar."""
    import torch.distributed._functional_collectives as funcol

    E, k = num_experts, top_k
    n_model = mesh.size(mesh.mesh_dim_names.index(model_axis))
    if E % n_model:
        raise ValueError(f"{E} experts do not split over {n_model} {model_axis!r} ranks")
    model_group = mesh.get_group(model_axis)
    mean_groups = [mesh.get_group(a) for a in (model_axis,) + tuple(batch_axes or ())]

    def local(x_l, router_l, wi_l, wg_l, wo_l):
        b_l, s_l, D = x_l.shape
        cap = max(1, int(capacity_factor * b_l * s_l * k / E))
        xg = x_l.reshape(1, b_l * s_l, D)
        with record_function("moe_routing"):
            logits = xg @ router_l
            weights, ids = top_k_routing(logits, k)
            me, ce = _balance_vectors(logits, ids, E)
            for g in mean_groups:
                me, ce = _AllMean.apply(me, g), _AllMean.apply(ce, g)
            aux = E * (me * ce).sum()
        send, src, w = _dispatch_capacity(xg, weights, ids, E, cap)
        e_loc = E // n_model
        with record_function("moe_exchange"):
            # peer p's slab for our experts lands at rows [p cap, (p+1) cap)
            recv = funcol.all_to_all_single_autograd(send.reshape(E * cap, D), None, None,
                                                     model_group)
            recv = recv.view(n_model, e_loc, cap, D).transpose(0, 1).reshape(
                1, e_loc, n_model * cap, D)
        ye = _experts(recv, wi_l, wg_l, wo_l)
        with record_function("moe_exchange"):
            ye = ye.view(e_loc, n_model, cap, D).transpose(0, 1).reshape(E * cap, D)
            back = funcol.all_to_all_single_autograd(ye, None, None, model_group)
        out = _combine(back.view(1, E, cap, D), src, w, k)
        return out.view(b_l, s_l, D), aux

    bspec = tuple(batch_axes) if batch_axes else None
    x_spec = spec(bspec, seq_axis, None)
    w_spec = spec(model_axis, None, None)
    if not isinstance(x, DTensor):
        return local(x, router, wi, wg, wo)
    return on_shards(local, (x, router, wi, wg, wo),
                     (x_spec, spec(None, None), w_spec, w_spec, w_spec),
                     (x_spec, spec()))
