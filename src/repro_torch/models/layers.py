"""Shared building blocks: sharding helpers, norms, RoPE, embeddings, MLP.

Port of ``repro.models.layers``. A sharding spec is the reference's
``PartitionSpec`` as a tuple: one entry per tensor dim, each None, a mesh
axis name, or a tuple of names (the major axis first); ``spec`` builds one
as ``PartitionSpec`` does, a one-name tuple written as the name. A
``DeviceMesh`` with named dims turns it into DTensor placements
(``placements``). Outside a mesh the helpers leave plain tensors as they
are, so the one-device paths run the same ops with or without a plan.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

Spec = Tuple[Any, ...]


# --------------------------------------------------------------------------- #
# Sharding helpers
# --------------------------------------------------------------------------- #
def spec(*axes) -> Spec:
    """A spec as ``PartitionSpec(*axes)`` normalizes it: a one-name tuple
    becomes the name, an empty tuple None."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                 else (None if a == () else a) for a in axes)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(s: Spec, mesh) -> Tuple:
    """DTensor placements over ``mesh`` (its dims named as the spec's
    axes) for the spec ``s``: mesh dim m holds ``Shard(d)`` when tensor dim d
    names m, else ``Replicate()``. A dim split over several axes is split
    over them major first, as ``PartitionSpec``."""
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(s):
        for name in _names(entry):
            m = mesh.mesh_dim_names.index(name)
            if not isinstance(out[m], Replicate):
                raise ValueError(f"mesh axis {name!r} named twice in {s}")
            out[m] = Shard(d)
    return tuple(out)


def constrain(x, s: Optional[Spec]):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to the spec ``s`` (padded with None to its rank); a plain
    tensor, or ``s`` None, is returned as it is, the reference's no-op
    outside a mesh."""
    if s is None or not isinstance(x, DTensor):
        return x
    full = tuple(s) + (None,) * (x.ndim - len(s))
    want = placements(full, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def gather_fsdp(t, keep: Tuple[str, ...] = ("model",)):
    """A weight as a layer uses it under a plan: a DTensor gathered over
    every mesh axis but ``keep`` (the FSDP all-gather; its gradient is
    reduce-scattered back), its tensor-parallel split kept. A plain tensor
    as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    want = tuple(p if name in keep else Replicate()
                 for name, p in zip(mesh.mesh_dim_names, t.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def batch_axes_for(global_batch: int, mesh_axis_sizes: dict) -> Optional[tuple]:
    """Largest prefix of ("pod","data") that evenly divides the batch.

    ``long_500k`` has batch 1 — replicate instead of forcing uneven sharding.
    """
    axes = [a for a in ("pod", "data") if a in mesh_axis_sizes]
    chosen = []
    prod = 1
    for a in axes:
        if global_batch % (prod * mesh_axis_sizes[a]) == 0:
            chosen.append(a)
            prod *= mesh_axis_sizes[a]
    if not chosen:
        return None
    return tuple(chosen)


def on_shards(fn: Callable, args: Sequence, in_specs: Sequence[Optional[Spec]],
              out_specs: Sequence[Spec]):
    """``fn(*args)`` on each rank's shards when ``args[0]`` is a DTensor
    (``local_map``): the DTensor args are redistributed to ``in_specs``
    first (None: a plain argument), ``fn`` runs on their local tensors and
    its outputs are DTensors of ``out_specs``; differentiable both ways
    (the gradient of an input whole along a mesh axis that splits another
    input, or an output, is summed over that axis).
    For the kernels behind ctypes, which take plain tensors: their specs
    put nothing on a dim the kernel reduces over, so nothing is exchanged
    inside. Plain ``args`` call ``fn`` as it is."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    # a placement list per value; a tuple of them for several outputs
    ins = tuple(None if s is None else list(placements(s, mesh)) for s in in_specs)
    outs = tuple(list(placements(s, mesh)) for s in out_specs)
    # an input whole along a mesh axis that splits another input or an
    # output gets a part of its gradient on each rank of that axis: their
    # sum (over one rank, the part itself)
    split = {m for pl in ins + outs if pl for m, p in enumerate(pl)
             if isinstance(p, Shard) and mesh.size(m) > 1}
    grads = tuple(None if pl is None else
                  [Partial() if m in split and isinstance(p, Replicate) else p
                   for m, p in enumerate(pl)] for pl in ins)
    mapped = local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                       in_placements=ins, in_grad_placements=grads,
                       redistribute_inputs=True, device_mesh=mesh)
    return mapped(*args)


# --------------------------------------------------------------------------- #
# The kernels' work, by formula
# --------------------------------------------------------------------------- #
def attended_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs the causal mask (and a sliding ``window``) keeps
    in an S x S attention, per (batch, head)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_flops(q, k, v, *, window: int = 0) -> Tuple[int, int]:
    """(forward, backward) FLOPs of the causal flash kernels on q (B, S, H,
    hd): two products a kept pair forward (Q K^T, P V), five backward
    (Q K^T again, dV, dP, dK, dQ), 2 hd FLOPs each."""
    B, S, H, hd = q.shape
    pairs = B * H * attended_pairs(S, window)
    return 4 * hd * pairs, 10 * hd * pairs


def scan_flops(x, dt, B_, C, A, D) -> Tuple[int, int]:
    """(forward, backward) FLOPs of the selective-scan kernels on x
    (B, S, Di) and a state of N: per state element 7 forward (exp of
    dt A, the products and the sum into y) and 19 backward; per channel 3
    forward (the skip term)."""
    B, S, Di = x.shape
    n = B * S * Di * A.shape[-1]
    return 7 * n + 3 * B * S * Di, 19 * n


def counted_kernel(name: str, fn: Callable, flops: Callable) -> Callable:
    """``fn`` (a kernel's call) as a cost counter that traces it sees it:
    the innermost dispatch mode with a ``kernel_region`` method (``launch.
    cost_analysis.CostMode``) runs ``fn`` and counts its work by
    ``flops(*args)`` in place of the ops it runs; with none, ``fn``."""
    def run(*args):
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

        for mode in reversed(_get_current_dispatch_mode_stack()):
            if hasattr(mode, "kernel_region"):
                return mode.kernel_region(name, fn, args, flops(*args))
        return fn(*args)
    return run


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """QK-norm: normalize over the trailing head_dim. scale: (head_dim,)."""
    return rms_norm(x, scale, eps)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # a Python-scalar base: a tensor made from ``theta`` on a CUDA device
    # would be a host-to-device copy, which waits for the queued work
    return 1.0 / torch.pow(theta, exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    Half-split rotation: the first half of head_dim pairs with the second.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs     # (..., S, hd//2)
    cos = torch.cos(angles)[..., :, None, :]               # (..., S, 1, hd//2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Embedding
# --------------------------------------------------------------------------- #
def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor, compute_dtype,
                 rows: Optional[Spec] = None) -> torch.Tensor:
    """The rows of ``embedding`` (V, D) at ``tokens`` (B, S), in
    ``compute_dtype``. Under a plan (DTensors, ``rows`` the tokens' spec)
    the lookup runs on each rank's tokens with the table whole: torch
    2.11's DTensor has no working rule for the lookup's backward
    (``index_put`` of a replicated table at batch-split indices)."""
    if rows is not None and isinstance(embedding, DTensor):
        return on_shards(lambda e, t: e[t].to(compute_dtype), (embedding, tokens),
                         (spec(None, None), rows), (tuple(rows) + (None,),))
    return embedding[tokens].to(compute_dtype)


# --------------------------------------------------------------------------- #
# Dense SwiGLU MLP
# --------------------------------------------------------------------------- #
def swiglu_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); wi/wg: (D, F); wo: (F, D)."""
    h = x @ wi
    g = x @ wg
    h = h * torch.sigmoid(g.float()).to(h.dtype) * g  # silu(g)*h
    return h @ wo


# --------------------------------------------------------------------------- #
# Chunked cross-entropy
# --------------------------------------------------------------------------- #
def _chunk_nll(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
               mc: torch.Tensor, logits_spec: Optional[Spec] = None) -> torch.Tensor:
    logits = constrain(xc @ head, logits_spec).float()
    if isinstance(logits, DTensor) and _split_over(logits, logits.ndim - 1):
        b = logits_spec[0]
        fn = functools.partial(_vocab_parallel_nll, mesh=logits.device_mesh,
                               vocab=logits.shape[-1])
        rows = on_shards(fn, (logits, lc, mc),
                         (spec(b, None, "model"), spec(b, None), spec(b, None)), (spec(b),))
        return rows.sum()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum((lse - gold) * mc)


def _split_over(t: DTensor, dim: int) -> bool:
    """Whether a mesh axis of more than one rank splits ``dim`` of ``t``."""
    return any(isinstance(p, Shard) and p.dim == dim and t.device_mesh.size(i) > 1
               for i, p in enumerate(t.placements))


class _AllSum(torch.autograd.Function):
    """The sum over ``group`` of each rank's part of a replicated value; each
    part's gradient is the value's."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_nll(logits, labels, mask, *, mesh, vocab: int):
    """Each row's masked NLL from logits (b, c, V / n) whose ``vocab`` the n
    ``model`` ranks of ``mesh`` split (``torch.chunk``'s split), summed over
    c: the log-sum-exp from the ranks' maxima and sums, the gold logit from
    the rank that holds it; no rank gathers the vocab."""
    import torch.distributed._functional_collectives as funcol

    group = mesh.get_group("model")
    n, r = group.size(), mesh.get_local_rank("model")
    V = logits.shape[-1]
    lo = r * -(-vocab // n)
    m = funcol.wait_tensor(funcol.all_reduce(logits.detach().amax(dim=-1), "max", group))
    lse = m + _AllSum.apply((logits - m[..., None]).exp().sum(dim=-1), group).log()
    local = labels - lo
    here = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, local.clamp(0, max(V - 1, 0))[..., None])[..., 0]
    gold = _AllSum.apply(gold * here, group)
    return ((lse - gold) * mask).sum(dim=-1)


def cross_entropy_chunked(
    x: torch.Tensor,
    head: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    *,
    chunk: int = 512,
    logits_spec: Optional[Spec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded CE over sequence chunks, each chunk's logits
    recomputed in the backward pass (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint``).

    x: (B, S, D) final hidden states; head: (D, V); labels/mask: (B, S).
    Returns (sum_nll, sum_mask), float32 scalars. Logits are computed in
    the type of ``x`` and ``head`` and taken to float32; on DTensors they
    are constrained to ``logits_spec`` (the reference's), then gathered
    whole over the vocab for the log-sum-exp and the gold logit.

    The chunks are the reference's, ``n = max(1, S // chunk)`` chunks of
    ``S // n`` positions, and then one more chunk of the positions they
    leave over. The reference drops those last ``S - n * (S // n)``
    positions from the NLL while counting them in ``sum_mask`` (ROADMAP,
    Queue 3): the port covers every position, and where S is a multiple of
    ``chunk`` both sum the same positions.
    """
    B, S, _ = x.shape
    n_chunks = max(1, S // chunk)
    c = S // n_chunks
    bounds = [(i * c, (i + 1) * c) for i in range(n_chunks)]
    if n_chunks * c < S:
        bounds.append((n_chunks * c, S))
    labels, mask = labels.long(), mask.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in bounds:
        args = (x[:, lo:hi], head, labels[:, lo:hi], mask[:, lo:hi], logits_spec)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total, torch.sum(mask)
