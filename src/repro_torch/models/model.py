"""Decoder: param defs, init, sharding specs, training loss, prefill and
decode, in PyTorch.

Port of ``repro.models.model`` for every family of ``configs/``: dense,
moe, ssm, hybrid, vlm (a ``vision_prefix`` of pixel embeddings before the
text) and audio. Parameters are a plain nested dict of tensors with the
reference's layer-stacked names and shapes (``layers/attn/wq`` is (L, D, H),
``layers/moe/wi`` (L, E, D, F)), so one FaaSFS snapshot loads in either
package. The decoder stack is a Python loop over the stacked layers.

One table of ``ParamDef`` drives initialization, the abstract trees and the
sharding specs (``param_partition_specs``, the reference's rules, leaf by
leaf). Under a plan the params and activations are DTensors
(``repro_torch.models.runtime``): ``ActSharding`` holds the reference's
activation specs and its constraint points redistribute there; the
attention and scan kernels run on each rank's shards (``on_shards``). With
``NO_SHARDING`` and plain tensors every constraint point returns its input,
so the one-device paths run the ops they ran without a plan.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention_xla, decode_attention_xla
from repro_torch.models.layers import (
    Spec,
    apply_rope,
    attention_flops,
    constrain,
    counted_kernel,
    cross_entropy_chunked,
    embed_tokens,
    gather_fsdp,
    on_shards,
    rms_norm,
    rms_norm_headwise,
    spec,
    swiglu_mlp,
)
from repro_torch.models.moe import moe_ffn, moe_ffn_a2a
from repro_torch.tracing import span

PyTree = Dict


# --------------------------------------------------------------------------- #
# Param defs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ParamDef:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | out_normal | zeros | ones | ssm_A | dt_bias


def param_defs(cfg: ModelConfig) -> List[ParamDef]:
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    defs: List[ParamDef] = [
        ParamDef(("embed",), (V, D), ("vocab", "residual")),
        ParamDef(("final_norm",), (D,), (None,), "ones"),
    ]
    if not cfg.tie_embeddings:
        defs.append(ParamDef(("lm_head",), (D, V), ("residual", "vocab")))
    Lx = (L,)
    lax_ = ("layers",)
    if cfg.has_attention:
        H, KV, hd = cfg.q_dim, cfg.kv_dim, cfg.head_dim
        defs += [
            ParamDef(("layers", "attn", "wq"), Lx + (D, H), lax_ + ("residual", "heads")),
            ParamDef(("layers", "attn", "wk"), Lx + (D, KV), lax_ + ("residual", "kv")),
            ParamDef(("layers", "attn", "wv"), Lx + (D, KV), lax_ + ("residual", "kv")),
            ParamDef(("layers", "attn", "wo"), Lx + (H, D), lax_ + ("heads", "residual"),
                     "out_normal"),
            ParamDef(("layers", "ln1"), Lx + (D,), lax_ + (None,), "ones"),
        ]
        if cfg.qkv_bias:
            defs += [
                ParamDef(("layers", "attn", "bq"), Lx + (H,), lax_ + ("heads",), "zeros"),
                ParamDef(("layers", "attn", "bk"), Lx + (KV,), lax_ + ("kv",), "zeros"),
                ParamDef(("layers", "attn", "bv"), Lx + (KV,), lax_ + ("kv",), "zeros"),
            ]
        if cfg.qk_norm:
            defs += [
                ParamDef(("layers", "attn", "q_norm"), Lx + (hd,), lax_ + (None,), "ones"),
                ParamDef(("layers", "attn", "k_norm"), Lx + (hd,), lax_ + (None,), "ones"),
            ]
    if cfg.has_ssm:
        Di, R, N, K = cfg.d_inner, cfg.dt_rank, cfg.ssm_state, cfg.ssm_conv
        defs += [
            ParamDef(("layers", "ssm", "in_proj"), Lx + (D, 2 * Di), lax_ + ("residual", "dinner")),
            ParamDef(("layers", "ssm", "conv_w"), Lx + (Di, K), lax_ + ("dinner", None)),
            ParamDef(("layers", "ssm", "conv_b"), Lx + (Di,), lax_ + ("dinner",), "zeros"),
            ParamDef(("layers", "ssm", "x_proj"), Lx + (Di, R + 2 * N), lax_ + ("dinner", None)),
            ParamDef(("layers", "ssm", "dt_proj"), Lx + (R, Di), lax_ + (None, "dinner")),
            ParamDef(("layers", "ssm", "dt_bias"), Lx + (Di,), lax_ + ("dinner",), "dt_bias"),
            ParamDef(("layers", "ssm", "A_log"), Lx + (Di, N), lax_ + ("dinner", None), "ssm_A"),
            ParamDef(("layers", "ssm", "D"), Lx + (Di,), lax_ + ("dinner",), "ones"),
            ParamDef(("layers", "ssm", "out_proj"), Lx + (Di, D), lax_ + ("dinner", "residual"),
                     "out_normal"),
        ]
        if cfg.family == "ssm":
            defs.append(ParamDef(("layers", "ln1"), Lx + (D,), lax_ + (None,), "ones"))
    if cfg.family == "hybrid":
        defs += [
            ParamDef(("layers", "attn_branch_norm"), Lx + (D,), lax_ + (None,), "ones"),
            ParamDef(("layers", "ssm_branch_norm"), Lx + (D,), lax_ + (None,), "ones"),
        ]
    if cfg.is_moe:
        E, Fm = cfg.num_experts, cfg.moe_d_ff
        defs += [
            ParamDef(("layers", "moe", "router"), Lx + (D, E), lax_ + ("residual", None)),
            ParamDef(("layers", "moe", "wi"), Lx + (E, D, Fm),
                     lax_ + ("experts", "residual", "expert_ffn")),
            ParamDef(("layers", "moe", "wg"), Lx + (E, D, Fm),
                     lax_ + ("experts", "residual", "expert_ffn")),
            ParamDef(("layers", "moe", "wo"), Lx + (E, Fm, D),
                     lax_ + ("experts", "expert_ffn", "residual"), "out_normal"),
            ParamDef(("layers", "ln2"), Lx + (D,), lax_ + (None,), "ones"),
        ]
    elif cfg.d_ff > 0:
        F = cfg.d_ff
        defs += [
            ParamDef(("layers", "mlp", "wi"), Lx + (D, F), lax_ + ("residual", "ffn")),
            ParamDef(("layers", "mlp", "wg"), Lx + (D, F), lax_ + ("residual", "ffn")),
            ParamDef(("layers", "mlp", "wo"), Lx + (F, D), lax_ + ("ffn", "residual"),
                     "out_normal"),
            ParamDef(("layers", "ln2"), Lx + (D,), lax_ + (None,), "ones"),
        ]
    return defs


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    *,
    device: str = "cuda",
    dtype=torch.float32,
) -> PyTree:
    """Random initialization with the reference's scales, drawn from
    ``generator`` (whose device must be ``device``). The numbers differ
    from ``jax.random``'s; tests carry JAX weights across instead."""
    params: Dict = {}
    for d in param_defs(cfg):
        if d.init in ("normal", "out_normal"):
            std = 0.02 if d.init == "normal" else 0.02 / np.sqrt(2 * cfg.num_layers)
            v = torch.randn(d.shape, generator=generator, dtype=dtype, device=device)
            v.mul_(std)
        elif d.init == "zeros":
            v = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            v = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.init == "ssm_A":
            n = d.shape[-1]
            a = torch.log(torch.arange(1, n + 1, dtype=dtype, device=device))
            v = a.expand(d.shape).contiguous()
        elif d.init == "dt_bias":
            # inverse softplus of dt in [1e-3, 1e-1]
            u = torch.rand(d.shape, generator=generator, dtype=dtype, device=device)
            dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
            v = dt + torch.log(-torch.expm1(-dt))
        else:  # pragma: no cover
            raise ValueError(d.init)
        _set_path(params, d.path, v)
    return params


def cast_params(params: PyTree, compute_dtype) -> PyTree:
    """The tree the forward functions read, cast once: the embedding, head
    and layer weights in ``compute_dtype``, ``final_norm`` as stored.

    Every forward function casts these leaves itself, and a cast to the
    type a tensor already has is free, so serving casts once per snapshot
    version instead of once per call; the numbers are the same (a gather
    of the cast embedding equals the cast of the gather)."""
    out = {k: v for k, v in params.items()}
    out["embed"] = params["embed"].to(compute_dtype)
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(compute_dtype)
    out["layers"] = _tree_map(lambda p: p.to(compute_dtype), params["layers"])
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(layers: PyTree, i: int) -> PyTree:
    return _tree_map(lambda p: p[i], layers)


def _unbind_layers(layers: PyTree, n: int) -> List[PyTree]:
    """The ``n`` per-layer trees of the stacked ``layers``. One ``unbind``
    per leaf: its backward stacks the layers' gradients once, where ``n``
    indexings would each scatter into a zero tensor of the whole stack."""
    per_leaf = _tree_map(lambda p: p.unbind(0), layers)
    return [_tree_map(lambda t, i=i: t[i], per_leaf) for i in range(n)]


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> PyTree:
    """The param tree's shapes and types as tensors on the meta device
    (no storage): the reference's ``ShapeDtypeStruct`` tree."""
    params: Dict = {}
    for d in param_defs(cfg):
        _set_path(params, d.path, torch.empty(d.shape, dtype=dtype, device="meta"))
    return params


def logical_specs(cfg: ModelConfig) -> PyTree:
    specs: Dict = {}
    for d in param_defs(cfg):
        _set_path(specs, d.path, d.logical)
    return specs


def param_partition_specs(
    cfg: ModelConfig,
    rules: Dict[Optional[str], Optional[Any]],
    axis_sizes: Optional[Dict[str, int]] = None,
) -> PyTree:
    """Map logical axes -> mesh axes per ``rules`` (e.g. train FSDP+TP): a
    tree of specs (``layers.spec`` tuples, the reference's
    ``PartitionSpec`` entries).

    Shape-aware: a dim whose size does not divide its mesh axis is left
    unsharded (the reference's jit argument shardings require even
    division), and a mesh axis claimed by two dims of the same tensor goes
    to the earlier dim (e.g. mixtral's E=8 cannot take ``model``=16, so the
    per-expert FFN dim inherits it; qwen3's E=128 can, so the FFN dim is
    dropped).
    """
    specs: Dict = {}
    for d in param_defs(cfg):
        axes = []
        used = set()
        for dim, logical in zip(d.shape, d.logical):
            ax = rules.get(logical, None)
            if ax is None:
                axes.append(None)
                continue
            key = ax if isinstance(ax, tuple) else (ax,)
            total = 1
            for a in key:
                total *= axis_sizes.get(a, 1) if axis_sizes else 1
            if (axis_sizes is not None and dim % total != 0) or any(a in used for a in key):
                axes.append(None)
                continue
            used.update(key)
            axes.append(ax)
        _set_path(specs, d.path, spec(*axes))
    return specs


# --------------------------------------------------------------------------- #
# Activation sharding bundle
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ActSharding:
    """Specs of the activation constraint points (None => unconstrained),
    the reference's fields. ``moe_a2a`` holds ``moe_ffn_a2a``'s mesh
    arguments (mesh, batch_axes, model_axis, seq_axis), None for the
    global-view dispatch."""

    residual: Optional[Spec] = None      # (B, S, D)
    logits: Optional[Spec] = None        # (B, chunk, V) of each CE chunk
    moe_tokens: Optional[Spec] = None    # (G, Tg, D) grouped tokens
    moe_buf: Optional[Spec] = None       # (G, E, C, D) dispatch buffer
    moe_groups: int = 1
    moe_a2a: Optional[Any] = None
    kv_cache: Optional[Spec] = None      # (L, B, S, KV, hd)
    decode_residual: Optional[Spec] = None  # (B, 1, D)

    def res(self, x):
        return constrain(x, self.residual)

    def whole(self, x):
        """``x`` (B, S, ...) with the residual's batch split and its
        sequence whole: the sequence-parallel gather at the input of the
        column-parallel products, so that DTensor folds (B, S) for them
        with only the batch split. The gradient is reduce-scattered back
        to the residual's split. Without a residual spec, ``x``."""
        if self.residual is None:
            return x
        return constrain(x, spec(self.residual[0], None))

    def dres(self, x):
        return constrain(x, self.decode_residual)


NO_SHARDING = ActSharding()


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _kernel_specs(cfg: ModelConfig, shardings: ActSharding, x):
    """Specs of a kernel's (B, S, heads or channels, ...) operands on each
    rank's shards: batch on the plan's batch axes; the per-head (or
    per-channel) dim on ``model`` when every count in ``per_model`` divides
    it; S, which the kernels reduce over, whole."""
    res = shardings.residual or shardings.decode_residual or (None,)
    n = _model_size(x)

    def specs(per_model, *trailing):
        m = "model" if n and all(c % n == 0 for c in per_model) else None
        return spec(res[0], None, m, *trailing), m
    return specs


def _model_size(x) -> int:
    mesh = x.device_mesh
    return mesh.size(mesh.mesh_dim_names.index("model")) if "model" in mesh.mesh_dim_names else 0


def _kv_heads_per_shard(H: int, KV: int, n: int) -> Optional[Tuple[int, int]]:
    """When the query heads split over n ``model`` ranks but the KV heads do
    not: (h, per), rank r's query heads reading the ``per`` KV heads from
    ``r * h // g`` on (g query heads a KV head; a rank's heads cover whole
    groups, or share one KV head); None when the query heads do not split
    either."""
    if not n or H % n or not KV % n:
        return None
    h, g = H // n, H // KV
    if h % g and g % h:
        return None
    return h, max(1, h // g)


def _attention(cfg, q, k, v, shardings, *, q_chunk: int, attn_impl: str):
    """``attention_xla`` (the flash kernel on the card); under a plan on
    each rank's shards: batch on the batch axes and the heads on ``model``
    when the query heads divide it. When the KV heads do not, K and V reach
    each rank whole over the heads and the rank slices the KV heads its
    query heads read (the grouped heads stay grouped; the slice's gradient
    is summed over ``model``); with neither split the heads stay whole."""
    def fn(q, k, v, lo=0, per=0):
        if per:
            k, v = k[:, :, lo:lo + per], v[:, :, lo:lo + per]
        return attention_xla(q, k, v, causal=True, window=cfg.sliding_window,
                             q_chunk=q_chunk, impl=attn_impl)

    if not isinstance(q, DTensor):
        return fn(q, k, v)
    specs = _kernel_specs(cfg, shardings, q)
    s, _ = specs((cfg.num_heads, cfg.num_kv_heads), None)
    sk = s
    kernel = fn
    heads = _kv_heads_per_shard(cfg.num_heads, cfg.num_kv_heads, _model_size(q))
    if heads is not None:
        # sliced on each rank's shard: DTensor's index_select backward on a
        # sharded input keeps the whole shape locally
        # (tests/test_torch_dist_ranks.py pins it)
        h, per = heads
        s, _ = specs((cfg.num_heads,), None)
        sk = spec(s[0], None, None, None)
        r = q.device_mesh.get_local_rank("model")
        kernel = functools.partial(fn, lo=r * h // (cfg.num_heads // cfg.num_kv_heads), per=per)
    flops = functools.partial(attention_flops, window=cfg.sliding_window)
    return on_shards(counted_kernel("flash_attention", kernel, flops), (q, k, v), (s, sk, sk),
                     (s,))


def _split_heads(t, B: int, S: int, heads: int, hd: int):
    """(B, S, heads * hd) -> (B, S, heads, hd). A DTensor whose last dim a
    mesh axis splits other than by whole heads has that axis gathered
    first (DTensor reshapes only even splits)."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.ndim - 1
        want = [Replicate() if isinstance(p, Shard) and p.dim == last
                and heads % mesh.size(i) else p for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(B, S, heads, hd)


class _MergeHeads(torch.autograd.Function):
    """(B, S, heads, hd) -> (B, S, heads * hd) on DTensors, whose gradient
    is split back by ``_split_heads`` (a gradient split over a mesh axis
    other than by whole heads is gathered first)."""

    @staticmethod
    def forward(ctx, t):
        ctx.dims = t.shape
        return t.reshape(*t.shape[:2], -1)

    @staticmethod
    def backward(ctx, g):
        return _split_heads(g, *ctx.dims)


def _merge_heads(t):
    if isinstance(t, DTensor):
        return _MergeHeads.apply(t)
    return t.reshape(*t.shape[:2], -1)


def _qkv(cfg: ModelConfig, ap: Dict, h: torch.Tensor, positions: torch.Tensor):
    B, S, _ = h.shape
    q = h @ ap["wq"]
    k = h @ ap["wk"]
    v = h @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = _split_heads(q, B, S, cfg.num_heads, cfg.head_dim)
    k = _split_heads(k, B, S, cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(v, B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, ap["q_norm"], cfg.norm_eps)
        k = rms_norm_headwise(k, ap["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_branch(cfg, lp, h, positions, shardings, *, q_chunk: int, attn_impl: str):
    ap = lp["attn"]
    with span("block.qkv"):
        q, k, v = _qkv(cfg, ap, h, positions)
    with span("block.attention"):
        out = _attention(cfg, q, k, v, shardings, q_chunk=q_chunk, attn_impl=attn_impl)
    with span("block.out"):
        out = _merge_heads(out) @ ap["wo"]
    return out, {"k": k, "v": v}


def _ssm_branch(cfg, lp, h, shardings, *, scan_impl: str):
    kw = dict(dt_rank=cfg.dt_rank, ssm_state=cfg.ssm_state, impl=scan_impl)
    mixer = None
    if isinstance(h, DTensor):
        mixer = functools.partial(ssm_mod.sharded_mixer, **kw,
                                  specs=_kernel_specs(cfg, shardings, h))
    out, (conv, hs) = ssm_mod.mamba_block(h, lp["ssm"], **kw, return_state=True, mixer=mixer)
    return out, {"conv": conv, "ssm": hs}


def _mix(cfg, lp, attn_out, ssm_out):
    """Hybrid fusion: the mean of the separately normalized branches."""
    return 0.5 * (rms_norm(attn_out, lp["attn_branch_norm"], cfg.norm_eps)
                  + rms_norm(ssm_out, lp["ssm_branch_norm"], cfg.norm_eps))


def _ffn_branch(cfg, lp, h, shardings: ActSharding = NO_SHARDING):
    """The block's feed-forward half on the normed ``h``: (y, aux), aux the
    MoE load-balance term (float32), None for the dense MLP. The tokens are
    routed in ``shardings.moe_groups`` groups (one without a plan), or by
    ``moe_ffn_a2a`` when the plan sets ``moe_a2a``."""
    if cfg.is_moe:
        mp = lp["moe"]
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                  capacity_factor=cfg.capacity_factor)
        if shardings.moe_a2a is not None:
            return moe_ffn_a2a(h, mp["router"], mp["wi"], mp["wg"], mp["wo"], **kw,
                               **shardings.moe_a2a)
        return moe_ffn(h, mp["router"], mp["wi"], mp["wg"], mp["wo"], **kw,
                       groups=shardings.moe_groups, token_spec=shardings.moe_tokens,
                       buf_spec=shardings.moe_buf)
    mp = lp["mlp"]
    return swiglu_mlp(shardings.whole(h), mp["wi"], mp["wg"], mp["wo"]), None


def block_fwd(cfg, x, lp, positions, shardings: ActSharding = NO_SHARDING, *,
              q_chunk: int = 0, attn_impl: str = "auto", scan_impl: str = "auto"):
    """One decoder block. Returns (x, aux, state): the layer's MoE
    load-balance term (a float32 scalar; None without MoE, where the
    reference returns a zero: a zero and its sum per layer cost two
    launches a layer) and its decode state, {"k", "v"} for attention,
    {"conv", "ssm"} for the SSM, both for hybrid. Under a plan the layer's
    weights are gathered here (FSDP), again in a remat recompute."""
    with span("model.block"):
        lp = _tree_map(gather_fsdp, lp)
        # under a plan the branches read the normed residual with its
        # sequence whole, and their outputs (partial sums over ``model``
        # after the row-parallel products) are reduce-scattered back to the
        # residual's split before the add: no product folds a split
        # sequence into a split batch (a ``_StridedShard``)
        with span("block.norm"):
            h = shardings.whole(rms_norm(x, lp["ln1"], cfg.norm_eps))
        if cfg.family == "hybrid":
            attn_out, state = _attn_branch(cfg, lp, h, positions, shardings, q_chunk=q_chunk,
                                           attn_impl=attn_impl)
            with span("block.ssm"):
                ssm_out, ssm_state = _ssm_branch(cfg, lp, h, shardings, scan_impl=scan_impl)
            state.update(ssm_state)
            with span("block.mix"):
                mix = _mix(cfg, lp, shardings.res(attn_out), shardings.res(ssm_out))
        elif cfg.family == "ssm":
            with span("block.ssm"):
                mix, state = _ssm_branch(cfg, lp, h, shardings, scan_impl=scan_impl)
        else:
            mix, state = _attn_branch(cfg, lp, h, positions, shardings, q_chunk=q_chunk,
                                      attn_impl=attn_impl)
        x = shardings.res(x + shardings.res(mix))
        aux = None
        if cfg.is_moe or cfg.d_ff > 0:
            with span("block.norm"):
                h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            with span("block.ffn"):
                y, aux = _ffn_branch(cfg, lp, h, shardings)
            x = shardings.res(x + shardings.res(y))
        return x, aux, state


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
# The products with no batch dimension: x @ W on (B, S, D) x folds to one
# ``mm`` of (B S, D). The attention's and the MoE experts' products are
# ``bmm`` and stay out, as in ``jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable``.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat_policy: Optional[str]):
    """``context_fn`` of ``torch.utils.checkpoint`` for the reference's
    ``remat_policy``: None recomputes the whole layer, "dots" keeps the
    outputs of the products with no batch dimension and recomputes the
    rest (the kernels launched through ctypes included: a dispatch-mode
    policy does not see them, so they run again)."""
    if remat_policy is None:
        return noop_context_fn
    if remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_products)
    raise ValueError(f"remat_policy must be None or 'dots', got {remat_policy!r}")


def forward_hidden(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,
    *,
    pixel_embeds: Optional[torch.Tensor] = None,
    shardings: ActSharding = NO_SHARDING,
    compute_dtype=torch.bfloat16,
    q_chunk: int = 0,
    collect_cache: bool = False,
    remat: bool = True,
    remat_policy: Optional[str] = None,
    attn_impl: str = "auto",
    scan_impl: str = "auto",
):
    """Embed -> blocks -> final norm.

    Returns (hidden (B, S, D), aux_loss, cache | None): the auxiliary loss
    is the float32 sum of the layers' MoE load-balance terms (zero without
    MoE), and the cache holds the layers' decode states stacked on a
    leading L axis (``block_fwd``). For a vlm config, ``pixel_embeds``
    (B, vision_prefix, D) are cast to ``compute_dtype`` and put before the
    token embeddings; the positions run over prefix and text, and S counts
    both.

    With ``remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` (as the reference's ``jax.checkpoint`` per
    scanned layer): only its input is kept, and its forward is recomputed
    in the backward pass. ``remat_policy="dots"`` keeps the outputs of the
    layer's products with no batch dimension as well (``_remat_context``).
    """
    context_fn = _remat_context(remat_policy)
    rows = spec(shardings.residual[0], None) if shardings.residual else None
    with span("model.embed"):
        x = embed_tokens(gather_fsdp(params["embed"]), tokens, compute_dtype, rows)
        if cfg.vision_prefix and pixel_embeds is not None:
            x = torch.cat([pixel_embeds.to(compute_dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None, :]
        x = shardings.res(x)
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    with span("model.cast"):
        layers = _unbind_layers(_tree_map(lambda p: p.to(compute_dtype), params["layers"]),
                                cfg.num_layers)
    impls = dict(q_chunk=q_chunk, attn_impl=attn_impl, scan_impl=scan_impl)
    wrap = remat and torch.is_grad_enabled() and not collect_cache
    states: Dict[str, List[torch.Tensor]] = {}
    for lp in layers:
        if wrap:
            x, aux = checkpoint(
                lambda x_, lp_: block_fwd(cfg, x_, lp_, positions, shardings, **impls)[:2],
                x, lp, use_reentrant=False, context_fn=context_fn)
        else:
            x, aux, state = block_fwd(cfg, x, lp, positions, shardings, **impls)
            if collect_cache:
                for key, t in state.items():
                    states.setdefault(key, []).append(t)
        if aux is not None:
            aux_sum = aux_sum + aux
    with span("model.head"):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = {k: torch.stack(v) for k, v in states.items()} if collect_cache else None
    return x, aux_sum, caches


def lm_head_weight(cfg: ModelConfig, params: PyTree) -> torch.Tensor:
    if cfg.tie_embeddings:
        return gather_fsdp(params["embed"]).T
    return gather_fsdp(params["lm_head"])


def loss_fn(
    cfg: ModelConfig,
    params: PyTree,
    batch: Dict[str, torch.Tensor],
    *,
    shardings: ActSharding = NO_SHARDING,
    compute_dtype=torch.bfloat16,
    aux_weight: float = 0.01,
    q_chunk: int = 0,
    ce_chunk: int = 512,
    remat: bool = True,
    remat_policy: Optional[str] = None,
    attn_impl: str = "auto",
    scan_impl: str = "auto",
):
    """Next-token cross-entropy (+ ``aux_weight`` times the MoE load-balance
    term averaged over the layers). batch: tokens, labels, mask, and for a
    vlm config pixel_embeds, whose prefix positions take no loss. Returns
    (total, {"loss", "aux_loss", "tokens"}), all float32 scalar tensors, as
    the reference's ``loss_fn``. ``attn_impl`` and ``scan_impl`` choose the
    kernels ("auto") or the plain math ("plain") on the card, as in
    ``forward_hidden``."""
    pixels = batch.get("pixel_embeds")
    hidden, aux, _ = forward_hidden(
        cfg, params, batch["tokens"], pixel_embeds=pixels, shardings=shardings,
        compute_dtype=compute_dtype, q_chunk=q_chunk, remat=remat, remat_policy=remat_policy,
        attn_impl=attn_impl, scan_impl=scan_impl,
    )
    with span("model.head"):
        # the head's products are column-parallel (vocab over ``model``):
        # the sequence whole, as at a block's products
        hidden = shardings.whole(hidden)
        if cfg.vision_prefix and pixels is not None:
            hidden = hidden[:, cfg.vision_prefix:]
        head = lm_head_weight(cfg, params).to(compute_dtype)
        nll_sum, n_tok = cross_entropy_chunked(hidden, head, batch["labels"], batch["mask"],
                                               chunk=ce_chunk, logits_spec=shardings.logits)
        loss = nll_sum / torch.clamp(n_tok, min=1.0)
        total = loss + aux_weight * aux / max(cfg.num_layers, 1)
    return total, {"loss": loss, "aux_loss": aux, "tokens": n_tok}


def prefill(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,
    *,
    pixel_embeds: Optional[torch.Tensor] = None,
    shardings: ActSharding = NO_SHARDING,
    compute_dtype=torch.bfloat16,
    q_chunk: int = 1024,
    attn_impl: str = "auto",
    scan_impl: str = "auto",
):
    """Returns (last-position logits (B, V) float32, cache).

    The cache holds "k", "v" (L, B, S, KV, hd) for attention (S counts the
    vision prefix when ``pixel_embeds`` are given) and, unlike
    the reference, whose prefill returns only K/V, also the SSM decode
    state after the prompt: "conv" (L, B, K-1, Di), the last K-1 positions
    of each layer's conv input, and "ssm" (L, B, Di, N) float32, its scan's
    last state. Copied into a ``make_decode_cache`` cache they let decode
    continue after the prompt, as the serving path needs.
    """
    hidden, _, cache = forward_hidden(
        cfg, params, tokens, pixel_embeds=pixel_embeds, shardings=shardings,
        compute_dtype=compute_dtype, q_chunk=q_chunk, collect_cache=True,
        attn_impl=attn_impl, scan_impl=scan_impl,
    )
    with span("model.head"):
        head = lm_head_weight(cfg, params).to(compute_dtype)
        logits = (shardings.whole(hidden)[:, -1] @ head).float()
    if shardings.kv_cache is not None and "k" in cache:
        cache["k"] = constrain(cache["k"], shardings.kv_cache)
        cache["v"] = constrain(cache["v"], shardings.kv_cache)
    return logits, cache


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def make_decode_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    *, device: str = "cuda",
) -> PyTree:
    """Zero-initialized decode cache: "k", "v" (L, B, max_seq, KV, hd) for
    attention; "conv" (L, B, K-1, Di) and "ssm" (L, B, Di, N) float32 for
    the SSM. Unlike the reference, which keeps "conv" in bf16 whatever
    ``dtype`` is, "conv" has ``dtype``: decode writes it in place, and a
    bf16 buffer would round a float32 model's conv state.

    ``dtype=torch.int8`` stores K/V quantized (``quantize_kv``), with
    float32 scales "k_scale", "v_scale" (L, B, max_seq, KV) filled with
    ones, as the reference; "conv" is then bf16, as the reference's."""
    L = cfg.num_layers
    cache: Dict[str, torch.Tensor] = {}
    if cfg.has_attention:
        shape = (L, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
        if dtype == torch.int8:
            sshape = shape[:-1]
            cache["k_scale"] = torch.ones(sshape, dtype=torch.float32, device=device)
            cache["v_scale"] = torch.ones(sshape, dtype=torch.float32, device=device)
    if cfg.has_ssm:
        conv_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
        cache["conv"] = torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.d_inner),
                                    dtype=conv_dtype, device=device)
        cache["ssm"] = torch.zeros((L, batch, cfg.d_inner, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
    return cache


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, kv-head) int8 quantization of K or V (..., hd), as
    the reference's decode: scale = max |t| / 127 over hd, floored at 1e-8;
    q = round(t / scale) (half to even), clipped to +-127. Returns (q int8
    (..., hd), scale float32 (...)). Both divisions are IEEE on every
    device, so the card quantizes as the CPU does: CUDA divides by a Python
    number as a product with its reciprocal, so 127 is a tensor here."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1) / tf.new_full((), 127.0), min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The bf16 K or V that decode attends over: q * scale, rounded."""
    return (q.float() * scale[..., None]).to(torch.bfloat16)


def _decode_attn(cfg, lp, h, cl, cur_index: int, shardings: ActSharding = NO_SHARDING):
    """Attention for one token; writes its K/V into ``cl`` at ``cur_index``.
    With an int8 cache the new K/V are quantized first and the whole layer
    cache is dequantized to bf16 for the attention, as the reference.
    Under a plan the cache's sequence is split over ``model``
    (``kv_cache``): each rank writes and attends its own positions, and the
    softmax is summed over the ranks (``_cache_attention``)."""
    B = h.shape[0]
    pos = torch.full((B, 1), cur_index, dtype=torch.int32, device=h.device)
    ap = lp["attn"]
    q, k, v = _qkv(cfg, ap, h, pos)
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cl else ("k", "v")
    if isinstance(q, DTensor):
        b, cache = shardings.decode_residual[0], tuple(shardings.kv_cache[1:])
        mesh = q.device_mesh
        rows = spec(b, None, None, None)
        fn = functools.partial(_cache_attention, cfg, cur_index=cur_index, names=names,
                               mesh=mesh if "model" in mesh.mesh_dim_names else None,
                               seq=cl["k"].shape[1])
        out = on_shards(fn, (q, k, v) + tuple(cl[n] for n in names),
                        (rows, rows, rows) + (cache, cache, cache[:-1], cache[:-1])[:len(names)],
                        (rows,))
    else:
        out = _cache_attention(cfg, q, k, v, *(cl[n] for n in names), cur_index=cur_index,
                               names=names, mesh=None, seq=cl["k"].shape[1])
    return out.reshape(B, 1, cfg.q_dim).to(h.dtype) @ ap["wo"]


def _cache_attention(cfg, q, k, v, *cache, cur_index: int, names, mesh, seq: int):
    """Write the token's K/V into the layer cache (kc, vc[, k_scale,
    v_scale]) at ``cur_index`` and attend over it. With ``mesh`` the cache
    holds this rank's share of the ``seq`` positions (``torch.chunk``'s
    split over ``model``): the rank holding ``cur_index`` writes, and the
    softmax's maximum, sum and weighted values are summed over the
    ``model`` ranks."""
    cl = dict(zip(names, cache))
    kc, vc = cl["k"], cl["v"]
    lo, group = 0, None
    if mesh is not None and mesh.size(mesh.mesh_dim_names.index("model")) > 1:
        group = mesh.get_group("model")
        lo = mesh.get_local_rank("model") * -(-seq // group.size())
    at = cur_index - lo
    if 0 <= at < kc.shape[1]:
        if "k_scale" in cl:
            for t, c, sc in ((k, kc, cl["k_scale"]), (v, vc, cl["v_scale"])):
                c[:, at], sc[:, at] = quantize_kv(t[:, 0])
        else:
            kc[:, at] = k[:, 0].to(kc.dtype)
            vc[:, at] = v[:, 0].to(vc.dtype)
    if "k_scale" in cl:
        kc = dequantize_kv(kc, cl["k_scale"])
        vc = dequantize_kv(vc, cl["v_scale"])
    if group is None:
        return decode_attention_xla(q.to(kc.dtype), kc, vc, cur_index,
                                    window=cfg.sliding_window)
    return _split_decode_attention(q.to(kc.dtype), kc, vc, cur_index, lo, group,
                                   window=cfg.sliding_window)


def _split_decode_attention(q, kc, vc, cur_index: int, lo: int, group, *, window: int):
    """``decode_attention_xla`` over positions [lo, lo + S_l) of the cache on
    each rank of ``group``: the scores' maximum and the exponentials' sum
    over the ranks, then each rank's probabilities, normalized and rounded
    to the cache's dtype as ``decode_attention_xla`` rounds them, times its
    values in float32, summed over the ranks and rounded once."""
    import torch.distributed._functional_collectives as funcol

    B, _, H, hd = q.shape
    KV = kc.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    k_pos = lo + torch.arange(kc.shape[1], device=q.device)
    ok = k_pos <= cur_index
    if window > 0:
        ok &= k_pos > (cur_index - window)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float() * (1.0 / hd ** 0.5)
    scores = scores.masked_fill(~ok, float("-inf"))
    m = funcol.wait_tensor(funcol.all_reduce(scores.amax(dim=-1, keepdim=True), "max", group))
    p = torch.exp(scores - m)
    den = funcol.wait_tensor(funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group))
    probs = (p / den).to(vc.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), vc.float())
    out = funcol.wait_tensor(funcol.all_reduce(out, "sum", group))
    return out.to(vc.dtype).reshape(B, 1, H, hd)


def _decode_ssm(cfg, lp, h, cl, shardings: ActSharding = NO_SHARDING):
    """One SSM step; writes the new conv and scan state into ``cl``. Under
    a plan the step runs on each rank's channels (``sharded_decode_mixer``)."""
    kw = dict(dt_rank=cfg.dt_rank, ssm_state=cfg.ssm_state)
    mixer = None
    if isinstance(h, DTensor):
        mixer = functools.partial(ssm_mod.sharded_decode_mixer, **kw,
                                  specs=_kernel_specs(cfg, shardings, h))
    out, conv, hs = ssm_mod.mamba_decode_step(h, lp["ssm"], cl["conv"], cl["ssm"], **kw,
                                              mixer=mixer)
    cl["conv"].copy_(conv)
    cl["ssm"].copy_(hs)
    return out


def _decode_block(cfg, x, lp, cl, cur_index: int, shardings: ActSharding = NO_SHARDING):
    """x: (B,1,D); cl: this layer's cache views, written in place. Returns x."""
    lp = _tree_map(gather_fsdp, lp)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        attn_out = _decode_attn(cfg, lp, h, cl, cur_index, shardings)
        mix = _mix(cfg, lp, attn_out, _decode_ssm(cfg, lp, h, cl, shardings))
    elif cfg.family == "ssm":
        mix = _decode_ssm(cfg, lp, h, cl, shardings)
    else:
        mix = _decode_attn(cfg, lp, h, cl, cur_index, shardings)
    x = shardings.dres(x + mix)
    if cfg.is_moe or cfg.d_ff > 0:
        # the step's B tokens are routed as the plan's groups, one without
        x = shardings.dres(
            x + _ffn_branch(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), shardings)[0])
    return x


def decode_step(
    cfg: ModelConfig,
    params: PyTree,
    cache: PyTree,
    tokens: torch.Tensor,
    cur_index: int,
    *,
    shardings: ActSharding = NO_SHARDING,
    compute_dtype=torch.bfloat16,
):
    """One token for every sequence. tokens: (B, 1) -> (logits (B,V), cache).

    Unlike the reference, which returns a new cache, this writes the new
    K/V and SSM state into ``cache`` in place and returns it: the cache is
    the largest decode buffer and a copy per step would double it.
    """
    rows = spec(shardings.decode_residual[0], None) if shardings.decode_residual else None
    x = shardings.dres(embed_tokens(gather_fsdp(params["embed"]), tokens, compute_dtype, rows))
    layers = _tree_map(lambda p: p.to(compute_dtype), params["layers"])
    for i in range(cfg.num_layers):
        cl = {k: c[i] for k, c in cache.items()}
        x = _decode_block(cfg, x, _layer(layers, i), cl, int(cur_index), shardings)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = lm_head_weight(cfg, params).to(compute_dtype)
    logits = (x @ head)[:, 0].float()
    return logits, cache
