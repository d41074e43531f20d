"""Decoder: param defs, init, training loss, prefill and decode, in PyTorch.

Port of ``repro.models.model`` for every family of ``configs/``: dense,
moe, ssm, hybrid, vlm (a ``vision_prefix`` of pixel embeddings before the
text) and audio. Parameters are a plain nested dict of tensors with the
reference's layer-stacked names and shapes (``layers/attn/wq`` is (L, D, H),
``layers/moe/wi`` (L, E, D, F)), so one FaaSFS snapshot loads in either
package. The decoder stack is a Python loop over the stacked layers.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention_xla, decode_attention_xla
from repro_torch.models.layers import (
    apply_rope,
    cross_entropy_chunked,
    embed_tokens,
    rms_norm,
    rms_norm_headwise,
    swiglu_mlp,
)
from repro_torch.models.moe import moe_ffn

PyTree = Dict


# --------------------------------------------------------------------------- #
# Param defs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ParamDef:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | out_normal | zeros | ones | ssm_A | dt_bias


def param_defs(cfg: ModelConfig) -> List[ParamDef]:
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    defs: List[ParamDef] = [
        ParamDef(("embed",), (V, D)),
        ParamDef(("final_norm",), (D,), "ones"),
    ]
    if not cfg.tie_embeddings:
        defs.append(ParamDef(("lm_head",), (D, V)))
    if cfg.has_attention:
        H, KV = cfg.q_dim, cfg.kv_dim
        defs += [
            ParamDef(("layers", "attn", "wq"), (L, D, H)),
            ParamDef(("layers", "attn", "wk"), (L, D, KV)),
            ParamDef(("layers", "attn", "wv"), (L, D, KV)),
            ParamDef(("layers", "attn", "wo"), (L, H, D), "out_normal"),
            ParamDef(("layers", "ln1"), (L, D), "ones"),
        ]
        if cfg.qkv_bias:
            defs += [
                ParamDef(("layers", "attn", "bq"), (L, H), "zeros"),
                ParamDef(("layers", "attn", "bk"), (L, KV), "zeros"),
                ParamDef(("layers", "attn", "bv"), (L, KV), "zeros"),
            ]
        if cfg.qk_norm:
            defs += [
                ParamDef(("layers", "attn", "q_norm"), (L, cfg.head_dim), "ones"),
                ParamDef(("layers", "attn", "k_norm"), (L, cfg.head_dim), "ones"),
            ]
    if cfg.has_ssm:
        Di, R, N, K = cfg.d_inner, cfg.dt_rank, cfg.ssm_state, cfg.ssm_conv
        defs += [
            ParamDef(("layers", "ssm", "in_proj"), (L, D, 2 * Di)),
            ParamDef(("layers", "ssm", "conv_w"), (L, Di, K)),
            ParamDef(("layers", "ssm", "conv_b"), (L, Di), "zeros"),
            ParamDef(("layers", "ssm", "x_proj"), (L, Di, R + 2 * N)),
            ParamDef(("layers", "ssm", "dt_proj"), (L, R, Di)),
            ParamDef(("layers", "ssm", "dt_bias"), (L, Di), "dt_bias"),
            ParamDef(("layers", "ssm", "A_log"), (L, Di, N), "ssm_A"),
            ParamDef(("layers", "ssm", "D"), (L, Di), "ones"),
            ParamDef(("layers", "ssm", "out_proj"), (L, Di, D), "out_normal"),
        ]
        if cfg.family == "ssm":
            defs.append(ParamDef(("layers", "ln1"), (L, D), "ones"))
    if cfg.family == "hybrid":
        defs += [
            ParamDef(("layers", "attn_branch_norm"), (L, D), "ones"),
            ParamDef(("layers", "ssm_branch_norm"), (L, D), "ones"),
        ]
    if cfg.is_moe:
        E, Fm = cfg.num_experts, cfg.moe_d_ff
        defs += [
            ParamDef(("layers", "moe", "router"), (L, D, E)),
            ParamDef(("layers", "moe", "wi"), (L, E, D, Fm)),
            ParamDef(("layers", "moe", "wg"), (L, E, D, Fm)),
            ParamDef(("layers", "moe", "wo"), (L, E, Fm, D), "out_normal"),
            ParamDef(("layers", "ln2"), (L, D), "ones"),
        ]
    elif cfg.d_ff > 0:
        F = cfg.d_ff
        defs += [
            ParamDef(("layers", "mlp", "wi"), (L, D, F)),
            ParamDef(("layers", "mlp", "wg"), (L, D, F)),
            ParamDef(("layers", "mlp", "wo"), (L, F, D), "out_normal"),
            ParamDef(("layers", "ln2"), (L, D), "ones"),
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


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _qkv(cfg: ModelConfig, ap: Dict, h: torch.Tensor, positions: torch.Tensor):
    B, S, _ = h.shape
    q = h @ ap["wq"]
    k = h @ ap["wk"]
    v = h @ ap["wv"]
    if cfg.qkv_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, ap["q_norm"], cfg.norm_eps)
        k = rms_norm_headwise(k, ap["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_branch(cfg, lp, h, positions, *, q_chunk: int, attn_impl: str):
    B, S, _ = h.shape
    ap = lp["attn"]
    q, k, v = _qkv(cfg, ap, h, positions)
    out = attention_xla(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=q_chunk, impl=attn_impl)
    return out.reshape(B, S, cfg.q_dim) @ ap["wo"], {"k": k, "v": v}


def _ssm_branch(cfg, lp, h, *, scan_impl: str):
    out, (conv, hs) = ssm_mod.mamba_block(
        h, lp["ssm"], dt_rank=cfg.dt_rank, ssm_state=cfg.ssm_state,
        impl=scan_impl, return_state=True)
    return out, {"conv": conv, "ssm": hs}


def _mix(cfg, lp, attn_out, ssm_out):
    """Hybrid fusion: the mean of the separately normalized branches."""
    return 0.5 * (rms_norm(attn_out, lp["attn_branch_norm"], cfg.norm_eps)
                  + rms_norm(ssm_out, lp["ssm_branch_norm"], cfg.norm_eps))


def _ffn_branch(cfg, lp, h):
    """The block's feed-forward half on the normed ``h``: (y, aux), aux the
    MoE load-balance term (float32), None for the dense MLP. The tokens are
    routed as one group, as with the reference's unsharded ``ActSharding``."""
    if cfg.is_moe:
        mp = lp["moe"]
        return moe_ffn(h, mp["router"], mp["wi"], mp["wg"], mp["wo"],
                       num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                       capacity_factor=cfg.capacity_factor)
    mp = lp["mlp"]
    return swiglu_mlp(h, mp["wi"], mp["wg"], mp["wo"]), None


def block_fwd(cfg, x, lp, positions, *, q_chunk: int = 0, attn_impl: str = "auto",
              scan_impl: str = "auto"):
    """One decoder block. Returns (x, aux, state): the layer's MoE
    load-balance term (a float32 scalar; None without MoE, where the
    reference returns a zero: a zero and its sum per layer cost two
    launches a layer) and its decode state, {"k", "v"} for attention,
    {"conv", "ssm"} for the SSM, both for hybrid."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        attn_out, state = _attn_branch(cfg, lp, h, positions, q_chunk=q_chunk,
                                       attn_impl=attn_impl)
        ssm_out, ssm_state = _ssm_branch(cfg, lp, h, scan_impl=scan_impl)
        state.update(ssm_state)
        mix = _mix(cfg, lp, attn_out, ssm_out)
    elif cfg.family == "ssm":
        mix, state = _ssm_branch(cfg, lp, h, scan_impl=scan_impl)
    else:
        mix, state = _attn_branch(cfg, lp, h, positions, q_chunk=q_chunk,
                                  attn_impl=attn_impl)
    x = x + mix
    aux = None
    if cfg.is_moe or cfg.d_ff > 0:
        y, aux = _ffn_branch(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + y
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
    x = embed_tokens(params["embed"], tokens, compute_dtype)
    if cfg.vision_prefix and pixel_embeds is not None:
        x = torch.cat([pixel_embeds.to(compute_dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    layers = _tree_map(lambda p: p.to(compute_dtype), params["layers"])
    impls = dict(q_chunk=q_chunk, attn_impl=attn_impl, scan_impl=scan_impl)
    wrap = remat and torch.is_grad_enabled() and not collect_cache
    states: Dict[str, List[torch.Tensor]] = {}
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unbind_layers(layers, cfg.num_layers):
        if wrap:
            x, aux = checkpoint(lambda x_, lp_: block_fwd(cfg, x_, lp_, positions, **impls)[:2],
                                x, lp, use_reentrant=False, context_fn=context_fn)
        else:
            x, aux, state = block_fwd(cfg, x, lp, positions, **impls)
            if collect_cache:
                for key, t in state.items():
                    states.setdefault(key, []).append(t)
        if aux is not None:
            aux_sum = aux_sum + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = {k: torch.stack(v) for k, v in states.items()} if collect_cache else None
    return x, aux_sum, caches


def lm_head_weight(cfg: ModelConfig, params: PyTree) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def loss_fn(
    cfg: ModelConfig,
    params: PyTree,
    batch: Dict[str, torch.Tensor],
    *,
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
        cfg, params, batch["tokens"], pixel_embeds=pixels, compute_dtype=compute_dtype,
        q_chunk=q_chunk, remat=remat, remat_policy=remat_policy, attn_impl=attn_impl,
        scan_impl=scan_impl,
    )
    if cfg.vision_prefix and pixels is not None:
        hidden = hidden[:, cfg.vision_prefix:]
    head = lm_head_weight(cfg, params).to(compute_dtype)
    nll_sum, n_tok = cross_entropy_chunked(hidden, head, batch["labels"], batch["mask"],
                                           chunk=ce_chunk)
    loss = nll_sum / torch.clamp(n_tok, min=1.0)
    total = loss + aux_weight * aux / max(cfg.num_layers, 1)
    return total, {"loss": loss, "aux_loss": aux, "tokens": n_tok}


def prefill(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,
    *,
    pixel_embeds: Optional[torch.Tensor] = None,
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
        cfg, params, tokens, pixel_embeds=pixel_embeds, compute_dtype=compute_dtype,
        q_chunk=q_chunk, collect_cache=True, attn_impl=attn_impl, scan_impl=scan_impl,
    )
    head = lm_head_weight(cfg, params).to(compute_dtype)
    logits = (hidden[:, -1] @ head).float()
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


def _decode_attn(cfg, lp, h, cl, cur_index: int):
    """Attention for one token; writes its K/V into ``cl`` at ``cur_index``.
    With an int8 cache the new K/V are quantized first and the whole layer
    cache is dequantized to bf16 for the attention, as the reference."""
    B = h.shape[0]
    pos = torch.full((B, 1), cur_index, dtype=torch.int32, device=h.device)
    ap = lp["attn"]
    q, k, v = _qkv(cfg, ap, h, pos)
    kc, vc = cl["k"], cl["v"]
    if "k_scale" in cl:
        for t, c, sc in ((k, kc, cl["k_scale"]), (v, vc, cl["v_scale"])):
            c[:, cur_index], sc[:, cur_index] = quantize_kv(t[:, 0])
        kc = dequantize_kv(kc, cl["k_scale"])
        vc = dequantize_kv(vc, cl["v_scale"])
    else:
        kc[:, cur_index] = k[:, 0].to(kc.dtype)
        vc[:, cur_index] = v[:, 0].to(vc.dtype)
    out = decode_attention_xla(q.to(kc.dtype), kc, vc, cur_index,
                               window=cfg.sliding_window)
    return out.reshape(B, 1, cfg.q_dim).to(h.dtype) @ ap["wo"]


def _decode_ssm(cfg, lp, h, cl):
    """One SSM step; writes the new conv and scan state into ``cl``."""
    out, conv, hs = ssm_mod.mamba_decode_step(
        h, lp["ssm"], cl["conv"], cl["ssm"], dt_rank=cfg.dt_rank, ssm_state=cfg.ssm_state)
    cl["conv"].copy_(conv)
    cl["ssm"].copy_(hs)
    return out


def _decode_block(cfg, x, lp, cl, cur_index: int):
    """x: (B,1,D); cl: this layer's cache views, written in place. Returns x."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.family == "hybrid":
        attn_out = _decode_attn(cfg, lp, h, cl, cur_index)
        mix = _mix(cfg, lp, attn_out, _decode_ssm(cfg, lp, h, cl))
    elif cfg.family == "ssm":
        mix = _decode_ssm(cfg, lp, h, cl)
    else:
        mix = _decode_attn(cfg, lp, h, cl, cur_index)
    x = x + mix
    if cfg.is_moe or cfg.d_ff > 0:
        # the step's B tokens are routed as one group, as in the reference
        x = x + _ffn_branch(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))[0]
    return x


def decode_step(
    cfg: ModelConfig,
    params: PyTree,
    cache: PyTree,
    tokens: torch.Tensor,
    cur_index: int,
    *,
    compute_dtype=torch.bfloat16,
):
    """One token for every sequence. tokens: (B, 1) -> (logits (B,V), cache).

    Unlike the reference, which returns a new cache, this writes the new
    K/V and SSM state into ``cache`` in place and returns it: the cache is
    the largest decode buffer and a copy per step would double it.
    """
    x = embed_tokens(params["embed"], tokens, compute_dtype)
    layers = _tree_map(lambda p: p.to(compute_dtype), params["layers"])
    for i in range(cfg.num_layers):
        cl = {k: c[i] for k, c in cache.items()}
        x = _decode_block(cfg, x, _layer(layers, i), cl, int(cur_index))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = lm_head_weight(cfg, params).to(compute_dtype)
    logits = (x @ head)[:, 0].float()
    return logits, cache
