"""Dense decoder: param defs, init, prefill and decode, in PyTorch.

Port of ``repro.models.model`` for the dense family. Parameters are a plain
nested dict of tensors with the reference's layer-stacked names and shapes
(``layers/attn/wq`` is (L, D, H)), so one FaaSFS snapshot loads in either
package. The decoder stack is a Python loop over the stacked layers. The
other families and options raise ``NotImplementedError`` naming the slice
that brings them (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_xla, decode_attention_xla
from repro_torch.models.layers import (
    apply_rope,
    embed_tokens,
    rms_norm,
    rms_norm_headwise,
    swiglu_mlp,
)

PyTree = Dict


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.has_ssm:
        raise NotImplementedError(
            f"{cfg.name}: the ssm and hybrid families come with the ssm_scan slice")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: the MoE family comes with the MoE slice")
    if cfg.vision_prefix:
        raise NotImplementedError(
            f"{cfg.name}: vision-prefix inputs come with the vlm/audio slice")


# --------------------------------------------------------------------------- #
# Param defs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ParamDef:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | out_normal | zeros | ones


def param_defs(cfg: ModelConfig) -> List[ParamDef]:
    _require_dense(cfg)
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    defs: List[ParamDef] = [
        ParamDef(("embed",), (V, D)),
        ParamDef(("final_norm",), (D,), "ones"),
    ]
    if not cfg.tie_embeddings:
        defs.append(ParamDef(("lm_head",), (D, V)))
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
    if cfg.d_ff > 0:
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
        else:
            v = torch.ones(d.shape, dtype=dtype, device=device)
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


def block_fwd(cfg, x, lp, positions, *, q_chunk: int = 0, attn_impl: str = "auto"):
    """One decoder block. Returns (x, (k, v))."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    ap = lp["attn"]
    q, k, v = _qkv(cfg, ap, h, positions)
    out = attention_xla(q, k, v, causal=True, window=cfg.sliding_window,
                        q_chunk=q_chunk, impl=attn_impl)
    x = x + out.reshape(B, S, cfg.q_dim) @ ap["wo"]
    if cfg.d_ff > 0:
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        mp = lp["mlp"]
        x = x + swiglu_mlp(h2, mp["wi"], mp["wg"], mp["wo"])
    return x, (k, v)


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
def forward_hidden(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    q_chunk: int = 0,
    collect_cache: bool = False,
    attn_impl: str = "auto",
):
    """Embed -> blocks -> final norm.

    Returns (hidden (B, S, D), cache (L,B,S,KV,hd)x2 | None). Inference
    only: no rematerialization, no auxiliary loss.
    """
    _require_dense(cfg)
    x = embed_tokens(params["embed"], tokens, compute_dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    layers = _tree_map(lambda p: p.to(compute_dtype), params["layers"])
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = block_fwd(cfg, x, _layer(layers, i), positions,
                              q_chunk=q_chunk, attn_impl=attn_impl)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, caches


def lm_head_weight(cfg: ModelConfig, params: PyTree) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def prefill(
    cfg: ModelConfig,
    params: PyTree,
    tokens: torch.Tensor,
    *,
    compute_dtype=torch.bfloat16,
    q_chunk: int = 1024,
    attn_impl: str = "auto",
):
    """Returns (last-position logits (B, V) float32, cache {"k","v"})."""
    hidden, caches = forward_hidden(
        cfg, params, tokens, compute_dtype=compute_dtype, q_chunk=q_chunk,
        collect_cache=True, attn_impl=attn_impl,
    )
    head = lm_head_weight(cfg, params).to(compute_dtype)
    logits = (hidden[:, -1] @ head).float()
    k, v = caches
    return logits, {"k": k, "v": v}


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def make_decode_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
    *, device: str = "cuda",
) -> PyTree:
    """Zero-initialized decode cache {"k","v"}: (L, B, max_seq, KV, hd)."""
    _require_dense(cfg)
    if dtype == torch.int8:
        raise NotImplementedError("the int8 KV cache comes after the first slice")
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_block(cfg, x, lp, kc, vc, cur_index: int):
    """x: (B,1,D); kc/vc: this layer's (B,S,KV,hd) cache, written in place
    at ``cur_index``. Returns x."""
    B = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    pos = torch.full((B, 1), cur_index, dtype=torch.int32, device=x.device)
    ap = lp["attn"]
    q, k, v = _qkv(cfg, ap, h, pos)
    kc[:, cur_index] = k[:, 0].to(kc.dtype)
    vc[:, cur_index] = v[:, 0].to(vc.dtype)
    out = decode_attention_xla(q.to(kc.dtype), kc, vc, cur_index,
                               window=cfg.sliding_window)
    x = x + out.reshape(B, 1, cfg.q_dim).to(h.dtype) @ ap["wo"]
    if cfg.d_ff > 0:
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        mp = lp["mlp"]
        x = x + swiglu_mlp(h2, mp["wi"], mp["wg"], mp["wo"])
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
    K/V into ``cache`` in place and returns it: the cache is the largest
    decode buffer and a copy per step would double it.
    """
    _require_dense(cfg)
    x = embed_tokens(params["embed"], tokens, compute_dtype)
    layers = _tree_map(lambda p: p.to(compute_dtype), params["layers"])
    for i in range(cfg.num_layers):
        x = _decode_block(cfg, x, _layer(layers, i), cache["k"][i], cache["v"][i],
                          int(cur_index))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = lm_head_weight(cfg, params).to(compute_dtype)
    logits = (x @ head)[:, 0].float()
    return logits, cache
