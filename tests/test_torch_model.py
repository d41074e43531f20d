"""repro_torch.models.model (every family of configs/: dense, moe, ssm,
hybrid, vlm, audio) against repro.models.model.

Weights come from the JAX ``M.init_params`` and cross to torch through the
bridge; tokens come from numpy. At ``compute_dtype=float32`` prefill logits,
the prefill K/V cache, decode logits and the decode cache match JAX to 1e-5
relative to the largest value (both run float32 matmuls on the CPU; only
the summation order differs). In bf16 the two frameworks round at different
places (JAX rounds the attention scores of a bf16 einsum and its matmul
outputs in XLA's order, torch in ATen's), so logits are held to BF16_REL of
the largest logit: 2e-2, about four times the largest error seen over these
six configs (5.1e-3 in hymba-1.5b's decode; 3.8e-3 for deepseek-coder-33b
and minitron-8b; 4.4e-3 for the two MoE configs' prefill, whose routing
agrees between the frameworks at these seeds).

The port's prefill also returns the SSM decode state, which the JAX prefill
does not; it is held against the cache JAX ``decode_step`` leaves after the
prompt, token by token, to STATE_REL (1e-5) of the largest value in float32
(seen: at most 5.0e-7).

The vlm config (internvl2-76b) takes ``vision_prefix`` pixel embeddings,
standard normal float32 from a numpy seed, in both packages. The
reference's ``test_prefill_matches_decode`` skips it; here decode after a
vision prefill is held against the JAX prefill over the longer sequence.

The int8 KV cache: the reference's ``test_int8_kv_decode_matches_bf16``
bounds (largest |logit difference| under 0.35, argmax agreement at least
0.5) on the port, and decode with an int8 cache against JAX ``decode_step``
with ``jnp.int8`` in float32 compute: logits and scales to F32_REL of the
largest value, int8 values equal except where the quotient t / scale lies
within 1e-5 of a half-integer, and there one apart: XLA:CPU's division is
not an IEEE division (ROADMAP Queue 3 item 3), as in
``test_torch_block_delta.py``. Seen on these seeds: logits 2.8e-7 and
scales 3.9e-7 apart, every int8 value equal (3,072 K and V values of
musicgen-large, 768 of the others).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import model as M

ARCHS = ["qwen2-1.5b", "granite-3-2b", "deepseek-coder-33b", "minitron-8b",
         "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
         "internvl2-76b", "musicgen-large"]
INT8_ARCHS = ["musicgen-large", "internvl2-76b", "mixtral-8x7b"]
F32_REL = 1e-5
BF16_REL = 2e-2
STATE_REL = 1e-5


def _setup(arch, seed=0):
    jcfg = jax_reduced_config(jax_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    host = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_numpy(host, "cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _pixels(cfg, B, seed=5):
    """A vlm request's pixel embeds (B, vision_prefix, D) float32, or None."""
    if not cfg.vision_prefix:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel_close(got: torch.Tensor, want, rel):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_reference(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    want = {d.path: d.shape for d in JM.param_defs(jcfg)}
    got = {d.path: d.shape for d in M.param_defs(cfg)}
    assert got == want
    gen = torch.Generator().manual_seed(0)
    own = M.init_params(cfg, gen, device="cpu")
    n = sum(p.numel() for p in jax.tree.leaves(params))
    assert n == sum(p.numel() for p in jax.tree.leaves(own)) == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_f32(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    toks, px = _tokens(cfg, 2, 32), _pixels(cfg, 2)
    logits, cache = M.prefill(cfg, params, torch.from_numpy(toks).long(), pixel_embeds=_t(px),
                              compute_dtype=torch.float32, q_chunk=0)
    jlogits, jcache = JM.prefill(jcfg, jparams, jnp.asarray(toks), pixel_embeds=_j(px),
                                 compute_dtype=jnp.float32, q_chunk=0)
    assert logits.shape == (2, cfg.vocab_size) and logits.dtype == torch.float32
    _rel_close(logits, jlogits, F32_REL)
    for key, want in (jcache or {}).items():     # K/V: the reference has no SSM state
        assert cache[key].shape == want.shape
        _rel_close(cache[key], want, F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_q_chunk_matches_unchunked(arch):
    _, cfg, _, params = _setup(arch)
    toks, px = torch.from_numpy(_tokens(cfg, 2, 32)).long(), _t(_pixels(cfg, 2))
    full, _ = M.prefill(cfg, params, toks, pixel_embeds=px, compute_dtype=torch.float32,
                        q_chunk=0)
    chunked, _ = M.prefill(cfg, params, toks, pixel_embeds=px, compute_dtype=torch.float32,
                           q_chunk=8)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_f32(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    B, S = 2, 6
    toks = _tokens(cfg, B, S, seed=2)
    cache = M.make_decode_cache(cfg, B, S, torch.float32, device="cpu")
    jcache = JM.make_decode_cache(jcfg, B, S, jnp.float32)
    for i in range(S):
        logits, cache = M.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                      i, compute_dtype=torch.float32)
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                                         jnp.int32(i), compute_dtype=jnp.float32)
        _rel_close(logits, jlogits, F32_REL)
    assert set(cache) == set(jcache)
    for key, want in jcache.items():
        assert cache[key].shape == want.shape
        _rel_close(cache[key], want, F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_bf16(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    B, S = 4, 16
    toks, px = _tokens(cfg, B, S, seed=3), _pixels(cfg, B)
    logits, _ = M.prefill(cfg, params, torch.from_numpy(toks).long(), pixel_embeds=_t(px),
                          q_chunk=0)
    jlogits, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks), pixel_embeds=_j(px), q_chunk=0)
    _rel_close(logits, jlogits, BF16_REL)
    cache = M.make_decode_cache(cfg, B, S, device="cpu")
    jcache = JM.make_decode_cache(jcfg, B, S)
    for i in range(S):
        dl, cache = M.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]).long(), i)
        jl, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.int32(i))
        _rel_close(dl, jl, BF16_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode(arch):
    """Mirror of test_archs_smoke.test_prefill_matches_decode: decoding a
    prompt token by token ends on the prefill's last logits. Prefill routes
    the prompt's tokens as one group and decode each step's alone, so the
    MoE configs run with capacity_factor E / k, where no slot is dropped in
    either (as in the reference). A vlm prompt's pixel embeds have no
    decode step (the reference skips it): the prefix and the first token
    are prefilled into the cache and the rest decoded after them."""
    _, cfg, _, params = _setup(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    B, S = 1, 8
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=4)).long()
    px = _t(_pixels(cfg, B))
    start, P = (1, cfg.vision_prefix) if px is not None else (0, 0)
    cache = M.make_decode_cache(cfg, B, P + S + 1, device="cpu")
    if start:
        _, pc = M.prefill(cfg, params, toks[:, :start], pixel_embeds=px, q_chunk=0)
        cache = serve.seed_cache(cfg, pc, B, P + S + 1, torch.bfloat16, device="cpu")
    logits_dec = None
    for i in range(start, S):
        logits_dec, cache = M.decode_step(cfg, params, cache, toks[:, i:i + 1], P + i)
    logits_pre, _ = M.prefill(cfg, params, toks, pixel_embeds=px, q_chunk=0)
    np.testing.assert_allclose(logits_dec.numpy(), logits_pre.numpy(), rtol=0.1, atol=0.15)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b", "qwen2-1.5b"])
def test_prefill_state_matches_jax_decode_over_prompt(arch):
    """The port's prefill returns each layer's decode state; it equals the
    cache that JAX ``decode_step`` leaves after the prompt token by token,
    and the prefill logits equal that run's last logits (float32)."""
    jcfg, cfg, jparams, params = _setup(arch)
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=6)
    logits, cache = M.prefill(cfg, params, torch.from_numpy(toks).long(),
                              compute_dtype=torch.float32, q_chunk=0)
    jcache = JM.make_decode_cache(jcfg, B, S, jnp.float32)
    for i in range(S):
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                                         jnp.int32(i), compute_dtype=jnp.float32)
    _rel_close(logits, jlogits, F32_REL)
    assert set(cache) == set(jcache)
    for key, want in jcache.items():
        assert cache[key].shape == want.shape and cache[key].dtype == torch.float32
        _rel_close(cache[key], want, STATE_REL)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_decode_after_vision_prefill_matches_jax_prefill(kv_dtype):
    """internvl2-76b, float32: the prefix and S tokens prefilled, the
    cache seeded (``serve.seed_cache``), token S decoded at position
    vision_prefix + S; its logits against the JAX prefill of the prefix and
    S + 1 tokens, to F32_REL (float32 cache) or BF16_REL (int8 cache: the
    attention runs over K/V dequantized to bf16)."""
    jcfg, cfg, jparams, params = _setup("internvl2-76b")
    B, S, P = 2, 10, cfg.vision_prefix
    toks, px = _tokens(cfg, B, S + 1, seed=7), _pixels(cfg, B)
    tt = torch.from_numpy(toks).long()
    _, pc = M.prefill(cfg, params, tt[:, :S], pixel_embeds=_t(px),
                      compute_dtype=torch.float32, q_chunk=0)
    assert pc["k"].shape == (cfg.num_layers, B, P + S, cfg.num_kv_heads, cfg.head_dim)
    dtype = {"float32": torch.float32, "int8": torch.int8}[kv_dtype]
    cache = serve.seed_cache(cfg, pc, B, P + S + 1, dtype, device="cpu")
    logits, _ = M.decode_step(cfg, params, cache, tt[:, S:], P + S,
                              compute_dtype=torch.float32)
    jlogits, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks), pixel_embeds=_j(px),
                            compute_dtype=jnp.float32, q_chunk=0)
    _rel_close(logits, jlogits, F32_REL if kv_dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_kv_decode_matches_bf16(arch):
    """Twin of tests/models/test_archs_smoke.py::test_int8_kv_decode_matches_bf16
    on the same JAX-initialized weights (key 0), tokens from numpy: the
    reference's bounds."""
    _, cfg, _, params = _setup(arch)
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=8)).long()
    c16 = M.make_decode_cache(cfg, B, S + 1, device="cpu")
    c8 = M.make_decode_cache(cfg, B, S + 1, torch.int8, device="cpu")
    assert c8["k"].dtype == torch.int8 and "k_scale" in c8
    assert c8["k_scale"].shape == c8["k"].shape[:-1] and c8["k_scale"].dtype == torch.float32
    assert bool((c8["k_scale"] == 1).all())
    for i in range(S):
        l16, c16 = M.decode_step(cfg, params, c16, toks[:, i:i + 1], i)
        l8, c8 = M.decode_step(cfg, params, c8, toks[:, i:i + 1], i)
    assert float((l16 - l8).abs().max()) < 0.35
    agree = float((l16.argmax(-1) == l8.argmax(-1)).float().mean())
    assert agree >= 0.5


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_decode_matches_jax(arch, monkeypatch):
    jcfg, cfg, jparams, params = _setup(arch)
    B, S = 2, 12
    toks = _tokens(cfg, B, S, seed=9)
    seen = []      # the K and V each decode step quantizes, per layer: (B, KV, hd)

    def recorded(t):
        seen.append(t.double())
        return quantize(t)

    quantize = M.quantize_kv
    monkeypatch.setattr(M, "quantize_kv", recorded)
    cache = M.make_decode_cache(cfg, B, S, torch.int8, device="cpu")
    jcache = JM.make_decode_cache(jcfg, B, S, jnp.int8)
    for i in range(S):
        logits, cache = M.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                      i, compute_dtype=torch.float32)
        jlogits, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                                         jnp.int32(i), compute_dtype=jnp.float32)
        _rel_close(logits, jlogits, F32_REL)
    assert set(cache) == set(jcache) == {"k", "v", "k_scale", "v_scale"}
    L = cfg.num_layers
    for j, key in enumerate(("k", "v")):
        # (L, B, S, KV, hd), as the cache: step i, layer l quantized K then V
        raw = torch.stack([torch.stack([seen[(i * L + l) * 2 + j] for i in range(S)], dim=1)
                           for l in range(L)])
        got, want = cache[key].int().numpy(), np.asarray(jcache[key]).astype(np.int32)
        assert cache[key].dtype == torch.int8 and got.shape == want.shape == raw.shape
        assert torch.equal(quantize(raw.float())[0], cache[key])
        quot = np.abs((raw / cache[key + "_scale"].double()[..., None]).numpy())
        near_half = np.abs(quot - np.floor(quot) - 0.5) <= 1e-5 * np.maximum(1.0, quot)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and near_half[diff > 0].all(), (key, quot[diff > 0])
        _rel_close(cache[key + "_scale"], jcache[key + "_scale"], F32_REL)


def test_quantize_kv_is_the_reference_formula_in_ieee_arithmetic():
    """``quantize_kv`` against the reference's formula in numpy float32
    (IEEE division; round half to even; clip to +-127; scale floored at
    1e-8): equal, on values that include exact halves, zero rows and the
    clip."""
    r = np.random.default_rng(0)
    t = r.standard_normal((3, 5, 4, 16)).astype(np.float32)
    t[0, 0, 0] = 0.0                                     # zero row: scale 1e-8
    t[0, 1, 0] = np.arange(16, dtype=np.float32) - 7.5   # quotients at .5 boundaries
    t[0, 1, 0, 0] = 127.0
    q, scale = M.quantize_kv(torch.from_numpy(t))
    ws = np.maximum(np.abs(t).max(-1) / np.float32(127.0), np.float32(1e-8))
    wq = np.clip(np.round(t / ws[..., None]), -127, 127).astype(np.int8)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), ws)
    np.testing.assert_array_equal(q.numpy(), wq)
    back = M.dequantize_kv(q, scale)
    assert back.dtype == torch.bfloat16
    assert bool(((back.float() - torch.from_numpy(t)).abs()
                 <= scale[..., None] * 0.5 + torch.from_numpy(np.abs(t)) * 2 ** -8).all())


def test_cast_params_is_idempotent_and_keeps_final_norm():
    _, cfg, _, params = _setup("qwen2-1.5b")
    cast = M.cast_params(params, torch.bfloat16)
    assert cast["final_norm"] is params["final_norm"]
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    again = M.cast_params(cast, torch.bfloat16)
    assert again["layers"]["mlp"]["wi"] is cast["layers"]["mlp"]["wi"]
    toks = torch.from_numpy(_tokens(cfg, 2, 8)).long()
    a, _ = M.prefill(cfg, params, toks, q_chunk=0)
    b, _ = M.prefill(cfg, cast, toks, q_chunk=0)
    assert torch.equal(a, b)
