"""repro_torch.models.model (dense, moe, ssm and hybrid families) against
repro.models.model.

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
from repro_torch.models import model as M

ARCHS = ["qwen2-1.5b", "granite-3-2b", "deepseek-coder-33b", "minitron-8b",
         "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b", "mixtral-8x7b"]
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
    toks = _tokens(cfg, 2, 32)
    logits, cache = M.prefill(cfg, params, torch.from_numpy(toks).long(),
                              compute_dtype=torch.float32, q_chunk=0)
    jlogits, jcache = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                                 compute_dtype=jnp.float32, q_chunk=0)
    assert logits.shape == (2, cfg.vocab_size) and logits.dtype == torch.float32
    _rel_close(logits, jlogits, F32_REL)
    for key, want in (jcache or {}).items():     # K/V: the reference has no SSM state
        assert cache[key].shape == want.shape
        _rel_close(cache[key], want, F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_q_chunk_matches_unchunked(arch):
    _, cfg, _, params = _setup(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, 32)).long()
    full, _ = M.prefill(cfg, params, toks, compute_dtype=torch.float32, q_chunk=0)
    chunked, _ = M.prefill(cfg, params, toks, compute_dtype=torch.float32, q_chunk=8)
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
    toks = _tokens(cfg, B, S, seed=3)
    logits, _ = M.prefill(cfg, params, torch.from_numpy(toks).long(), q_chunk=0)
    jlogits, _ = JM.prefill(jcfg, jparams, jnp.asarray(toks), q_chunk=0)
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
    either (as in the reference)."""
    _, cfg, _, params = _setup(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    B, S = 1, 8
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=4)).long()
    cache = M.make_decode_cache(cfg, B, S + 1, device="cpu")
    logits_dec = None
    for i in range(S):
        logits_dec, cache = M.decode_step(cfg, params, cache, toks[:, i:i + 1], i)
    logits_pre, _ = M.prefill(cfg, params, toks, q_chunk=0)
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


@pytest.mark.parametrize("arch", ["internvl2-76b"])
def test_other_families_name_their_slice(arch):
    cfg = reduced_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="slice"):
        M.param_defs(cfg)


def test_int8_cache_waits_for_a_later_slice():
    cfg = reduced_config(get_config("qwen2-1.5b"))
    with pytest.raises(NotImplementedError):
        M.make_decode_cache(cfg, 1, 4, torch.int8, device="cpu")


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
