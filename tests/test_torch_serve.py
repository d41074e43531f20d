"""The serving slice end to end at reduced size on the CPU: publish, refresh,
prefill plus greedy decode, in-place delta publish, refresh, serve again.

The greedy tokens equal those of the same composition of JAX functions
(``M.prefill``, ``make_decode_cache`` with K/V set at ``[:, :, :S]``,
``decode_step``) on the same float32 weights. For hymba-1.5b, whose JAX
prefill returns no SSM state, the JAX side decodes the prompt token by
token instead. For internvl2-76b the request's pixel embeds go before the
prompt in both, and decode starts at vision_prefix + S; with the int8
cache, JAX ``decode_step`` runs on an ``jnp.int8`` cache seeded with the
JAX prefill's K/V through the port's ``quantize_kv`` (the reference has no
int8 prefill path).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced_config as jax_reduced_config
from repro.core.backend import BackendService as JaxBackendService
from repro.core.client import LocalServer as JaxLocalServer
from repro.models import model as JM
from repro.state.checkpoint import CheckpointManager
from repro_torch.bridge import flat_tensors, params_from_numpy, params_to_numpy
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.core.runtime import FunctionRuntime
from repro_torch.core.tensorstate import TensorStore, flatten_with_names
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.state.checkpoint import exact_dirty_blocks

ARCH = "qwen2-1.5b"
B, S, TOKENS = 2, 16, 6


def _weights(seed=0, gain=20.0):
    """JAX-initialized weights, matrices scaled by ``gain`` so that greedy
    decoding does not collapse onto one token at this tiny width."""
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    host = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    host = jax.tree.map(lambda a: a * gain if a.ndim >= 2 else a, host)
    return jcfg, host


def _jax_generate(jcfg, host, prompts: np.ndarray, tokens: int):
    params = jax.tree.map(jnp.asarray, host)
    logits, pc = JM.prefill(jcfg, params, jnp.asarray(prompts), compute_dtype=jnp.float32,
                            q_chunk=0)
    Bq, Sq = prompts.shape
    cache = JM.make_decode_cache(jcfg, Bq, Sq + tokens, jnp.float32)
    cache = {"k": cache["k"].at[:, :, :Sq].set(pc["k"]),
             "v": cache["v"].at[:, :, :Sq].set(pc["v"])}
    tok = jnp.argmax(logits, axis=-1)[:, None]
    out = [np.asarray(tok)]
    for i in range(tokens):
        step, cache = JM.decode_step(jcfg, params, cache, tok, jnp.int32(Sq + i),
                                     compute_dtype=jnp.float32)
        tok = jnp.argmax(step, axis=-1)[:, None]
        out.append(np.asarray(tok))
    return np.asarray(logits), np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def served():
    jcfg, host = _weights()
    cfg = reduced_config(get_config(ARCH))
    run = serve.run(cfg, device="cpu", batch=B, prompt_len=S, tokens=TOKENS, seed=0,
                    compute_dtype=torch.float32, params=params_from_numpy(host, "cpu"))
    return jcfg, cfg, run


def test_greedy_tokens_match_jax_composition(served):
    jcfg, cfg, run = served
    prompts = run.prompts.numpy()
    for params, (logits, toks) in ((run.params_v0, run.out_v0), (run.params_v1, run.out_v1)):
        jlogits, jtoks = _jax_generate(jcfg, params_to_numpy(params), prompts, TOKENS)
        assert toks.shape == (B, TOKENS + 1)
        np.testing.assert_array_equal(toks.numpy(), jtoks)
        np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5,
                                   atol=1e-5 * np.abs(jlogits).max())
    assert len(set(run.out_v0[1].reshape(-1).tolist())) > 1  # not a collapsed run


def test_delta_publish_writes_exactly_the_dirty_blocks(served):
    _, cfg, run = served
    dirty = run.publish_v1.dirty
    old, new = flat_tensors({"params": run.params_v0}), flat_tensors({"params": run.params_v1})
    for name in new:
        assert dirty[name] == exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
    n_dirty = sum(len(v) for v in dirty.values())
    assert 0 < n_dirty < run.publish_v0.stats["blocks_written"]
    assert run.publish_v1.stats["blocks_written"] == n_dirty
    assert set(k for k, v in dirty.items() if v) == {"params/embed", "params/layers/mlp/wi"}


def test_refresh_serves_published_bytes_and_moves_only_dirty_blocks(served):
    _, cfg, run = served
    sl = run.slice
    assert sl.snapshot.stats.versions == 2
    assert sl.snapshot.stats.last_blocks == run.publish_v1.dirty
    host = dict(flatten_with_names(sl.server.params))
    dev = flat_tensors({"params": sl.device_params()})
    for name, want in flat_tensors({"params": run.params_v1}).items():
        assert host[name].tobytes() == want.numpy().tobytes(), name
        assert dev[name].numpy().tobytes() == want.numpy().tobytes(), name


def test_pinned_server_unchanged_by_concurrent_publish():
    """As test_system.py:89-91: a pinned snapshot serves the same answer
    after a concurrent commit, and the new one only after refresh()."""
    jcfg, host = _weights(seed=1)
    cfg = reduced_config(get_config(ARCH))
    sl = serve.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, tokens=2)
    params = params_from_numpy(host, "cpu")
    sl.publish(params)
    sl.refresh()
    prompts = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    first, _ = sl.serve(prompts)
    sl.publish(serve.sparse_update(cfg, params, torch.Generator().manual_seed(3)))
    same, _ = sl.serve(prompts)
    assert torch.equal(first, same)
    sl.refresh()
    after, _ = sl.serve(prompts)
    assert not torch.equal(first, after)


def test_inplace_delta_publish_restores_every_byte():
    """After a sparse change published in place with a kernel-flagged mask,
    every byte of every leaf reads back as the new tree's."""
    cfg = reduced_config(get_config(ARCH))
    gen = torch.Generator().manual_seed(5)
    sl = serve.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, tokens=1,
                          block_bytes=1024)
    v0 = M.init_params(cfg, gen, device="cpu")
    sl.publish(v0)
    v1 = serve.sparse_update(cfg, v0, gen)
    info = sl.publish(v1)
    n_dirty = sum(len(v) for v in info.dirty.values())
    assert n_dirty > 0 and info.stats["blocks_written"] == n_dirty
    out = {}
    FunctionRuntime(sl.boot).invoke(
        lambda fs: out.update(TensorStore(fs, prefix=serve.ROOT).load(serve.NAME)),
        read_only=True)
    want = dict(flatten_with_names(params_to_numpy({"params": v1})))
    assert set(out) == set(want)
    for name, arr in want.items():
        assert out[name].dtype == arr.dtype and out[name].shape == arr.shape
        assert out[name].tobytes() == arr.tobytes(), name


def test_inplace_delta_publish_writes_a_change_whose_square_underflows():
    """A change too small for norm^2 (1e-25 squared underflows float32) is
    still flagged, written and read back byte for byte."""
    cfg = reduced_config(get_config(ARCH))
    sl = serve.ServeSlice(cfg, device="cpu", tokens=1, block_bytes=1024)
    v0 = {"w": torch.zeros(4, 256), "b": torch.zeros(8)}
    sl.publish(v0)
    w = v0["w"].clone()
    w[2, 5] = 1e-25
    v1 = {"w": w, "b": v0["b"]}
    info = sl.publish(v1)
    assert info.dirty == {"params/w": [2], "params/b": []}
    assert info.stats["blocks_written"] == 1
    out = {}
    FunctionRuntime(sl.boot).invoke(
        lambda fs: out.update(TensorStore(fs, prefix=serve.ROOT).load(serve.NAME)),
        read_only=True)
    assert out["params/w"].tobytes() == w.numpy().tobytes()


def test_inplace_delta_publish_writes_changes_the_kernel_statistics_miss():
    """A zero whose sign flips, a NaN whose payload changes and a finite
    value that becomes NaN leave norm^2 at 0 or NaN and q at 0; the exact
    flag flags their blocks, which are written and read back byte for
    byte (ROADMAP.md, Queue 3, fault 5)."""
    cfg = reduced_config(get_config(ARCH))
    sl = serve.ServeSlice(cfg, device="cpu", tokens=1, block_bytes=1024)
    w0 = torch.zeros(5, 256)
    w0[1, 3] = float("nan")
    sl.publish({"w": w0})
    w = w0.clone()
    w[0, 7] = -0.0
    w.view(torch.int32)[1, 3] += 5
    w[3, 255] = float("nan")
    info = sl.publish({"w": w})
    assert info.dirty == {"params/w": [0, 1, 3]}
    assert info.stats["blocks_written"] == 3
    assert info.detect_seconds > 0 and info.detect_seconds <= info.seconds
    out = {}
    FunctionRuntime(sl.boot).invoke(
        lambda fs: out.update(TensorStore(fs, prefix=serve.ROOT).load(serve.NAME)),
        read_only=True)
    assert out["params/w"].tobytes() == w.numpy().tobytes()


def test_reference_checkpoint_delta_save_loses_clean_blocks():
    """Records reference fault 1 (ROADMAP.md, Queue 3): JAX
    ``CheckpointManager`` writes a delta save into a NEW ``step_{n}``
    directory but writes only the dirty blocks there, so a restore reads
    the clean blocks back as zeros. The port publishes in place instead
    (test_inplace_delta_publish_restores_every_byte). When the reference is
    fixed this test fails and the ROADMAP entry goes with it."""
    cm = CheckpointManager(JaxLocalServer(JaxBackendService(block_size=1024)),
                           block_bytes=1024)
    w = np.ones((32, 32), np.float32)
    cm.save(1, {"w": w})
    w2 = w.copy()
    w2[0, 0] = 9.0
    cm.save(2, {"w": w2})
    restored, step = cm.restore({"w": w2})
    assert step == 2
    got = np.asarray(restored["w"])
    assert got[0, 0] == 9.0
    assert np.count_nonzero(got) == 1024 // 4   # the dirty block alone
    assert not np.array_equal(got, w2)


# ------------------------------------------------------------------------- #
# The hybrid family (hymba-1.5b, reduced): prefill seeds the SSM state too
# ------------------------------------------------------------------------- #
HYBRID = "hymba-1.5b"


def _hybrid_weights(seed=0, gain=20.0):
    """JAX-initialized weights with the normal-initialized matrices scaled
    by ``gain`` (A_log, dt_bias, norms and skips keep their values)."""
    jcfg = jax_reduced_config(jax_get_config(HYBRID))
    host = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    for d in JM.param_defs(jcfg):
        if d.init in ("normal", "out_normal"):
            node = host
            for k in d.path[:-1]:
                node = node[k]
            node[d.path[-1]] = node[d.path[-1]] * gain
    return jcfg, host


def _jax_decode_generate(jcfg, host, prompts: np.ndarray, tokens: int):
    """JAX ``decode_step`` over the prompt token by token, then ``tokens``
    greedy steps: the JAX prefill returns no SSM state to continue from."""
    params = jax.tree.map(jnp.asarray, host)
    Bq, Sq = prompts.shape
    cache = JM.make_decode_cache(jcfg, Bq, Sq + tokens, jnp.float32)
    for i in range(Sq):
        logits, cache = JM.decode_step(jcfg, params, cache, jnp.asarray(prompts[:, i:i + 1]),
                                       jnp.int32(i), compute_dtype=jnp.float32)
    tok = jnp.argmax(logits, axis=-1)[:, None]
    out = [np.asarray(tok)]
    for i in range(tokens):
        step, cache = JM.decode_step(jcfg, params, cache, tok, jnp.int32(Sq + i),
                                     compute_dtype=jnp.float32)
        tok = jnp.argmax(step, axis=-1)[:, None]
        out.append(np.asarray(tok))
    return np.asarray(logits), np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def served_hybrid():
    jcfg, host = _hybrid_weights()
    cfg = reduced_config(get_config(HYBRID))
    run = serve.run(cfg, device="cpu", batch=B, prompt_len=S, tokens=TOKENS, seed=0,
                    compute_dtype=torch.float32, params=params_from_numpy(host, "cpu"))
    return jcfg, cfg, run


def test_hybrid_greedy_tokens_match_jax_decode_composition(served_hybrid):
    """Prefill (K/V and SSM state) then greedy decode equals JAX decoding
    the prompt token by token and then greedily: the same tokens, and
    prefill logits within 1e-5 of the largest logit (float32)."""
    jcfg, cfg, run = served_hybrid
    prompts = run.prompts.numpy()
    for params, (logits, toks) in ((run.params_v0, run.out_v0), (run.params_v1, run.out_v1)):
        jlogits, jtoks = _jax_decode_generate(jcfg, params_to_numpy(params), prompts, TOKENS)
        assert toks.shape == (B, TOKENS + 1)
        np.testing.assert_array_equal(toks.numpy(), jtoks)
        np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                                   atol=1e-5 * np.abs(jlogits).max())
    assert len(set(run.out_v0[1].reshape(-1).tolist())) > 1  # not a collapsed run
    assert not torch.equal(run.out_v0[0], run.out_v1[0])    # v1 is served


def test_hybrid_delta_publish_covers_the_ssm_leaf(served_hybrid):
    _, cfg, run = served_hybrid
    dirty = run.publish_v1.dirty
    old, new = flat_tensors({"params": run.params_v0}), flat_tensors({"params": run.params_v1})
    for name in new:
        assert dirty[name] == exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
    assert set(k for k, v in dirty.items() if v) == {
        "params/embed", "params/layers/mlp/wi", "params/layers/ssm/in_proj"}
    assert run.publish_v1.stats["blocks_written"] == sum(len(v) for v in dirty.values())
    dev = flat_tensors({"params": run.slice.device_params()})
    for name, want in new.items():
        assert dev[name].numpy().tobytes() == want.numpy().tobytes(), name


def test_sparse_update_of_a_model_without_mlp_touches_the_ssm():
    """falcon-mamba-7b has no MLP: the update touches ``embed`` and
    ``ssm/in_proj`` only, and the in-place publish writes just those."""
    cfg = reduced_config(get_config("falcon-mamba-7b"))
    gen = torch.Generator().manual_seed(7)
    sl = serve.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, tokens=1,
                          block_bytes=1024)
    v0 = M.init_params(cfg, gen, device="cpu")
    sl.publish(v0)
    info = sl.publish(serve.sparse_update(cfg, v0, gen))
    assert set(k for k, v in info.dirty.items() if v) == {"params/embed",
                                                          "params/layers/ssm/in_proj"}
    assert info.stats["blocks_written"] == sum(len(v) for v in info.dirty.values())


# ------------------------------------------------------------------------- #
# The MoE family (qwen3-moe-30b-a3b, reduced): routed experts, expert blocks
# ------------------------------------------------------------------------- #
MOE = "qwen3-moe-30b-a3b"


def _moe_weights(seed=0, gain=20.0):
    jcfg = jax_reduced_config(jax_get_config(MOE))
    host = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    host = jax.tree.map(lambda a: a * gain if a.ndim >= 2 else a, host)
    return jcfg, host


@pytest.fixture(scope="module")
def served_moe():
    jcfg, host = _moe_weights()
    cfg = reduced_config(get_config(MOE))
    run = serve.run(cfg, device="cpu", batch=B, prompt_len=S, tokens=TOKENS, seed=0,
                    compute_dtype=torch.float32, params=params_from_numpy(host, "cpu"))
    return jcfg, cfg, run


def test_moe_greedy_tokens_match_jax_composition(served_moe):
    """The MoE prefill (the prompt's tokens routed as one group) and decode
    (each step's tokens as one group) give JAX's tokens, and prefill logits
    within 1e-5 of the largest logit (float32)."""
    jcfg, cfg, run = served_moe
    prompts = run.prompts.numpy()
    for params, (logits, toks) in ((run.params_v0, run.out_v0), (run.params_v1, run.out_v1)):
        jlogits, jtoks = _jax_generate(jcfg, params_to_numpy(params), prompts, TOKENS)
        assert toks.shape == (B, TOKENS + 1)
        np.testing.assert_array_equal(toks.numpy(), jtoks)
        np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                                   atol=1e-5 * np.abs(jlogits).max())
    assert len(set(run.out_v0[1].reshape(-1).tolist())) > 1  # not a collapsed run
    assert not torch.equal(run.out_v0[0], run.out_v1[0])    # v1 is served


def test_moe_delta_publish_finds_the_expert_block(served_moe):
    _, cfg, run = served_moe
    dirty = run.publish_v1.dirty
    old, new = flat_tensors({"params": run.params_v0}), flat_tensors({"params": run.params_v1})
    for name in new:
        assert dirty[name] == exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
    assert set(k for k, v in dirty.items() if v) == {"params/embed", "params/layers/moe/wi"}
    assert run.publish_v1.stats["blocks_written"] == sum(len(v) for v in dirty.values())
    host = dict(flatten_with_names(run.slice.server.params))
    dev = flat_tensors({"params": run.slice.device_params()})
    for name, want in new.items():
        assert host[name].tobytes() == want.numpy().tobytes(), name
        assert dev[name].numpy().tobytes() == want.numpy().tobytes(), name


def test_moe_sparse_update_touches_one_expert_of_the_middle_layer():
    """In 1 KiB blocks ``moe/wi`` (2 layers x 4 experts x 64 x 32 float32)
    spans 64 blocks; the update changes 16 input rows of expert 0 of layer
    1, bytes 32,768-34,815, and the in-place publish writes blocks 32 and
    33 of it, found by the block-delta path."""
    cfg = reduced_config(get_config(MOE))
    gen = torch.Generator().manual_seed(7)
    sl = serve.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, tokens=1,
                          block_bytes=1024)
    v0 = M.init_params(cfg, gen, device="cpu")
    sl.publish(v0)
    v1 = serve.sparse_update(cfg, v0, gen)
    changed = (v1["layers"]["moe"]["wi"] != v0["layers"]["moe"]["wi"]).nonzero()
    assert changed[:, :2].unique(dim=0).tolist() == [[1, 0]]
    assert changed[:, 2].unique().tolist() == list(range(16))
    info = sl.publish(v1)
    assert info.dirty["params/layers/moe/wi"] == [32, 33]
    assert set(k for k, v in info.dirty.items() if v) == {"params/embed",
                                                          "params/layers/moe/wi"}
    assert info.stats["blocks_written"] == sum(len(v) for v in info.dirty.values())


# --------------------------------------------------------------------------- #
# The vlm family: a vision prefix before the prompt, bf16/float32 and int8 caches
# --------------------------------------------------------------------------- #
VLM = "internvl2-76b"


def _vlm_weights(seed=0, gain=20.0):
    jcfg = jax_reduced_config(jax_get_config(VLM))
    host = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    host = jax.tree.map(lambda a: a * gain if a.ndim >= 2 else a, host)
    return jcfg, host


def _jax_generate_vlm(jcfg, host, prompts, pixels, tokens, int8):
    params = jax.tree.map(jnp.asarray, host)
    logits, pc = JM.prefill(jcfg, params, jnp.asarray(prompts), pixel_embeds=jnp.asarray(pixels),
                            compute_dtype=jnp.float32, q_chunk=0)
    Bq, n = prompts.shape[0], pixels.shape[1] + prompts.shape[1]
    cache = JM.make_decode_cache(jcfg, Bq, n + tokens, jnp.int8 if int8 else jnp.float32)
    for key in ("k", "v"):
        if int8:
            q8, scale = M.quantize_kv(torch.from_numpy(np.asarray(pc[key])))
            cache[key] = cache[key].at[:, :, :n].set(jnp.asarray(q8.numpy()))
            cache[key + "_scale"] = cache[key + "_scale"].at[:, :, :n].set(
                jnp.asarray(scale.numpy()))
        else:
            cache[key] = cache[key].at[:, :, :n].set(pc[key])
    tok = jnp.argmax(logits, axis=-1)[:, None]
    out = [np.asarray(tok)]
    for i in range(tokens):
        step, cache = JM.decode_step(jcfg, params, cache, tok, jnp.int32(n + i),
                                     compute_dtype=jnp.float32)
        tok = jnp.argmax(step, axis=-1)[:, None]
        out.append(np.asarray(tok))
    return np.asarray(logits), np.concatenate(out, axis=1)


@pytest.mark.parametrize("kv_dtype", [None, torch.int8], ids=["float32", "int8"])
def test_vlm_greedy_tokens_match_jax_composition(kv_dtype):
    """``serve.run`` on the reduced internvl2-76b (float32 compute): the
    pixel embeds drawn from the run's seed, the v0 and v1 greedy tokens and
    prefill logits (1e-5 of the largest) against JAX; the delta publish
    writes exactly the dirty blocks."""
    jcfg, host = _vlm_weights()
    cfg = reduced_config(get_config(VLM))
    run = serve.run(cfg, device="cpu", batch=B, prompt_len=S, tokens=TOKENS, seed=0,
                    compute_dtype=torch.float32, kv_dtype=kv_dtype,
                    params=params_from_numpy(host, "cpu"))
    pixels = serve.request_pixel_embeds(cfg, B, 0, "cpu")
    assert pixels.shape == (B, cfg.vision_prefix, cfg.d_model) and pixels.dtype == torch.bfloat16
    prompts = run.prompts.numpy()
    for params, (logits, toks) in ((run.params_v0, run.out_v0), (run.params_v1, run.out_v1)):
        jlogits, jtoks = _jax_generate_vlm(jcfg, params_to_numpy(params), prompts,
                                           pixels.float().numpy(), TOKENS, kv_dtype is not None)
        assert toks.shape == (B, TOKENS + 1)
        np.testing.assert_array_equal(toks.numpy(), jtoks)
        np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                                   atol=1e-5 * np.abs(jlogits).max())
    assert len(set(run.out_v0[1].reshape(-1).tolist())) > 1  # not a collapsed run
    dirty = run.publish_v1.dirty
    old, new = flat_tensors({"params": run.params_v0}), flat_tensors({"params": run.params_v1})
    for name in new:
        assert dirty[name] == exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
    assert run.publish_v1.stats["blocks_written"] == sum(len(v) for v in dirty.values()) > 0


def test_seed_cache_quantizes_the_prefill_kv_as_decode_does():
    """An int8 cache seeded from a prefill holds ``quantize_kv`` of its K/V
    at [:, :, :S] (scales beyond S stay 1, values 0), within half a scale
    step of the bf16 K/V; a bf16 cache holds them as they are."""
    cfg = reduced_config(get_config(VLM))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    pixels = serve.request_pixel_embeds(cfg, B, 0, "cpu")
    _, pc = M.prefill(cfg, params, prompts, pixel_embeds=pixels)
    n = cfg.vision_prefix + S
    c8 = serve.seed_cache(cfg, pc, B, n + 4, torch.int8, device="cpu")
    c16 = serve.seed_cache(cfg, pc, B, n + 4, torch.bfloat16, device="cpu")
    for key in ("k", "v"):
        q8, scale = M.quantize_kv(pc[key])
        assert torch.equal(c8[key][:, :, :n], q8) and torch.equal(c8[key + "_scale"][:, :, :n],
                                                                  scale)
        assert bool((c8[key][:, :, n:] == 0).all() and (c8[key + "_scale"][:, :, n:] == 1).all())
        err = (q8.float() * scale[..., None] - pc[key].float()).abs()
        assert bool((err <= scale[..., None] * 0.5 * (1 + 1e-6)).all())
        assert torch.equal(c16[key][:, :, :n], pc[key])


def test_launch_serve_takes_kv_dtype_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", VLM, "--reduced",
         "--device", "cpu", "--prompt-len", "16", "--tokens", "4", "--kv-dtype", "int8"],
        capture_output=True, text=True, env=env, cwd=str(root), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "8 pixel embeds + 16+4) with the int8 cache" in out.stdout
