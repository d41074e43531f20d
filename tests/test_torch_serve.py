"""The serving slice end to end at reduced size on the CPU: publish, refresh,
prefill plus greedy decode, in-place delta publish, refresh, serve again.

The greedy tokens equal those of the same composition of JAX functions
(``M.prefill``, ``make_decode_cache`` with K/V set at ``[:, :, :S]``,
``decode_step``) on the same float32 weights.
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
