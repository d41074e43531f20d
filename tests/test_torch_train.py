"""The port's training slice on the CPU against the JAX package.

JAX and torch run in one process on the same numpy inputs and weights:

* ``cross_entropy_chunked`` where S is a multiple of the chunk (the
  reference's value to 1e-6 relative), and the reference's tail fault;
* ``loss_fn`` value and gradients against ``jax.value_and_grad`` on the
  reduced configs: float32 to 1e-4 of each leaf's largest gradient, bf16
  to 5e-2 (the frameworks round bf16 matmuls at other places); the vlm
  config with pixel embeds from a numpy seed, its loss over the text only;
* ``remat_policy="dots"`` against the reference's ``loss_fn(remat_policy=
  "dots")`` and bit for bit against the port's default remat, with the
  products' outputs kept (no ``mm`` recomputed in the backward);
* one ``make_train_step`` against the reference's step;
* the reference's system tests on the port, the trainer's dirty sets,
  checkpoints crossing between the packages, and the launcher.

The flash backward's plain version is in ``test_torch_flash_bwd.py``, the
checkpoint manager in ``test_torch_checkpoint.py``.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced_config
from repro.core.backend import BackendService as JBackendService
from repro.core.client import LocalServer as JLocalServer
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.runtime import CellPlan as JCellPlan
from repro.models.runtime import make_train_step as jmake_train_step
from repro.optim import adamw as jadamw
from repro.state.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.bridge import flat_tensors, params_from_numpy, params_to_numpy
from repro_torch.configs.base import ShapeCell, get_config, reduced_config
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.runtime import runtime_for
from repro_torch.core.tensorstate import TensorStore, flatten_with_names
from repro_torch.core.types import CachePolicy
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch.train import train_batch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.runtime import (CellPlan, make_decode_step, make_prefill_step,
                                        make_train_step)
from repro_torch.optim import adamw
from repro_torch.serving.engine import SnapshotServer
from repro_torch.state.checkpoint import CheckpointManager
from repro_torch.train.loop import TransactionalTrainer

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
LOSS_GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --------------------------------------------------------------------------- #
# Cross-entropy
# --------------------------------------------------------------------------- #
def _ce_inputs(B, S, D, V, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, D)).astype(np.float32),
            r.standard_normal((D, V)).astype(np.float32),
            r.integers(0, V, (B, S)).astype(np.int32),
            (r.random((B, S)) < 0.9).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (96, 32), (32, 512)])
def test_cross_entropy_matches_reference_where_chunks_cover(S, chunk):
    x, head, labels, mask = _ce_inputs(2, S, 8, 11)
    want_nll, want_n = JL.cross_entropy_chunked(*(jnp.asarray(a) for a in (x, head, labels, mask)),
                                                chunk=chunk)
    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(head).requires_grad_(True)
    nll, n = L.cross_entropy_chunked(xt, ht, torch.from_numpy(labels), torch.from_numpy(mask),
                                     chunk=chunk)
    assert float(n) == float(want_n)
    assert float(nll.detach()) == pytest.approx(float(want_nll), rel=1e-6)
    gx, gh = torch.autograd.grad(nll, (xt, ht))
    jgx, jgh = jax.grad(lambda a, b: JL.cross_entropy_chunked(
        a, b, jnp.asarray(labels), jnp.asarray(mask), chunk=chunk)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    assert _rel_err(gx, jgx) <= 1e-5 and _rel_err(gh, jgh) <= 1e-5


def test_cross_entropy_covers_the_tail_the_reference_drops():
    """B 2, S 50, D 8, V 11, chunk 16, numpy seed 0: the reference sums the
    NLL of the first 48 positions of each row but counts all 50 in n_tok;
    the port sums all 50."""
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 50, 8)).astype(np.float32)
    head = r.standard_normal((8, 11)).astype(np.float32)
    labels = r.integers(0, 11, (2, 50)).astype(np.int32)
    mask = np.ones((2, 50), np.float32)
    logits = (x @ head).astype(np.float64)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    nll = lse - np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    jnll, jn = JL.cross_entropy_chunked(*(jnp.asarray(a) for a in (x, head, labels, mask)),
                                        chunk=16)
    tnll, tn = L.cross_entropy_chunked(*(torch.from_numpy(a) for a in (x, head, labels, mask)),
                                       chunk=16)
    assert float(jn) == float(tn) == 100.0
    assert float(jnll) == pytest.approx(nll[:, :48].sum(), rel=1e-5)      # 348.662
    assert float(tnll) == pytest.approx(nll.sum(), rel=1e-5)              # 365.538
    assert float(jnll) == pytest.approx(348.662, abs=1e-3)
    assert float(tnll) == pytest.approx(365.538, abs=1e-3)


# --------------------------------------------------------------------------- #
# loss_fn and the train step
# --------------------------------------------------------------------------- #
def _setup(arch, seed=0, **overrides):
    jcfg = jreduced_config(jget_config(arch), **overrides)
    cfg = reduced_config(get_config(arch), **overrides)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    host = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, host


def _batch(cfg, B=2, S=32, step=0):
    """synth_batch, and pixel embeds for a vlm config (``train_batch``)."""
    return train_batch(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B),
                       step)


def _torch_batch(batch):
    out = {"tokens": torch.from_numpy(batch["tokens"]).long(),
           "labels": torch.from_numpy(batch["labels"]).long(),
           "mask": torch.from_numpy(batch["mask"])}
    if "pixel_embeds" in batch:
        out["pixel_embeds"] = torch.from_numpy(batch["pixel_embeds"])
    return out


def _torch_loss_and_grads(cfg, host, batch, **kw):
    params = params_from_numpy(host, "cpu")
    flat = flat_tensors(params)
    for t in flat.values():
        t.requires_grad_(True)
    total, metrics = M.loss_fn(cfg, params, _torch_batch(batch), **kw)
    grads = torch.autograd.grad(total, list(flat.values()))
    return total, metrics, dict(zip(flat, grads))


@pytest.mark.parametrize("arch,dtype", [("qwen2-1.5b", "float32"), ("qwen2-1.5b", "bfloat16"),
                                        ("hymba-1.5b", "float32"),
                                        ("falcon-mamba-7b", "float32"),
                                        ("qwen3-moe-30b-a3b", "float32"),
                                        ("mixtral-8x7b", "float32"),
                                        ("internvl2-76b", "float32"),
                                        ("internvl2-76b", "bfloat16"),
                                        ("musicgen-large", "float32"),
                                        ("granite-3-2b", "float32"),
                                        ("granite-3-2b", "bfloat16"),
                                        ("deepseek-coder-33b", "float32"),
                                        ("deepseek-coder-33b", "bfloat16"),
                                        ("minitron-8b", "float32"),
                                        ("minitron-8b", "bfloat16")])
def test_loss_fn_value_and_grads_match_jax(arch, dtype):
    jcfg, cfg, jparams, host = _setup(arch)
    batch = _batch(cfg)
    tdt, jdt, _ = DTYPES[dtype]
    (jtotal, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                             compute_dtype=jdt, ce_chunk=16), has_aux=True)(jparams)
    total, metrics, grads = _torch_loss_and_grads(cfg, host, batch, compute_dtype=tdt,
                                                  ce_chunk=16)
    tol = LOSS_GRAD_TOL[dtype]
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    if cfg.is_moe:   # the load-balance term summed over the layers, float32
        aux = float(metrics["aux_loss"].detach())
        assert aux == pytest.approx(float(jmetrics["aux_loss"]), rel=1e-5) and aux > 0.0
    else:
        assert float(metrics["aux_loss"]) == float(jmetrics["aux_loss"]) == 0.0
    assert float(total.detach()) == pytest.approx(float(jtotal),
                                                  rel=1e-5 if dtype == "float32" else 1e-2)
    jflat = dict(flatten_with_names(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(grads)
    for name, g in grads.items():
        err = _rel_err(g, jflat[name])
        assert err <= tol, (name, err)


def test_remat_on_equals_remat_off():
    _, cfg, _, host = _setup("qwen2-1.5b")
    batch = _batch(cfg)
    on = _torch_loss_and_grads(cfg, host, batch, compute_dtype=torch.float32, remat=True)
    off = _torch_loss_and_grads(cfg, host, batch, compute_dtype=torch.float32, remat=False)
    assert torch.equal(on[0], off[0])
    for name in on[2]:
        assert torch.equal(on[2][name], off[2][name]), name


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "internvl2-76b"])
def test_remat_policy_dots_matches_jax(arch):
    """float32 gradients of ``loss_fn(remat_policy="dots")`` in both
    packages, to LOSS_GRAD_TOL of each leaf's largest."""
    jcfg, cfg, jparams, host = _setup(arch)
    batch = _batch(cfg)
    (jtotal, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                             compute_dtype=jnp.float32, ce_chunk=16, remat_policy="dots"),
        has_aux=True)(jparams)
    total, _, grads = _torch_loss_and_grads(cfg, host, batch, compute_dtype=torch.float32,
                                            ce_chunk=16, remat_policy="dots")
    assert float(total.detach()) == pytest.approx(float(jtotal), rel=1e-5)
    jflat = dict(flatten_with_names(jax.tree.map(np.asarray, jgrads)))
    for name, g in grads.items():
        assert _rel_err(g, jflat[name]) <= LOSS_GRAD_TOL["float32"], name


class _MmCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b", "qwen3-moe-30b-a3b",
                                  "internvl2-76b"])
def test_remat_policy_dots_equals_default_remat_and_keeps_the_products(arch):
    """The same loss and gradients, bit for bit, with "dots" and with the
    whole layer recomputed; and the backward of "dots" recomputes no
    product with no batch dimension: its backward runs two ``mm`` for each
    of the forward's (the gradients of input and weight) and the CE
    chunks' recompute, nothing else, while the default's backward runs the
    layers' products again (all but each layer's last, whose output no
    backward needs: the recompute stops early)."""
    _, cfg, _, host = _setup(arch)
    batch = _torch_batch(_batch(cfg))
    runs = {}
    for policy in (None, "dots"):
        params = params_from_numpy(host, "cpu")
        flat = flat_tensors(params)
        for t in flat.values():
            t.requires_grad_(True)
        with _MmCount() as fwd:
            total, _ = M.loss_fn(cfg, params, batch, compute_dtype=torch.float32, ce_chunk=16,
                                 remat_policy=policy)
        with _MmCount() as bwd:
            grads = torch.autograd.grad(total, list(flat.values()))
        runs[policy] = (total, dict(zip(flat, grads)), fwd.mm, bwd.mm)
    (t0, g0, f0, b0), (t1, g1, f1, b1) = runs[None], runs["dots"]
    assert torch.equal(t0, t1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    n_ce = 2      # the CE head's products, one a chunk, recomputed in both
    assert f0 == f1 and b1 == 2 * f1 + n_ce and b0 > b1, (f0, b0, b1)


def _jax_state(jparams):
    return {"params": jparams, "opt": jadamw.init_opt_state(jparams)}


def test_train_step_f32_matches_reference():
    """The body of the reference's ``make_train_step`` with a float32
    ``loss_fn`` (its builder fixes bf16) against the port's builder with
    ``compute_dtype=float32``: loss to 1e-5; params to 1e-6 wherever the
    gradient is above 1e-3 of its leaf's largest (AdamW's first step is
    +-lr where g is at rounding level, so a flipped sign there is no fault)."""
    jcfg, cfg, jparams, host = _setup("qwen2-1.5b")
    batch = _batch(cfg)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb, compute_dtype=jnp.float32, ce_chunk=16),
        has_aux=True)(jparams)
    jp, jopt, _ = jadamw.adamw_update(opt_cfg, jparams, jg, jadamw.init_opt_state(jparams))
    state = params_from_numpy({"params": host, "opt": jax.tree.map(
        np.asarray, jadamw.init_opt_state(jparams))}, "cpu")
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 32, 2), ce_chunk=16,
                                    compute_dtype=torch.float32), opt_cfg)
    new, metrics = step(state, batch)
    assert metrics["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert isinstance(metrics["loss"], float) and isinstance(metrics["grad_norm"], float)
    gflat = dict(flatten_with_names(jax.tree.map(np.asarray, jg)))
    jflat = dict(flatten_with_names(jax.tree.map(np.asarray, jp)))
    for name, t in flat_tensors(new["params"]).items():
        g = np.abs(gflat[name])
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(t.numpy()[big], jflat[name][big], rtol=0, atol=1e-6,
                                   err_msg=name)
    assert int(new["opt"]["count"]) == int(jopt["count"]) == 1
    # the old state is not written
    assert int(state["opt"]["count"]) == 0
    assert torch.equal(state["params"]["embed"], torch.from_numpy(host["embed"]))


def test_train_step_bf16_matches_reference_step():
    """Both packages' ``make_train_step`` (bf16 compute): loss to 1e-2,
    grad norm to 5e-2 (bf16 matmuls round at other places)."""
    jcfg, cfg, jparams, host = _setup("qwen2-1.5b")
    batch = _batch(cfg)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    jplan = JCellPlan(jcfg, JShapeCell("t", "train", 32, 2), None, {}, JM.NO_SHARDING, 0, 16)
    _, jm = jmake_train_step(jplan, opt_cfg)(_jax_state(jparams),
                                             {k: jnp.asarray(v) for k, v in batch.items()})
    state = params_from_numpy({"params": host, "opt": jax.tree.map(
        np.asarray, jadamw.init_opt_state(jparams))}, "cpu")
    _, m = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 32, 2), ce_chunk=16),
                           opt_cfg)(state, batch)
    assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-2)
    assert m["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=5e-2)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)


def test_prefill_and_decode_steps_run_the_model():
    """The step builders' prefill and decode are the model's, with the
    plan's compute type (and prefill's q_chunk of 1024 where the plan has 0)."""
    _, cfg, _, host = _setup("qwen2-1.5b")
    params = params_from_numpy(host, "cpu")
    plan = CellPlan(cfg, ShapeCell("p", "prefill", 32, 2), compute_dtype=torch.float32)
    toks = torch.from_numpy(_batch(cfg)["tokens"]).long()
    logits, cache = make_prefill_step(plan)(params, {"tokens": toks})
    want, want_cache = M.prefill(cfg, params, toks, compute_dtype=torch.float32)
    assert torch.equal(logits, want) and torch.equal(cache["k"], want_cache["k"])
    caches = []
    for _ in range(2):
        c = M.make_decode_cache(cfg, 2, 33, torch.float32, device="cpu")
        c["k"][:, :, :32], c["v"][:, :, :32] = cache["k"], cache["v"]
        caches.append(c)
    nxt = logits.argmax(-1, keepdim=True)
    got, _ = make_decode_step(plan)(params, caches[0], {"tokens": nxt, "cur_index": 32})
    want, _ = M.decode_step(cfg, params, caches[1], nxt, 32, compute_dtype=torch.float32)
    assert torch.equal(got, want) and torch.equal(caches[0]["k"], caches[1]["k"])


def test_cell_plan_kv_dtype_makes_the_decode_cache():
    """``make_decode_cache(plan)``: the cell's (global batch, seq_len) cache
    in ``plan.kv_dtype`` (int8, with scales), else in the compute type; the
    step builder's decode runs on either."""
    from repro_torch.models.runtime import make_decode_cache
    _, cfg, _, host = _setup("internvl2-76b")
    params = params_from_numpy(host, "cpu")
    shape = ShapeCell("d", "decode", 16, 2)
    plain = make_decode_cache(CellPlan(cfg, shape, compute_dtype=torch.float32), "cpu")
    assert set(plain) == {"k", "v"} and plain["k"].dtype == torch.float32
    assert plain["k"].shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads, cfg.head_dim)
    plan = CellPlan(cfg, shape, compute_dtype=torch.float32, kv_dtype=torch.int8)
    cache = make_decode_cache(plan, "cpu")
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].shape == plain["k"].shape[:-1]
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :1]).long()
    got, _ = make_decode_step(plan)(params, cache, {"tokens": toks, "cur_index": 0})
    want, _ = M.decode_step(cfg, params, M.make_decode_cache(cfg, 2, 16, torch.int8, device="cpu"),
                            toks, 0, compute_dtype=torch.float32)
    assert torch.equal(got, want) and bool(cache["k_scale"][:, :, 0].ne(1).any())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
def test_ssm_families_train_on_the_cpu(arch):
    _, cfg, _, host = _setup(arch)
    state = params_from_numpy({"params": host}, "cpu")
    state["opt"] = adamw.init_opt_state(state["params"])
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 32, 2), ce_chunk=16,
                                    compute_dtype=torch.float32), adamw.AdamWConfig())
    new, m = step(state, _batch(cfg))
    assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert not torch.equal(new["params"]["layers"]["ssm"]["in_proj"],
                           state["params"]["layers"]["ssm"]["in_proj"])


def test_state_crosses_the_bridge_with_its_count():
    _, _, jparams, _ = _setup("qwen2-1.5b")
    jstate = jax.tree.map(np.asarray, _jax_state(jparams))
    jstate["opt"]["count"] = np.asarray(7, np.int32)
    t = params_from_numpy(jstate, "cpu")
    assert t["opt"]["count"].dtype == torch.int32 and t["opt"]["count"].shape == ()
    back = params_to_numpy(t)
    for (n, a), (m, b) in zip(flatten_with_names(jstate), flatten_with_names(back)):
        assert n == m and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), n


def test_moe_state_crosses_the_bridge_both_ways():
    """The MoE training state, JAX-initialized, crosses to torch and back
    bit-identical under the reference's leaf names, and a torch-initialized
    one crosses to numpy and back bit-identical too."""
    jcfg, cfg, jparams, _ = _setup("qwen3-moe-30b-a3b")
    jstate = jax.tree.map(np.asarray, _jax_state(jparams))
    t = params_from_numpy(jstate, "cpu")
    assert t["params"]["layers"]["moe"]["wi"].shape == (2, 4, 64, 32)
    back = params_to_numpy(t)
    names = [n for n, _ in flatten_with_names(jstate)]
    assert {"params/layers/moe/router", "params/layers/moe/wi", "params/layers/moe/wg",
            "params/layers/moe/wo", "opt/m/layers/moe/wi"} <= set(names)
    for (n, a), (m, b) in zip(flatten_with_names(jstate), flatten_with_names(back)):
        assert n == m and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), n
    own = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    again = flat_tensors(params_from_numpy(params_to_numpy(own), "cpu"))
    assert sorted(again) == sorted(n for n, _ in flatten_with_names(jparams))
    for name, t in flat_tensors(own).items():
        assert torch.equal(again[name].view(torch.int32), t.view(torch.int32)), name


# --------------------------------------------------------------------------- #
# tests/test_system.py on the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_setup():
    cfg = reduced_config(get_config("qwen2-1.5b"), num_layers=2, d_model=32, d_ff=64,
                         vocab_size=64)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    plan = CellPlan(cfg, ShapeCell("t", "train", 32, 4), q_chunk=0, ce_chunk=16)
    step = make_train_step(plan, adamw.AdamWConfig(lr_peak=3e-3, warmup_steps=2,
                                                   decay_steps=50))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    return cfg, state, step, dcfg


def np_state(state):
    return params_to_numpy(state)


def test_full_stack_train_checkpoint_serve(tiny_setup):
    cfg, state0, step_fn, dcfg = tiny_setup
    be = BackendService(block_size=4096, policy=CachePolicy.EAGER)
    local = LocalServer(be)
    trainer = TransactionalTrainer(local, step_fn, state0, device="cpu")
    trainer.init(state0)

    losses = []
    for i in range(4):
        res = trainer.step(synth_batch(dcfg, i))
        losses.append(res.metrics["loss"])
        assert res.attempts >= 1
    assert losses[-1] < losses[0]

    cm = CheckpointManager(local)
    final = trainer.read_state()
    info = cm.save(4, final)
    assert info.bytes_written > 0
    restored, step = cm.restore(np_state(state0))
    assert step == 4
    np.testing.assert_array_equal(restored["params"]["embed"],
                                  final["params"]["embed"].numpy())

    def decode_fn(state, batch):
        params = params_from_numpy(state["params"], "cpu")
        logits, _ = M.prefill(cfg, params, torch.as_tensor(batch).long(), q_chunk=0)
        return logits.numpy()

    srv = SnapshotServer(LocalServer(be), decode_fn, np_state(state0))
    srv.refresh()
    toks = synth_batch(dcfg, 99)["tokens"][:, :16]
    out1 = srv.serve(toks)
    trainer.step(synth_batch(dcfg, 5))           # concurrent commit
    out_same = srv.serve(toks)                    # pinned snapshot unchanged
    np.testing.assert_array_equal(out1, out_same)
    srv.refresh()
    out2 = srv.serve(toks)
    assert not np.array_equal(out1, out2)


def test_crash_mid_step_leaves_no_partial_state(tiny_setup):
    cfg, state0, step_fn, dcfg = tiny_setup
    be = BackendService(block_size=4096)
    local = LocalServer(be)
    trainer = TransactionalTrainer(local, step_fn, state0, device="cpu")
    trainer.init(state0)
    before = trainer.read_state()

    class Boom(RuntimeError):
        pass

    def crashing(fs: FaaSFS):
        st = TensorStore(fs, prefix="/mnt/tsfs/train")
        flat = st.load("state")
        st.save("state", {n: np.asarray(a) + 1 for n, a in flat.items()})
        raise Boom()

    with pytest.raises(Boom):
        runtime_for(local).invoke(crashing)

    after = trainer.read_state()
    for name, a in flat_tensors(before).items():
        assert torch.equal(a, flat_tensors(after)[name]), name


def test_two_workers_shared_state_makes_progress(tiny_setup):
    cfg, state0, step_fn, dcfg = tiny_setup
    be = BackendService(block_size=65536, policy=CachePolicy.EAGER)
    trainers = [TransactionalTrainer(LocalServer(be), step_fn, state0, device="cpu")
                for _ in range(2)]
    trainers[0].init(state0)

    def run(tr, base):
        for i in range(3):
            tr.step(synth_batch(dcfg, base + i))

    ts = [threading.Thread(target=run, args=(t, 100 * i)) for i, t in enumerate(trainers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive()
    final = trainers[0].read_state()
    assert int(final["opt"]["count"]) == 6


def test_trainer_writes_exactly_the_blocks_it_finds_dirty(tiny_setup):
    cfg, state0, step_fn, dcfg = tiny_setup
    local = LocalServer(BackendService(block_size=4096))
    trainer = TransactionalTrainer(local, step_fn, state0, device="cpu", block_bytes=4096)
    trainer.init(state0)
    before = flat_tensors(trainer.read_state())
    res = trainer.step(synth_batch(dcfg, 0))
    after = flat_tensors(trainer.read_state())
    from repro_torch.state.checkpoint import exact_dirty_blocks
    for name, t in after.items():
        assert res.dirty[name] == exact_dirty_blocks(t, before[name], 4096), name
    assert res.blocks_written == sum(len(v) for v in res.dirty.values()) > 0
    assert res.step == 1 and res.dirty["opt/count"] == [0]


# --------------------------------------------------------------------------- #
# Checkpoints across the two packages
# --------------------------------------------------------------------------- #
def _jax_loss(jcfg, state, batch):
    params = jax.tree.map(jnp.asarray, state["params"])
    loss, _ = JM.loss_fn(jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
                         compute_dtype=jnp.float32, ce_chunk=16)
    return float(loss)


def _torch_loss(cfg, state, batch):
    params = params_from_numpy(state["params"], "cpu")
    with torch.no_grad():
        loss, _ = M.loss_fn(cfg, params, _torch_batch(batch), compute_dtype=torch.float32,
                            ce_chunk=16)
    return float(loss)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_crosses_packages(direction):
    """One FaaSFS backend, one package's ``CheckpointManager`` saves a
    training state (after one step of its own trainer's math), the other's
    restores it: the same bytes, and the same float32 loss to 1e-6."""
    jcfg, cfg, jparams, host = _setup("qwen2-1.5b")
    batch = _batch(cfg)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    be = JBackendService(block_size=4096)
    if direction == "jax_to_torch":
        jplan = JCellPlan(jcfg, JShapeCell("t", "train", 32, 2), None, {}, JM.NO_SHARDING, 0, 16)
        new, _ = jmake_train_step(jplan, opt_cfg)(_jax_state(jparams),
                                                 {k: jnp.asarray(v) for k, v in batch.items()})
        saved = jax.tree.map(np.asarray, new)
        JCheckpointManager(JLocalServer(be)).save(1, saved)
        got, step = CheckpointManager(LocalServer(be)).restore(saved)
    else:
        state = params_from_numpy({"params": host, "opt": jax.tree.map(
            np.asarray, jadamw.init_opt_state(jparams))}, "cpu")
        new, _ = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 32, 2), ce_chunk=16),
                                 opt_cfg)(state, batch)
        saved = params_to_numpy(new)
        CheckpointManager(LocalServer(be)).save(1, new)
        got, step = JCheckpointManager(JLocalServer(be)).restore(saved)
    assert step == 1
    for (n, a), (m, b) in zip(flatten_with_names(saved), flatten_with_names(got)):
        assert n == m and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), n
    assert int(np.asarray(got["opt"]["count"])) == 1
    assert _torch_loss(cfg, got, batch) == pytest.approx(_jax_loss(jcfg, saved, batch),
                                                         rel=1e-6)


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #
def test_launch_train_runs_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b",
         "--reduced", "--device", "cpu", "--steps", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step    4 loss=" in out.stdout
    assert "checkpoint step 4 (full)" in out.stdout
    assert "restored step 4" in out.stdout


def test_launch_train_run_checks(tmp_path):
    """``run`` at reduced size: full then delta checkpoints, each step's
    dirty set equal to the exact compare of the committed states, the
    restore equal to the trainer's state, the served params equal to it."""
    _check_train_run(reduced_config(get_config("qwen2-1.5b")))


def test_launch_train_run_checks_moe():
    """The same for the reduced qwen3-moe-30b-a3b: every expert leaf and
    the router change in each step, and the run's losses and aux terms
    are finite."""
    r = _check_train_run(reduced_config(get_config("qwen3-moe-30b-a3b")))
    for res in r.steps:
        for name in ("router", "wi", "wg", "wo"):
            assert res.dirty[f"params/layers/moe/{name}"], (res.step, name)
        assert np.isfinite(res.metrics["loss"]) and res.metrics["aux_loss"] > 0


def test_launch_train_run_checks_vlm_with_dots():
    """The same for the reduced internvl2-76b, its batches with pixel
    embeds, with ``remat_policy="dots"``; and the launcher's options."""
    _check_train_run(reduced_config(get_config("internvl2-76b")), remat_policy="dots")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "internvl2-76b",
         "--reduced", "--device", "cpu", "--steps", "2", "--remat-policy", "dots"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step    2 loss=" in out.stdout and "restored step 2" in out.stdout


def test_train_batch_adds_seeded_pixel_embeds_for_vlm():
    from repro_torch.launch.train import train_batch
    vlm = reduced_config(get_config("internvl2-76b"))
    dcfg = DataConfig(vocab_size=vlm.vocab_size, seq_len=16, global_batch=2, seed=3)
    a, b, c = train_batch(vlm, dcfg, 0), train_batch(vlm, dcfg, 0), train_batch(vlm, dcfg, 1)
    assert a["pixel_embeds"].shape == (2, vlm.vision_prefix, vlm.d_model)
    assert a["pixel_embeds"].dtype == np.float32 and a["tokens"].shape == (2, 16)
    assert np.array_equal(a["pixel_embeds"], b["pixel_embeds"])
    assert not np.array_equal(a["pixel_embeds"], c["pixel_embeds"])
    dense = reduced_config(get_config("qwen2-1.5b"))
    assert set(train_batch(dense, dcfg, 0)) == {"tokens", "labels", "mask"}


def _check_train_run(cfg, **kw):
    from repro_torch.launch import train
    from repro_torch.state.checkpoint import exact_dirty_blocks
    r = train.run(cfg, device="cpu", steps=3, batch=2, seq=32, ckpt_every=2,
                  keep_states=True, serve_tokens=4, **kw)
    assert [s.dirty is None for s in r.saves] == [True, False]
    assert len(r.states) == 4 and r.restored_step == 3
    for i, res in enumerate(r.steps):
        old, new = flat_tensors(r.states[i]), flat_tensors(r.states[i + 1])
        for name in new:
            assert res.dirty[name] == exact_dirty_blocks(new[name], old[name],
                                                         train.BLOCK_BYTES), name
        assert res.blocks_written == sum(len(v) for v in res.dirty.values())
    last = flat_tensors(r.states[-1])
    for name, want in flatten_with_names(r.restored):
        assert last[name].numpy().tobytes() == want.tobytes(), name
    served = flat_tensors({"params": r.serve_slice.device_params()})
    for name, t in served.items():
        assert t.numpy().tobytes() == last[name].numpy().tobytes(), name
    logits, toks = r.served
    assert toks.shape == (2, 5) and bool(torch.isfinite(logits).all())
    return r
