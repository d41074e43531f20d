"""Selective-scan gradients of the port on the CPU.

* ``selective_scan_bwd_ref`` (the plain version of the backward kernel)
  against ``jax.vjp`` of the JAX model's ``selective_scan``, with chunk
  sizes that give one chunk and several (the ``jax.checkpoint`` path),
  with and without h0 and a gradient on the last state, x float32 and
  bf16, on the same numpy inputs: every gradient to 1e-4 of its largest
  value in float32 (seen: 5.1e-7; sums in another order), 2e-2 with bf16
  x (seen: 7.4e-3 on dx, which both round to bf16, where one ulp is up to
  7.8e-3 of a value; 5.9e-7 on the float32 gradients).
* The same function against autograd of ``selective_scan_ref`` in
  float64, dh_last included, to 1e-10 of each gradient's largest value
  (seen: 5.5e-16), over sequences of one and of several 64-step chunks.
* ``SelectiveScanFn``, which ``ops.selective_scan`` runs under autograd, on
  its CPU path against both, and its None gradients.
* ``CellPlan(scan_impl="plain")`` reaches the plain scan, "auto" the
  Function.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.configs.base import ShapeCell, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (CHUNK, selective_scan_bwd_ref,
                                              selective_scan_ref)
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.runtime import CellPlan, make_prefill_step, make_train_step
from repro_torch.optim import adamw

# B, S, Di, N and JAX chunk sizes giving one chunk and several
CASES = [
    ((2, 64, 32, 8), (64, 16)),
    ((1, 150, 24, 16), (150, 50)),
    ((2, 40, 72, 4), (40, 8)),
]
JAX_CASES = [(shape, chunk) for shape, chunks in CASES for chunk in chunks]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
GRADS = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")


def _inputs(B, S, Di, N, seed=7):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, Di)).astype(np.float32)
    pre = (r.standard_normal((B, S, Di)) * 0.5 - 1.0).astype(np.float32)
    dt = np.logaddexp(pre, 0.0).astype(np.float32)            # softplus
    b = r.standard_normal((B, S, N)).astype(np.float32)
    c = r.standard_normal((B, S, N)).astype(np.float32)
    a = -np.repeat(np.arange(1, N + 1, dtype=np.float32)[None], Di, 0) \
        * np.exp(0.1 * r.standard_normal((Di, N))).astype(np.float32)
    d = r.standard_normal(Di).astype(np.float32)
    h0 = (0.5 * r.standard_normal((B, Di, N))).astype(np.float32)
    dy = r.standard_normal((B, S, Di)).astype(np.float32)
    dh = r.standard_normal((B, Di, N)).astype(np.float32)
    return dict(x=x, dt=dt, b=b, c=c, a=a, d=d, h0=h0, dy=dy, dh=dh)


def _rel_err(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _jax_grads(v, chunk, with_state, jdt):
    """jax.vjp of the JAX model's selective_scan: (dx, ddt, db, dc, da, dd,
    dh0 or None)."""
    args = [jnp.asarray(v["x"], jdt)] + [jnp.asarray(v[k]) for k in ("dt", "b", "c", "a", "d")]
    if with_state:
        fn = lambda x, dt, b, c, a, d, h0: jax_ssm.selective_scan(  # noqa: E731
            x, dt, b, c, a, d, chunk=chunk, h0=h0)
        args.append(jnp.asarray(v["h0"]))
    else:
        fn = lambda x, dt, b, c, a, d: jax_ssm.selective_scan(  # noqa: E731
            x, dt, b, c, a, d, chunk=chunk)
    (y, h_last), vjp = jax.vjp(fn, *args)
    dh = jnp.asarray(v["dh"]) if with_state else jnp.zeros_like(h_last)
    grads = vjp((jnp.asarray(v["dy"], y.dtype), dh))
    return tuple(grads) + ((None,) if not with_state else ())


def _torch(v, *keys, dtype=torch.float32):
    return [torch.from_numpy(v[k]).to(dtype) for k in keys]


@pytest.mark.parametrize("shape,chunk", JAX_CASES,
                         ids=[f"{s}-chunk{c}" for s, c in JAX_CASES])
@pytest.mark.parametrize("with_state", [False, True], ids=["no_h0", "h0_dh_last"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bwd_ref_matches_jax_vjp(shape, chunk, with_state, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    v = _inputs(*shape)
    want = _jax_grads(v, chunk, with_state, jdt)
    (x,) = _torch(v, "x", dtype=tdt)
    dt, b, c, a, d, h0, dh = _torch(v, "dt", "b", "c", "a", "d", "h0", "dh")
    (dy,) = _torch(v, "dy", dtype=tdt)
    got = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, h0=h0 if with_state else None,
                                 dh_last=dh if with_state else None)
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            continue
        err = _rel_err(g, w)
        assert err <= tol, (name, err)


def _plain_autograd(v, keys, with_state):
    """Autograd of selective_scan_ref through its plain ops, float64."""
    ins = _torch(v, *keys, dtype=torch.float64)
    for t in ins:
        t.requires_grad_(True)
    named = dict(zip(keys, ins))
    y, h_last = selective_scan_ref(*(named[k] for k in ("x", "dt", "b", "c", "a", "d")),
                                   h0=named.get("h0"))
    dy, dh = _torch(v, "dy", "dh", dtype=torch.float64)
    outs = [y] + ([h_last] if with_state else [])
    cots = [dy] + ([dh] if with_state else [])
    return dict(zip(keys, torch.autograd.grad(outs, ins, cots)))


F64_CASES = [(2, 64, 32, 8), (1, 150, 24, 16), (2, 130, 20, 2), (1, 40, 72, 4)]


@pytest.mark.parametrize("shape", F64_CASES, ids=[str(s) for s in F64_CASES])
@pytest.mark.parametrize("with_state", [False, True], ids=["no_h0", "h0_dh_last"])
def test_bwd_ref_matches_float64_autograd(shape, with_state):
    v = _inputs(*shape, seed=11)
    keys = ["x", "dt", "b", "c", "a", "d"] + (["h0"] if with_state else [])
    want = _plain_autograd(v, keys, with_state)
    x, dt, b, c, a, d, h0, dy, dh = _torch(v, "x", "dt", "b", "c", "a", "d", "h0", "dy", "dh",
                                           dtype=torch.float64)
    got = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, h0=h0 if with_state else None,
                                 dh_last=dh if with_state else None)
    assert all(g.dtype == torch.float64 for g in got)
    for g, key in zip(got, keys):     # dh0 only where h0 was given
        err = _rel_err(g, want[key])
        assert err <= 1e-10, (key, err)


def test_chunk_states_are_the_states_entering_each_chunk():
    v = _inputs(2, 2 * CHUNK + 9, 16, 8, seed=3)
    x, dt, b, c, a, d, h0 = _torch(v, "x", "dt", "b", "c", "a", "d", "h0")
    y, h_last, hc = selective_scan_ref(x, dt, b, c, a, d, h0=h0, return_chunk_states=True)
    assert hc.shape == (2, 3, 16, 8) and hc.dtype == torch.float32
    assert torch.equal(hc[:, 0], h0)
    for k in (1, 2):
        t = k * CHUNK
        _, h_k = selective_scan_ref(x[:, :t], dt[:, :t], b[:, :t], c[:, :t], a, d, h0=h0)
        assert torch.equal(hc[:, k], h_k)
    y2, h2 = selective_scan_ref(x, dt, b, c, a, d, h0=h0)
    assert torch.equal(y, y2) and torch.equal(h_last, h2)


def test_bwd_ref_from_given_chunk_states_equals_from_h0():
    v = _inputs(1, 150, 24, 16, seed=5)
    x, dt, b, c, a, d, h0, dy, dh = _torch(v, "x", "dt", "b", "c", "a", "d", "h0", "dy", "dh")
    hc = selective_scan_ref(x, dt, b, c, a, d, h0=h0, return_chunk_states=True)[2]
    one = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, h0=h0, dh_last=dh)
    two = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, dh_last=dh, chunk_states=hc)
    for g1, g2 in zip(one, two):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("with_state", [False, True], ids=["no_h0", "h0_dh_last"])
def test_selective_scan_fn_cpu_matches_float64_autograd(with_state):
    v = _inputs(2, 130, 20, 8, seed=13)
    keys = ["x", "dt", "b", "c", "a", "d"] + (["h0"] if with_state else [])
    want = _plain_autograd(v, keys, with_state)
    ins = _torch(v, *keys, dtype=torch.float64)
    for t in ins:
        t.requires_grad_(True)
    named = dict(zip(keys, ins))
    y, h_last = ops.selective_scan(*(named[k] for k in ("x", "dt", "b", "c", "a", "d")),
                                   h0=named.get("h0"))
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    dy, dh = _torch(v, "dy", "dh", dtype=torch.float64)
    outs, cots = ([y, h_last], [dy, dh]) if with_state else ([y], [dy])
    got = torch.autograd.grad(outs, ins, cots)
    for key, g in zip(keys, got):
        assert g.dtype == torch.float64
        err = _rel_err(g, want[key])
        assert err <= 1e-10, (key, err)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_selective_scan_fn_cpu_matches_jax_vjp(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    v = _inputs(2, 64, 32, 8)
    want = _jax_grads(v, 16, True, jdt)
    (x,) = _torch(v, "x", dtype=tdt)
    rest = _torch(v, "dt", "b", "c", "a", "d", "h0")
    ins = [x] + rest
    for t in ins:
        t.requires_grad_(True)
    y, h_last = ops.selective_scan(*ins[:6], h0=ins[6])
    assert y.dtype == tdt
    (dy,) = _torch(v, "dy", dtype=tdt)
    (dh,) = _torch(v, "dh")
    got = torch.autograd.grad([y, h_last], ins, [dy, dh])
    for name, g, w, t in zip(GRADS, got, want, ins):
        assert g.dtype == t.dtype
        err = _rel_err(g, w)
        assert err <= tol, (name, err)


def test_selective_scan_fn_gives_none_for_inputs_without_grad():
    v = _inputs(1, 20, 8, 4)
    x, dt, b, c, a, d = _torch(v, "x", "dt", "b", "c", "a", "d")
    dt.requires_grad_(True)
    a.requires_grad_(True)
    y, _ = ops.selective_scan(x, dt, b, c, a, d)
    y.sum().backward()
    assert dt.grad is not None and a.grad is not None
    assert x.grad is None and b.grad is None and c.grad is None and d.grad is None
    # the last state alone carries a gradient too
    dt.grad = None
    _, h_last = ops.selective_scan(x, dt, b, c, a, d)
    h_last.sum().backward()
    dt2 = dt.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(selective_scan_ref(x, dt2, b, c, a, d)[1].sum(), [dt2])
    assert _rel_err(dt.grad, want) <= 1e-5


def test_selective_scan_without_grad_takes_the_plain_version():
    v = _inputs(1, 20, 8, 4)
    args = _torch(v, "x", "dt", "b", "c", "a", "d")
    y, h = ops.selective_scan(*args)
    yr, hr = selective_scan_ref(*args)
    assert y.grad_fn is None and torch.equal(y, yr) and torch.equal(h, hr)


def test_bwd_wrapper_refuses_cpu_tensors():
    v = _inputs(1, 20, 8, 4)
    x, dt, b, c, a, d, dy = _torch(v, "x", "dt", "b", "c", "a", "d", "dy")
    hc = selective_scan_ref(x, dt, b, c, a, d, return_chunk_states=True)[2]
    with pytest.raises(ValueError):
        ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc)
    with pytest.raises(ValueError):
        ops.selective_scan_fwd(x, dt, b, c, a, d, chunk_states=True)


@pytest.fixture
def scan_routes(monkeypatch):
    """Counts of the plain scan the model calls for ``impl="plain"`` and of
    ``SelectiveScanFn`` runs."""
    seen = {"plain": 0, "fn": 0}
    plain, apply = ssm.selective_scan_ref, ops.SelectiveScanFn.apply

    def counted_plain(*a, **k):
        seen["plain"] += 1
        return plain(*a, **k)

    def counted_apply(*a, **k):
        seen["fn"] += 1
        return apply(*a, **k)

    monkeypatch.setattr(ssm, "selective_scan_ref", counted_plain)
    monkeypatch.setattr(ops.SelectiveScanFn, "apply", counted_apply)
    return seen


@pytest.mark.parametrize("scan_impl", ["plain", "auto"])
def test_cell_plan_scan_impl_reaches_its_scan(scan_routes, scan_impl):
    cfg = reduced_config(get_config("hymba-1.5b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    plan = CellPlan(cfg, ShapeCell("t", "train", 32, 2), ce_chunk=16,
                    compute_dtype=torch.float32, scan_impl=scan_impl)
    _, metrics = make_train_step(plan, adamw.AdamWConfig())(state, batch)
    L = cfg.num_layers
    # remat runs each layer's forward twice under autograd
    want = {"plain": 2 * L, "fn": 0} if scan_impl == "plain" else {"plain": 0, "fn": 2 * L}
    assert scan_routes == want
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
    scan_routes.update(plain=0, fn=0)
    with torch.no_grad():
        make_prefill_step(plan)(params, {"tokens": torch.from_numpy(batch["tokens"]).long()})
    # no autograd in prefill: the plain scan by name, or the forward without the Function
    assert scan_routes == ({"plain": L, "fn": 0} if scan_impl == "plain"
                           else {"plain": 0, "fn": 0})


def test_plain_and_auto_train_steps_agree_on_cpu():
    cfg = reduced_config(get_config("hymba-1.5b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    out = {}
    for impl in ("plain", "auto"):
        plan = CellPlan(cfg, ShapeCell("t", "train", 32, 2), ce_chunk=16,
                        compute_dtype=torch.float32, scan_impl=impl)
        out[impl] = make_train_step(plan, adamw.AdamWConfig())(state, batch)[1]
    assert out["auto"]["loss"] == out["plain"]["loss"]
    assert out["auto"]["grad_norm"] == pytest.approx(out["plain"]["grad_norm"], rel=1e-5)
