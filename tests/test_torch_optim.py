"""repro_torch.optim.adamw against repro.optim.adamw, and the AdamW units
of tests/test_optim_data.py on the port.

One update from the same numpy params, gradients and state (count 3, random
moments) matches the reference to 1e-6 absolute in params and moments: both
run the same float32 formula, elementwise, in the same order; what differs
is XLA's fusion of the expression (a reciprocal for a division, a fused
multiply-add), a few float32 ulps of values of order 1. A donating update
over leaves cut into slices gives the bits of the plain one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((2, 4, 3)).astype(np.float32)}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(a, b, prefix=""):
    if isinstance(a, dict):
        return [p for k in a for p in _pairs(a[k], b[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), a, b)]


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr_peak=0.1, lr_min=0.01, warmup_steps=5,
                            decay_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init_opt_state(params)
    for _ in range(200):
        p = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(p ** 2), [p])
        params, opt, _ = adamw.adamw_update(cfg, params, {"w": g}, opt)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(opt["count"]) == 200


def test_grad_clipping():
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    opt = adamw.init_opt_state(params)
    _, _, m = adamw.adamw_update(cfg, params, {"w": torch.full((4,), 100.0)}, opt)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_lr_schedule_shape():
    cfg = adamw.AdamWConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10, decay_steps=100)
    lrs = [float(adamw.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 55, 100, 1000]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-3)
    assert lrs[5] == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 55, 99, 100, 1000])
def test_lr_schedule_matches_reference(step):
    cfg = adamw.AdamWConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10, decay_steps=100)
    got = float(adamw.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(jadamw.lr_schedule(cfg, jnp.int32(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(clip_norm):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng)
    m = _map(lambda a: 0.1 * a, _tree(rng))
    v = _map(lambda a: 0.01 * np.abs(a), _tree(rng))
    count = np.int32(3)
    cfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, decay_steps=50, clip_norm=clip_norm)

    jp, jopt, jm = jadamw.adamw_update(
        cfg, _map(jnp.asarray, params), _map(jnp.asarray, grads),
        {"m": _map(jnp.asarray, m), "v": _map(jnp.asarray, v), "count": jnp.asarray(count)})
    tp, topt, tm = adamw.adamw_update(
        cfg, _map(torch.from_numpy, params), _map(torch.from_numpy, grads),
        {"m": _map(torch.from_numpy, m), "v": _map(torch.from_numpy, v),
         "count": torch.tensor(count)})

    for tree_t, tree_j in ((tp, jp), (topt["m"], jopt["m"]), (topt["v"], jopt["v"])):
        for name, t, j in _pairs(tree_t, tree_j):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                       err_msg=name)
    assert int(topt["count"]) == int(jopt["count"]) == 4
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    # functional: the inputs are unchanged
    np.testing.assert_array_equal(_tree(np.random.default_rng(0))["w"], params["w"])


def test_adamw_update_leaves_its_inputs_alone():
    params = {"w": torch.ones(3, 3), "b": torch.ones(3)}
    opt = adamw.init_opt_state(params)
    grads = {"w": torch.full((3, 3), 0.5), "b": torch.full((3,), 0.5)}
    before = {k: t.clone() for k, t in params.items()}
    new_p, new_opt, _ = adamw.adamw_update(adamw.AdamWConfig(), params, grads, opt)
    for k in params:
        assert torch.equal(params[k], before[k])
        assert new_p[k].data_ptr() != params[k].data_ptr()
        assert torch.count_nonzero(opt["m"][k]) == 0
    assert int(opt["count"]) == 0 and int(new_opt["count"]) == 1


def test_decay_only_for_matrices():
    cfg = adamw.AdamWConfig(lr_peak=1.0, warmup_steps=0, weight_decay=0.5)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    zeros = {k: torch.zeros_like(t) for k, t in params.items()}
    new_p, _, _ = adamw.adamw_update(cfg, params, zeros, adamw.init_opt_state(params))
    assert torch.all(new_p["w"] < 1.0)          # decayed
    assert torch.equal(new_p["b"], params["b"])  # no gradient, no decay


def test_opt_state_keys_and_dtypes_match_reference():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    j = jadamw.init_opt_state(_map(jnp.asarray, params))
    t = adamw.init_opt_state(_map(torch.from_numpy, params))
    assert sorted(t) == sorted(j) == ["count", "m", "v"]
    for key in ("m", "v"):
        for name, tt, jj in _pairs(t[key], j[key]):
            assert tt.dtype == torch.float32 and np.asarray(jj).dtype == np.float32, name
            assert tuple(tt.shape) == tuple(jj.shape), name
            assert not torch.any(tt), name
    assert t["count"].dtype == torch.int32 and t["count"].shape == ()
    assert np.asarray(j["count"]).dtype == np.int32 and np.asarray(j["count"]).shape == ()
    assert jax.tree.structure(jax.tree.map(np.asarray, j)) == \
        jax.tree.structure(_map(lambda x: x.numpy(), t))


def test_adamw_donation_and_slices_leave_the_values(monkeypatch):
    """``adamw_update`` with ``donate`` and with leaves cut into slices of
    ``CHUNK`` elements gives the bits of one undonated update of whole
    leaves, and empties the containers it was handed."""
    g = torch.Generator().manual_seed(0)
    params = {"a": {"w": torch.randn(37, 11, generator=g)}, "b": torch.randn(50, generator=g)}
    grads = {"a": {"w": torch.randn(37, 11, generator=g)}, "b": torch.randn(50, generator=g)}
    cfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=1)
    opt = adamw.init_opt_state(params)
    opt["m"] = {"a": {"w": torch.randn(37, 11, generator=g)}, "b": torch.randn(50, generator=g)}
    want = adamw.adamw_update(cfg, params, grads, opt)
    copy = lambda t: {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else t.clone()
    p2, g2, o2 = copy(params), copy(grads), {"m": copy(opt["m"]), "v": copy(opt["v"]),
                                             "count": opt["count"]}
    monkeypatch.setattr(adamw, "CHUNK", 16)       # every leaf here is cut into slices
    got = adamw.adamw_update(cfg, p2, g2, o2, donate=True)
    assert p2 == {} and g2 == {} and o2["m"] == {} and o2["v"] == {}
    for tree_got, tree_want in ((got[0], want[0]), (got[1]["m"], want[1]["m"]),
                                (got[1]["v"], want[1]["v"])):
        gf, wf = adamw._leaves(tree_got), adamw._leaves(tree_want)
        assert len(gf) == len(wf) and all(torch.equal(a, b) for a, b in zip(gf, wf))
