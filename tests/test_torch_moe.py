"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU.

Both packages run on the same numpy inputs. In float32 the routing ids are
equal, the normalized top-k weights and the layer's output lie within
F32_REL (1e-5) of their largest value, the load-balance term within AUX_REL
(1e-6) of its value, and the gradients of ``sum(y * r) + aux`` for x, the
router, wi, wg and wo (``jax.grad`` against autograd) within F32_REL of each
one's largest value: both run float32 matmuls on the CPU and differ only in
summation order (seen: 1.3e-7 on the output, 1.2e-7 on aux). Gates that tie
exactly take the lower expert first in both. In bf16 the two frameworks
may round the router's logits at other places, which would flip a near
tie: the differing slots are counted and held to at most 5% of the slots
(none differ at these seeds, where the outputs are even bit-identical), and
the outputs are held to BF16_REL (2e-2) of the largest value on the tokens
whose routing agrees.

The first four tests are the twins of the MoE tests of
``tests/models/test_moe_attention_units.py``, on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro_torch.models import moe as TMoE

F32_REL = 1e-5
AUX_REL = 1e-6
BF16_REL = 2e-2


def _params(E, D, F, seed, scale=0.1):
    r = np.random.default_rng(seed)
    return ((r.standard_normal((D, E)) * scale).astype(np.float32),
            (r.standard_normal((E, D, F)) * scale).astype(np.float32),
            (r.standard_normal((E, D, F)) * scale).astype(np.float32),
            (r.standard_normal((E, F, D)) * scale).astype(np.float32))


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _max_rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --------------------------------------------------------------------------- #
# Twins of tests/models/test_moe_attention_units.py
# --------------------------------------------------------------------------- #
def test_moe_group_invariance():
    """G=1 vs G=2 agree when capacity is ample (grouping is layout)."""
    B, S, D, E, F, k = 4, 8, 16, 4, 32, 2
    x, (router, wi, wg, wo) = _x(B, S, D, 0), _params(E, D, F, 0)
    args = _t(x, router, wi, wg, wo)
    y1, _ = TMoE.moe_ffn(*args, num_experts=E, top_k=k, capacity_factor=8.0, groups=1)
    y2, _ = TMoE.moe_ffn(*args, num_experts=E, top_k=k, capacity_factor=8.0, groups=2)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)


def test_moe_matches_dense_reference():
    """With ample capacity, grouped dispatch == brute-force per-token experts."""
    B, S, D, E, F, k = 2, 4, 8, 4, 16, 2
    x, (router, wi, wg, wo) = _x(B, S, D, 1), _params(E, D, F, 1)
    xt, rt, wit, wgt, wot = _t(x, router, wi, wg, wo)
    y, _ = TMoE.moe_ffn(xt, rt, wit, wgt, wot, num_experts=E, top_k=k,
                        capacity_factor=16.0, groups=1)
    xf = xt.reshape(-1, D)
    w, ids = TMoE.top_k_routing(xf @ rt, k)
    ref = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(k):
            e = int(ids[t, j])
            h, g = xf[t] @ wit[e], xf[t] @ wgt[e]
            ref[t] += w[t, j] * ((h * g * torch.sigmoid(g)) @ wot[e])
    np.testing.assert_allclose(y.reshape(-1, D).numpy(), ref.numpy(), atol=1e-4)


def test_moe_capacity_drops_tokens():
    """With capacity < demand, overflow tokens are dropped (zero output)."""
    B, S, D, E, F, k = 1, 16, 8, 2, 16, 1
    x, (router, wi, wg, wo) = _x(B, S, D, 2), _params(E, D, F, 2)
    y, _ = TMoE.moe_ffn(*_t(x, router, wi, wg, wo), num_experts=E, top_k=k,
                        capacity_factor=0.25, groups=1)
    norms = np.linalg.norm(y[0].numpy(), axis=-1)
    capacity = max(k, int(0.25 * S * k / E))
    assert (norms > 1e-6).sum() <= E * capacity
    assert (norms < 1e-6).sum() >= S - E * capacity


def test_aux_loss_prefers_balance():
    T, E = 256, 4
    balanced = torch.zeros(T, E)
    skewed = torch.zeros(T, E)
    skewed[:, 0] = 10.0
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal((T, E)).astype(np.float32))
    _, ids_b = TMoE.top_k_routing(balanced + noise, 1)
    _, ids_s = TMoE.top_k_routing(skewed, 1)
    lb = TMoE.load_balance_loss(balanced, ids_b, E)
    ls = TMoE.load_balance_loss(skewed, ids_s, E)
    assert float(ls) > float(lb)


# --------------------------------------------------------------------------- #
# Parity with repro.models.moe
# --------------------------------------------------------------------------- #
PARITY_CASES = [
    # B, S, D, E, F, k, cf, groups
    (2, 8, 16, 4, 32, 2, 1.25, 1),        # the reduced configs' ratio
    (4, 8, 16, 4, 32, 2, 8.0, 2),         # ample capacity, two groups
    (2, 16, 32, 16, 24, 8, 1.25, 1),      # qwen3-moe-30b-a3b's E / k at reduced width
    (4, 16, 32, 16, 24, 8, 1.25, 2),      # the same in two groups
    (2, 16, 32, 16, 24, 8, 0.5, 1),       # drops: 32 tokens x 8 slots into 16 x 8
    (1, 16, 8, 2, 16, 1, 0.25, 1),        # drops: the capacity-drop test's shape
    (3, 7, 24, 8, 16, 2, 1.0, 2),         # groups does not divide B: one group
    (2, 5, 16, 8, 12, 2, 1.3, 1),         # cf * Tg * k / E = 3.25 floors to 3
]


def _jax_fn(E, k, cf, G):
    def f(x, router, wi, wg, wo, r):
        y, aux = JMoE.moe_ffn(x, router, wi, wg, wo, num_experts=E, top_k=k,
                              capacity_factor=cf, groups=G)
        return jnp.sum(y * r) + aux, (y, aux)
    return f


def _dropped_slots(ids, Tg, E, C):
    """Slots past their expert's capacity, counted per group in
    token-major, k-minor order as the layer does."""
    flat = ids.reshape(-1, Tg * ids.shape[-1])
    n = 0
    for row in flat:
        seen = np.zeros(E, np.int64)
        for e in row:
            n += int(seen[e] >= C)
            seen[e] += 1
    return n


@pytest.mark.parametrize("B,S,D,E,F,k,cf,groups", PARITY_CASES)
def test_moe_ffn_matches_jax_f32(B, S, D, E, F, k, cf, groups):
    x = _x(B, S, D, 10 + B * S)
    router, wi, wg, wo = _params(E, D, F, 20 + E, scale=0.3)
    r = np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32)
    G = groups if B % groups == 0 else 1
    Tg = (B // G) * S

    jlogits = jnp.asarray(x).reshape(G, Tg, D) @ jnp.asarray(router)
    jw, jids = JMoE.top_k_routing(jlogits, k)
    tw, tids = TMoE.top_k_routing(torch.from_numpy(x).reshape(G, Tg, D)
                                  @ torch.from_numpy(router), k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert _max_rel(tw, jw) <= F32_REL

    jargs = [jnp.asarray(a) for a in (x, router, wi, wg, wo, r)]
    (jl, (jy, jaux)), jgrads = jax.jit(jax.value_and_grad(
        _jax_fn(E, k, cf, groups), argnums=range(5), has_aux=True))(*jargs)
    targs = [t.requires_grad_(True) for t in _t(x, router, wi, wg, wo)]
    y, aux = TMoE.moe_ffn(*targs, num_experts=E, top_k=k, capacity_factor=cf, groups=groups)
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, targs)
    assert y.shape == (B, S, D) and aux.dtype == torch.float32 and aux.shape == ()
    assert _max_rel(y, jy) <= F32_REL
    assert abs(float(aux.detach()) - float(jaux)) <= AUX_REL * abs(float(jaux))
    for name, g, jg in zip(("x", "router", "wi", "wg", "wo"), grads, jgrads):
        assert _max_rel(g, jg) <= F32_REL, (name, _max_rel(g, jg))
    C = TMoE.capacity(Tg, E, k, cf)
    assert C == max(k, int(cf * Tg * k / E))
    if (B, S, cf) in ((2, 16, 0.5), (1, 16, 0.25)):
        assert _dropped_slots(tids.numpy(), Tg, E, C) > 0   # the drop cases drop


@pytest.mark.parametrize("num_tokens,E,k,cf,want", [
    (2048, 128, 8, 1.25, 160),    # qwen3-moe-30b-a3b prefill, B 4 x S 512
    (4, 128, 8, 1.25, 8),         # its decode step: at least k
    (10, 8, 2, 1.3, 3),           # 3.25 floors, where ceil would give 4
    (2048, 8, 2, 1.25, 640),      # mixtral-8x7b
])
def test_capacity_floors_as_the_reference_code(num_tokens, E, k, cf, want):
    assert TMoE.capacity(num_tokens, E, k, cf) == want


TIE_CASES = {
    "three_equal": ([[0, 1, 0, 1, 0, 1, 0, 0]], 3),
    "all_equal": ([[0.5] * 8], 3),
    "equal_pairs": ([[2, 0, 2, 0, 1, 1, 0, 0]], 4),
    "tie_at_the_cut": ([[3, 1, 1, 1, 0, 1, 0, 0]], 2),
    "bf16_rounded": (None, 8),
}


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_top_k_ties_resolve_as_jax_lax_top_k(case):
    logits, k = TIE_CASES[case]
    if logits is None:
        # bf16-rounded logits of 128 experts: many exact ties among them
        r = np.random.default_rng(5).standard_normal((64, 128)).astype(np.float32)
        logits = np.asarray(jnp.asarray(r * 0.05, jnp.bfloat16).astype(jnp.float32))
        g = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        assert any(len(set(row[np.argsort(-row)[:k + 1]])) <= k for row in g)
    logits = np.array(logits, np.float32)
    jw, jids = JMoE.top_k_routing(jnp.asarray(logits), k)
    tw, tids = TMoE.top_k_routing(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,S,D,E,F,k,groups", [(2, 16, 32, 16, 24, 8, 1),
                                                (2, 16, 32, 4, 32, 2, 2)])
def test_moe_ffn_matches_jax_bf16(B, S, D, E, F, k, groups):
    """bf16 inputs and weights: the ids where the routing agrees, and the
    outputs of the tokens whose k slots all agree, at BF16_REL of the
    largest output; the differing slots are counted."""
    x = _x(B, S, D, 7)
    router, wi, wg, wo = _params(E, D, F, 8, scale=0.3)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, router, wi, wg, wo)]
    jy, _ = JMoE.moe_ffn(*jargs, num_experts=E, top_k=k, capacity_factor=8.0, groups=groups)
    targs = _t(x, router, wi, wg, wo, dtype=torch.bfloat16)
    y, aux = TMoE.moe_ffn(*targs, num_experts=E, top_k=k, capacity_factor=8.0, groups=groups)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    G = groups if B % groups == 0 else 1
    Tg = (B // G) * S
    _, jids = JMoE.top_k_routing(jargs[0].reshape(G, Tg, D) @ jargs[1], k)
    _, tids = TMoE.top_k_routing(targs[0].reshape(G, Tg, D) @ targs[1], k)
    jids = np.asarray(jids).reshape(B * S, k)
    tids = tids.numpy().reshape(B * S, k)
    differ = int((jids != tids).sum())
    agree = (jids == tids).all(axis=1)
    assert differ <= jids.size // 20, f"{differ} of {jids.size} slots differ"
    assert agree.any()
    want = np.asarray(jy.astype(jnp.float32)).reshape(B * S, D)
    got = y.float().numpy().reshape(B * S, D)
    err = float(np.abs(got - want)[agree].max())
    assert err <= BF16_REL * float(np.abs(want).max()), (err, differ)


def test_routing_and_dispatch_sync_nothing_to_the_host():
    """The layer runs on meta tensors, which hold no data: no step of it
    reads a value back to the host (no .item(), no boolean indexing)."""
    B, S, D, E, F, k = 2, 16, 32, 16, 24, 8
    args = [torch.empty(s, device="meta") for s in ((B, S, D), (D, E), (E, D, F), (E, D, F),
                                                   (E, F, D))]
    y, aux = TMoE.moe_ffn(*args, num_experts=E, top_k=k)
    assert y.shape == (B, S, D) and aux.shape == ()
