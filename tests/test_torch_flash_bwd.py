"""Attention gradients of the port on the CPU against ``jax.vjp``.

``attention_bwd_ref`` (the plain version of the flash backward kernel),
autograd of the port's plain attention (the CPU path of
``FlashAttentionFn``'s wrapper) and autograd of the model's
``attention_xla`` against ``jax.vjp`` of the JAX ``attention_ref`` and
``attention_xla``, at the JAX kernel tests' cases, on the same numpy
inputs. Float32 to 1e-5 of each gradient's largest value (seen: 1.3e-6;
sums in another order); bf16 to 2e-2 (seen: 6.3e-3; the gradients round to
bf16, 3.9e-3 of a value, and ``attention_bwd_ref`` takes D from the bf16
output where JAX's vjp keeps the float32 one). The kernel itself runs only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

``attention_lse_ref`` (the plain version of the log-sum-exp the forward
kernels store for the backward) against ``jax.nn.logsumexp`` of the masked
scaled scores that the JAX ``attention_ref`` forms, at the same cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models.attention import attention_xla as jattention_xla
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)
from repro_torch.models.attention import attention_xla

FLASH_CASES = [  # tests/kernels/test_flash_attention.py
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 4, 64, True, 0),
    (1, 512, 8, 2, 128, True, 0),
    (2, 256, 4, 1, 64, True, 0),
    (2, 256, 4, 2, 64, False, 0),
    (2, 512, 4, 2, 64, True, 128),
    (1, 512, 2, 2, 64, True, 256),
    (1, 384, 4, 2, 64, True, 0),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _attn_inputs(B, S, H, KV, hd, seed=42):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, S, hd)).astype(np.float32),
            r.standard_normal((B, KV, S, hd)).astype(np.float32),
            r.standard_normal((B, KV, S, hd)).astype(np.float32),
            r.standard_normal((B, H, S, hd)).astype(np.float32))


def _jax_vjp(fn, arrays, dout, jdt):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in arrays))
    return vjp(jnp.asarray(dout, jdt))


@pytest.mark.parametrize("path", ["bwd_ref", "autograd_plain", "autograd_model"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_grads_match_jax_vjp(B, S, H, KV, hd, causal, window, dtype, path):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, do = _attn_inputs(B, S, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    if path == "bwd_ref":
        want = _jax_vjp(lambda *a: jattention_ref(*a, causal=causal, window=window),
                        (q, k, v), do, jdt)
        o = attention_ref(tq, tk, tv, causal=causal, window=window)
        got = attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window)
    else:
        # (B, S, H, hd) in and out; the plain path of FlashAttentionFn's
        # wrapper, or the model's attention_xla, differentiated by autograd
        fn = fa_ops.attention if path == "autograd_plain" else attention_xla
        jfn = jattention_ref if path == "autograd_plain" else jattention_xla
        ins = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (tq, tk, tv)]
        out = fn(*ins, causal=causal, window=window)
        got = [g.transpose(1, 2) for g in
               torch.autograd.grad(out, ins, tdo.transpose(1, 2))]
        if path == "autograd_plain":
            want = _jax_vjp(lambda *a: jfn(*a, causal=causal, window=window),
                            (q, k, v), do, jdt)
        else:
            swap = [np.swapaxes(a, 1, 2) for a in (q, k, v)]
            want = [w.swapaxes(1, 2) for w in _jax_vjp(
                lambda *a: jfn(*a, causal=causal, window=window), swap,
                np.swapaxes(do, 1, 2), jdt)]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and tuple(g.shape) == tuple(w.shape), name
        err = _rel_err(g, w)
        assert err <= tol, (name, err)


def test_attention_bwd_ref_is_autograd_of_attention_ref():
    """Both compute in float32 (``attention_ref`` casts), autograd through
    the softmax and the formulas in another order: 1e-5 of the largest."""
    q, k, v, do = _attn_inputs(2, 96, 4, 2, 32, seed=3)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention_ref(*ins, causal=True, window=40)
    want = torch.autograd.grad(out, ins, torch.from_numpy(do))
    got = attention_bwd_ref(*(t.detach() for t in ins), out.detach(),
                            torch.from_numpy(do), causal=True, window=40)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def _jax_masked_scores(q, k, *, causal, window):
    """The masked scaled scores of the JAX ``attention_ref``, formed as it
    forms them (``src/repro/kernels/flash_attention/ref.py``)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, hd)
    s = jnp.einsum("bkgqd,bksd->bkgqs", qg.astype(jnp.float32), k.astype(jnp.float32))
    s = s / jnp.sqrt(jnp.float32(hd))
    q_pos, k_pos = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    ok = jnp.ones((Sq, Sk), bool)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return jnp.where(ok[None, None, None], s, -1e30).reshape(B, H, Sq, Sk)


# lse against jax.nn.logsumexp, max |diff| (lse values are of order 1-10):
# both sides compute in float32 from the same (bf16-rounded) inputs, so
# float32 and bf16 differ only by sums in another order (seen: 9.5e-7, one
# float32 ulp at lse ~ 8, in both); 1e-5 for both.
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-5}


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_lse_ref_matches_jax_logsumexp(B, S, H, KV, hd, causal, window, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    q, k, v, _ = _attn_inputs(B, S, H, KV, hd)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = attention_lse_ref(tq, tk, tv, causal=causal, window=window)
    want = jax.nn.logsumexp(_jax_masked_scores(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                               causal=causal, window=window), axis=-1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, S)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    assert err <= LSE_TOL[dtype], err
