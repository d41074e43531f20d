"""The port's flash-attention wrapper (plain version on the CPU) against the
JAX kernel in interpret mode and the JAX oracle, plus the port's model
attention path.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the same plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.models.attention import attention_xla as jax_attention_xla
from repro.models.attention import decode_attention_xla as jax_decode_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.models.attention import attention_xla, decode_attention_xla

CASES = [  # tests/kernels/test_flash_attention.py
    # B, S, H, KV, hd, causal, window
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 4, 64, True, 0),       # MHA
    (1, 512, 8, 2, 128, True, 0),      # GQA 4:1
    (2, 256, 4, 1, 64, True, 0),       # MQA
    (2, 256, 4, 2, 64, False, 0),      # non-causal
    (2, 512, 4, 2, 64, True, 128),     # sliding window
    (1, 512, 2, 2, 64, True, 256),     # window == 2 blocks
    (1, 384, 4, 2, 64, True, 0),       # non-pow2 seq (384 = 3*128)
]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.5e-2)}


def _qkv(B, S, H, KV, hd, seed=42):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, S, H, hd)).astype(np.float32),
            r.standard_normal((B, S, KV, hd)).astype(np.float32),
            r.standard_normal((B, S, KV, hd)).astype(np.float32))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_vs_jax(B, S, H, KV, hd, causal, window, dtype, jax_impl):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, S, H, KV, hd)
    got = ops.attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                        causal=causal, window=window)
    want = jax_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                         causal=causal, window=window, impl=jax_impl,
                         block_q=128, block_k=128)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    assert err < tol, err


def test_cpu_wrapper_never_launches():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 1, 16))
    before = ops.flash_attention.launches
    ops.attention(q, k, v)
    assert ops.flash_attention.launches == before


def test_kernel_launcher_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in _qkv(1, 64, 2, 1, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


def test_attention_xla_matches_jax_and_kernel_oracle():
    """The model's attention (plain math on the CPU) equals JAX's
    attention_xla and the kernel's plain version (model layout)."""
    q, k, v = _qkv(2, 256, 4, 2, 64, seed=7)
    got = attention_xla(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    want = jax_attention_xla(*(jnp.asarray(a) for a in (q, k, v)), causal=True)
    oracle = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-5
    assert float(np.max(np.abs(got.numpy() - oracle.numpy()))) < 1e-5


@pytest.mark.parametrize("qc", [16, 32, 64])
def test_attention_q_chunk_invariance(qc):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 128, 4, 2, 32, seed=3))
    full = attention_xla(q, k, v, causal=True)
    chunked = attention_xla(q, k, v, causal=True, q_chunk=qc)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), atol=1e-5)


def test_sliding_window_masks_far_tokens():
    B, S, H, hd, W = 1, 64, 2, 16, 8
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, S, H, H, hd, seed=4))
    out_w = attention_xla(q, k, v, causal=True, window=W)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 100.0
    v2[:, 0] += 100.0
    out_w2 = attention_xla(q, k2, v2, causal=True, window=W)
    np.testing.assert_allclose(out_w[:, W + 1:].numpy(), out_w2[:, W + 1:].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_jax(window):
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    q, k, v = _qkv(B, S, H, KV, hd, seed=5)
    i = S - 3
    qi = np.ascontiguousarray(q[:, i:i + 1])
    got = decode_attention_xla(torch.from_numpy(qi), torch.from_numpy(k),
                               torch.from_numpy(v), i, window=window)
    want = jax_decode_attention(jnp.asarray(qi), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(i), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    full = attention_xla(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                         window=window)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(), atol=1e-5)
