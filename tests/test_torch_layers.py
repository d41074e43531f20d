"""repro_torch.models.layers against repro.models.layers, float32, 1e-5.

Inputs are numpy arrays from a seeded generator, handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t: torch.Tensor, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_rms_norm():
    x = _rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    s = _rng(1).standard_normal(64).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


def test_rms_norm_headwise():
    x = _rng(2).standard_normal((2, 5, 4, 16)).astype(np.float32)
    s = _rng(3).standard_normal(16).astype(np.float32)
    _close(TL.rms_norm_headwise(torch.from_numpy(x), torch.from_numpy(s)),
           JL.rms_norm_headwise(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_freqs(hd, theta):
    _close(TL.rope_freqs(hd, theta), JL.rope_freqs(hd, theta))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("batch_positions", [False, True])
def test_apply_rope(theta, batch_positions):
    B, S, H, hd = 2, 64, 3, 32
    x = _rng(4).standard_normal((B, S, H, hd)).astype(np.float32)
    if batch_positions:  # decode: one position per sequence
        pos = np.array([[5], [61]], np.int32)
        x = x[:, :1]
    else:
        pos = np.arange(S, dtype=np.int32)[None, :]
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_embed_tokens():
    emb = _rng(5).standard_normal((50, 8)).astype(np.float32)
    toks = _rng(6).integers(0, 50, (3, 7)).astype(np.int64)
    _close(TL.embed_tokens(torch.from_numpy(emb), torch.from_numpy(toks), torch.float32),
           JL.embed_tokens(jnp.asarray(emb), jnp.asarray(toks), jnp.float32))


def test_swiglu_mlp():
    r = _rng(7)
    x = r.standard_normal((2, 5, 32)).astype(np.float32)
    wi, wg = (r.standard_normal((32, 48)).astype(np.float32) * 0.2 for _ in range(2))
    wo = r.standard_normal((48, 32)).astype(np.float32) * 0.2
    got = TL.swiglu_mlp(*(torch.from_numpy(a) for a in (x, wi, wg, wo)))
    want = JL.swiglu_mlp(*(jnp.asarray(a) for a in (x, wi, wg, wo)))
    _close(got, want)
