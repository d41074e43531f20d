"""The port's selective scan and mamba block against the JAX package.

* The scan wrapper (plain version on the CPU) against the JAX kernel in
  interpret mode and the JAX oracle, on the four cases of
  tests/kernels/test_ssm_scan.py in float32 and bf16, at that file's
  tolerances (2e-4 and 1e-1 absolute on y).
* ``models/ssm.selective_scan`` against the JAX model's chunked scan, y and
  the last state, float32, 2e-4 absolute (the reference's own bound
  between its chunked scan and its sequential oracle), including widths
  that are no multiple of the Pallas kernel's 256-wide blocks.
* ``causal_conv1d``, ``mamba_block`` (with the decode state it returns)
  and ``mamba_decode_step`` against JAX: float32 to 1e-5 of the largest
  output; bf16 to 2e-2 of it (the frameworks round bf16 matmul outputs at
  different places).
* Mirror of ``test_decode_recurrence_matches_scan``: the single-step
  recurrence run over a sequence equals the block, and ends in the state
  the block returns.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the same plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as jax_kernel_scan
from repro.models import ssm as jax_ssm
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.models import ssm

CASES = [  # tests/kernels/test_ssm_scan.py
    # B, S, Di, N, chunk, block_d
    (2, 64, 32, 8, 32, 16),
    (1, 128, 64, 16, 64, 32),
    (2, 96, 32, 8, 32, 32),      # 3 chunks
    (1, 64, 128, 16, 16, 128),   # single d block, many chunks
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-1)}
F32_REL = 1e-5
BF16_REL = 2e-2


def _scan_inputs(B, S, Di, N, seed=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, Di)).astype(np.float32)
    pre = (r.standard_normal((B, S, Di)) * 0.5 - 1.0).astype(np.float32)
    dt = np.logaddexp(pre, 0.0).astype(np.float32)        # softplus
    b = r.standard_normal((B, S, N)).astype(np.float32)
    c = r.standard_normal((B, S, N)).astype(np.float32)
    a_log = np.repeat(np.log(np.arange(1, N + 1, dtype=np.float32))[None], Di, 0)
    d = np.full((Di,), 0.5, np.float32)
    return x, dt, b, c, a_log, d


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _rel_close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (err, scale)


# ------------------------------------------------------------------------- #
# The kernel's function: plain version against the JAX kernel and oracle
# ------------------------------------------------------------------------- #
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("B,S,Di,N,chunk,block_d", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_scan_vs_jax(B, S, Di, N, chunk, block_d, dtype, jax_impl):
    tdt, jdt, tol = DTYPES[dtype]
    x, dt, b, c, a_log, d = _scan_inputs(B, S, Di, N)
    got = ops.ssm_scan(*_t(x, dt, b, c, dtype=tdt), *_t(a_log, d))
    want = jax_kernel_scan(*(jnp.asarray(v, jdt) for v in (x, dt, b, c)),
                           jnp.asarray(a_log), jnp.asarray(d), impl=jax_impl,
                           chunk=chunk, block_d=block_d)
    assert got.dtype == tdt and got.shape == (B, S, Di)
    err = float(np.max(np.abs(_f32(got) - _f32(want))))
    assert err < tol, err


@pytest.mark.parametrize("B,S,Di,N,chunk", [
    (2, 64, 32, 8, 32),
    (1, 128, 64, 16, 1024),
    (2, 96, 300, 16, 32),        # Di no multiple of 256
    (1, 40, 72, 4, 8),
])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_model_selective_scan_matches_jax(B, S, Di, N, chunk, with_h0):
    x, dt, b, c, a_log, d = _scan_inputs(B, S, Di, N, seed=5)
    a = -np.exp(a_log)
    h0 = (np.random.default_rng(6).standard_normal((B, Di, N)).astype(np.float32)
          if with_h0 else None)
    y, h = ssm.selective_scan(*_t(x, dt, b, c, a, d),
                              h0=None if h0 is None else torch.from_numpy(h0))
    jy, jh = jax_ssm.selective_scan(*(jnp.asarray(v) for v in (x, dt, b, c, a, d)),
                                    chunk=chunk, h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (B, S, Di) and h.shape == (B, Di, N) and h.dtype == torch.float32
    assert float(np.max(np.abs(_f32(y) - _f32(jy)))) < 2e-4
    assert float(np.max(np.abs(_f32(h) - _f32(jh)))) < 2e-4


def test_plain_impl_equals_auto_on_cpu():
    x, dt, b, c, a_log, d = _scan_inputs(1, 16, 24, 8)
    args = _t(x, dt, b, c, -np.exp(a_log), d)
    ya, ha = ssm.selective_scan(*args)
    yp, hp = ssm.selective_scan(*args, impl="plain")
    assert torch.equal(ya, yp) and torch.equal(ha, hp)
    with pytest.raises(ValueError):
        ssm.selective_scan(*args, impl="pallas")


def test_cpu_wrapper_never_launches():
    x, dt, b, c, a_log, d = _t(*_scan_inputs(1, 8, 16, 4))
    before = ops.selective_scan_fwd.launches
    ops.selective_scan(x, dt, b, c, -torch.exp(a_log), d)
    ops.ssm_scan(x, dt, b, c, a_log, d)
    assert ops.selective_scan_fwd.launches == before


def test_kernel_launcher_refuses_cpu_tensors():
    x, dt, b, c, a_log, d = _t(*_scan_inputs(1, 8, 16, 4))
    with pytest.raises(ValueError):
        ops.selective_scan_fwd(x, dt, b, c, -torch.exp(a_log), d)


def test_plain_scan_of_empty_sequence():
    x, dt, b, c, a_log, d = _t(*_scan_inputs(2, 1, 16, 4))
    y, h = selective_scan_ref(x[:, :0], dt[:, :0], b[:, :0], c[:, :0], -torch.exp(a_log), d)
    assert y.shape == (2, 0, 16) and torch.equal(h, torch.zeros(2, 16, 4))


# ------------------------------------------------------------------------- #
# The mamba block and its decode step
# ------------------------------------------------------------------------- #
D_MODEL, DI, N_STATE, RANK, K = 16, 40, 8, 8, 4


def _block_params(seed=11):
    r = np.random.default_rng(seed)

    def normal(*shape, s=0.1):
        return (r.standard_normal(shape) * s).astype(np.float32)

    return {
        "in_proj": normal(D_MODEL, 2 * DI),
        "conv_w": normal(DI, K, s=0.3),
        "conv_b": normal(DI),
        "x_proj": normal(DI, RANK + 2 * N_STATE),
        "dt_proj": normal(RANK, DI),
        "dt_bias": normal(DI),
        "A_log": np.repeat(np.log(np.arange(1, N_STATE + 1, dtype=np.float32))[None], DI, 0),
        "D": np.ones((DI,), np.float32),
        "out_proj": normal(DI, D_MODEL),
    }


def _both(p, tdt, jdt):
    return ({k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
            {k: jnp.asarray(v, jdt) for k, v in p.items()})


BLOCK_DTYPES = {"float32": (torch.float32, jnp.float32, F32_REL),
                "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_REL)}


@pytest.mark.parametrize("dtype", list(BLOCK_DTYPES))
def test_causal_conv1d_matches_jax(dtype):
    tdt, jdt, rel = BLOCK_DTYPES[dtype]
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 10, DI)).astype(np.float32)
    w = r.standard_normal((DI, K)).astype(np.float32)
    b = r.standard_normal((DI,)).astype(np.float32)
    got = ssm.causal_conv1d(*_t(x, w, b, dtype=tdt))
    want = jax_ssm.causal_conv1d(*(jnp.asarray(v, jdt) for v in (x, w, b)))
    assert got.dtype == tdt
    _rel_close(got, want, rel)


@pytest.mark.parametrize("S", [2, 24])       # shorter and longer than the conv
@pytest.mark.parametrize("dtype", list(BLOCK_DTYPES))
def test_mamba_block_matches_jax(dtype, S):
    tdt, jdt, rel = BLOCK_DTYPES[dtype]
    p, jp = _both(_block_params(), tdt, jdt)
    x = np.random.default_rng(4).standard_normal((2, S, D_MODEL)).astype(np.float32)
    got, (conv, h) = ssm.mamba_block(torch.from_numpy(x).to(tdt), p, dt_rank=RANK,
                                     ssm_state=N_STATE, return_state=True)
    want = jax_ssm.mamba_block(jnp.asarray(x, jdt), jp, dt_rank=RANK, ssm_state=N_STATE,
                               chunk=8)
    assert got.dtype == tdt and conv.dtype == tdt and h.dtype == torch.float32
    assert conv.shape == (2, K - 1, DI) and h.shape == (2, DI, N_STATE)
    _rel_close(got, want, rel)
    only = ssm.mamba_block(torch.from_numpy(x).to(tdt), p, dt_rank=RANK, ssm_state=N_STATE)
    assert torch.equal(only, got)


@pytest.mark.parametrize("dtype", list(BLOCK_DTYPES))
def test_mamba_decode_step_matches_jax(dtype):
    tdt, jdt, rel = BLOCK_DTYPES[dtype]
    p, jp = _both(_block_params(seed=12), tdt, jdt)
    r = np.random.default_rng(7)
    x = r.standard_normal((3, 1, D_MODEL)).astype(np.float32)
    conv = r.standard_normal((3, K - 1, DI)).astype(np.float32)
    h = r.standard_normal((3, DI, N_STATE)).astype(np.float32)
    out, conv2, h2 = ssm.mamba_decode_step(
        torch.from_numpy(x).to(tdt), p, torch.from_numpy(conv).to(tdt), torch.from_numpy(h),
        dt_rank=RANK, ssm_state=N_STATE)
    jout, jconv2, jh2 = jax_ssm.mamba_decode_step(
        jnp.asarray(x, jdt), jp, jnp.asarray(conv, jdt), jnp.asarray(h),
        dt_rank=RANK, ssm_state=N_STATE)
    assert out.dtype == tdt and conv2.dtype == tdt and h2.dtype == torch.float32
    _rel_close(out, jout, rel)
    _rel_close(conv2, jconv2, 0.0)      # a shift of the window: exact
    _rel_close(h2, jh2, rel)


def test_decode_recurrence_matches_scan():
    """Single-step decode recurrence == the block over the sequence, and it
    ends in the decode state the block returns (float32)."""
    p, _ = _both(_block_params(seed=13), torch.float32, jnp.float32)
    B, S = 2, 12
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, S, D_MODEL))
                         .astype(np.float32))
    y_full, (conv_end, h_end) = ssm.mamba_block(x, p, dt_rank=RANK, ssm_state=N_STATE,
                                                return_state=True)
    conv_state = torch.zeros((B, K - 1, DI))
    h = torch.zeros((B, DI, N_STATE))
    ys = []
    for t in range(S):
        yt, conv_state, h = ssm.mamba_decode_step(x[:, t:t + 1], p, conv_state, h,
                                                  dt_rank=RANK, ssm_state=N_STATE)
        ys.append(yt)
    y_dec = torch.cat(ys, dim=1)
    np.testing.assert_allclose(y_dec.numpy(), y_full.numpy(), atol=2e-4, rtol=1e-3)
    # the same in_proj rows, from matmuls of another shape
    np.testing.assert_allclose(conv_state.numpy(), conv_end.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), h_end.numpy(), atol=2e-4, rtol=1e-3)
