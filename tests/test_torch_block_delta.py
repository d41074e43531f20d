"""The port's block-delta wrapper (plain version on the CPU) against the JAX
kernel in interpret mode, mirroring tests/kernels/test_block_delta.py, and
the port's dirty-block detector against the reference's.

q must equal IEEE float32 arithmetic's int8 exactly, and the JAX kernel's
except at quotients within 1e-5 of a half-integer (see _assert_q_matches);
norm2 and scale match at rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_delta.ops import compute_block_delta as jax_block_delta
from repro.state.checkpoint import dirty_block_indices as jax_dirty_block_indices
from repro_torch.kernels.block_delta import ops
from repro_torch.kernels.block_delta.ref import apply_delta_ref
from repro_torch.state.checkpoint import dirty_block_indices, exact_dirty_blocks

CASES = [(4, 128), (8, 256), (16, 512), (1, 1024)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(nb, be, seed=0, step=0.01):
    r = np.random.default_rng(seed)
    new = r.standard_normal((nb, be)).astype(np.float32)
    old = (new + r.standard_normal((nb, be)).astype(np.float32) * step).astype(np.float32)
    return new, old


def _ieee_q(new: torch.Tensor, old: torch.Tensor):
    """q by numpy float32 arithmetic: IEEE division, round half to even."""
    d = new.float().numpy() - old.float().numpy()
    m = np.abs(d).max(axis=1)
    scale = np.where(m > 0, m / np.float32(127), np.float32(1)).astype(np.float32)
    quot = d / scale[:, None]
    return np.clip(np.rint(quot), -127, 127).astype(np.int8), quot


def _assert_q_matches(q_port, q_jax, quot):
    """q_port equals q_jax except where the quotient lies within 1e-5 of a
    half-integer: there XLA's CPU division (an approximate reciprocal, see
    ROADMAP.md Queue 3) may round to the other side, by exactly one."""
    off = q_port.astype(np.int32) != q_jax.astype(np.int32)
    a = np.abs(quot[off])
    near_half = np.abs(a - np.floor(a) - 0.5) <= 1e-5 * np.maximum(1.0, a)
    assert near_half.all(), quot[off][~near_half]
    assert (np.abs(q_port.astype(np.int32)[off] - q_jax.astype(np.int32)[off]) == 1).all()
    assert off.mean() < 1e-3


@pytest.mark.parametrize("nb,be", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_vs_ref(nb, be, dtype):
    tdt, jdt = DTYPES[dtype]
    new, old = _pair(nb, be)
    new_t, old_t = torch.from_numpy(new).to(tdt), torch.from_numpy(old).to(tdt)
    qt, nt, st = ops.compute_block_delta(new_t, old_t)
    qj, nj, sj = jax_block_delta(jnp.asarray(new, jdt), jnp.asarray(old, jdt),
                                 impl="pallas_interpret")
    assert qt.dtype == torch.int8 and qt.shape == (nb, be)
    q_ieee, quot = _ieee_q(new_t, old_t)
    np.testing.assert_array_equal(qt.numpy(), q_ieee)
    _assert_q_matches(qt.numpy(), np.asarray(qj), quot)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


def test_identical_blocks_have_zero_norm():
    x = torch.ones((4, 128))
    q, norm2, scale = ops.compute_block_delta(x, x)
    assert float(norm2.max()) == 0.0
    assert int(q.abs().max()) == 0
    assert torch.equal(scale, torch.ones(4))


def test_quantized_roundtrip_error_bounded():
    new, old = _pair(8, 256, seed=1, step=0.05)
    old_t, new_t = torch.from_numpy(old), torch.from_numpy(new)
    q, norm2, scale = ops.compute_block_delta(new_t, old_t)
    rec = apply_delta_ref(old_t, q, scale)
    # int8 quantization error is bounded by scale/2 per element
    err = float((rec - new_t).abs().max())
    assert err <= float(scale.max()) / 2 + 1e-6


def test_pack_dirty_selects_changed_blocks_only():
    old = torch.zeros((6, 64))
    new = old.clone()
    new[1] += 0.5
    new[4] += 0.1
    q, norm2, scale = ops.compute_block_delta(new, old)
    idx, qd, sd = ops.pack_dirty(q, norm2, scale)
    assert idx.tolist() == [1, 4]
    assert qd.shape == (2, 64) and sd.shape == (2,)


def test_blockify_pads():
    flat = torch.arange(100, dtype=torch.float32)
    b = ops.blockify(flat, 64)
    assert b.shape == (2, 64)
    assert float(b[1, 36:].sum()) == 0
    assert torch.equal(b.reshape(-1)[:100], flat)


def test_blockify_whole_blocks_is_a_view():
    flat = torch.arange(128, dtype=torch.float32)
    assert ops.blockify(flat, 64).data_ptr() == flat.data_ptr()


def test_cpu_wrapper_never_launches_and_launcher_refuses_cpu():
    x = torch.ones((2, 64))
    before = ops.block_delta.launches
    ops.compute_block_delta(x, x)
    assert ops.block_delta.launches == before
    with pytest.raises(ValueError):
        ops.block_delta(x, x)


# ------------------------------------------------------------------------- #
# dirty_block_indices: kernel rule for float32 leaves >= one block, exact
# byte compare otherwise; the same answers as the reference's exact path
# ------------------------------------------------------------------------- #
def _sparse_change(shape, dtype, seed, n_changes=3):
    r = np.random.default_rng(seed)
    old = r.standard_normal(shape).astype(dtype)
    new = old.copy()
    flat = new.reshape(-1)
    for i in r.choice(flat.size, n_changes, replace=False):
        flat[i] = flat[i] + dtype(1.5)
    return new, old


@pytest.mark.parametrize("shape,dtype,block_bytes", [
    ((64, 100), np.float32, 1024),     # kernel path, ragged last block
    ((32, 32), np.float32, 1024),      # kernel path, whole blocks
    ((10,), np.float32, 1024),         # shorter than a block: byte compare
    ((40, 30), np.int32, 512),         # not float32: byte compare
    ((50, 20), np.float16, 256),       # not float32: byte compare
])
@pytest.mark.parametrize("seed", [0, 1])
def test_dirty_block_indices_matches_reference(shape, dtype, block_bytes, seed):
    new, old = _sparse_change(shape, dtype, seed)
    got = dirty_block_indices(torch.from_numpy(new), torch.from_numpy(old), block_bytes)
    want = jax_dirty_block_indices(new, old, block_bytes, impl="auto")
    assert got == want
    assert got == exact_dirty_blocks(torch.from_numpy(new), torch.from_numpy(old),
                                     block_bytes)


def test_dirty_block_indices_kernel_rule_matches_reference_kernel_rule():
    new, old = _sparse_change((64, 100), np.float32, 3)
    got = dirty_block_indices(torch.from_numpy(new), torch.from_numpy(old), 1024)
    want = jax_dirty_block_indices(new, old, 1024, impl="pallas_interpret")
    assert got == want and len(got) > 0


def test_dirty_block_indices_sees_a_delta_whose_square_underflows():
    """A change of 1e-25 has norm^2 0 in float32 (1e-50 underflows), so the
    reference's kernel rule misses the block; its q is 127, which the
    port's rule reads."""
    old = np.zeros((4, 256), np.float32)
    new = old.copy()
    new[2, 5] = np.float32(1e-25)
    q, norm2, _ = ops.compute_block_delta(torch.from_numpy(new), torch.from_numpy(old))
    assert float(norm2[2]) == 0.0 and int(q[2, 5]) == 127
    got = dirty_block_indices(torch.from_numpy(new), torch.from_numpy(old), 1024)
    assert got == exact_dirty_blocks(torch.from_numpy(new), torch.from_numpy(old), 1024) == [2]
    assert jax_dirty_block_indices(new, old, 1024, impl="pallas_interpret") == []


def test_dirty_block_indices_unknown_on_shape_or_dtype_change():
    a = torch.zeros((4, 4))
    assert dirty_block_indices(a, torch.zeros((2, 8)), 64) is None
    assert dirty_block_indices(a, a.double(), 64) is None
    assert dirty_block_indices(torch.zeros((0,)), torch.zeros((0,)), 64) == []
