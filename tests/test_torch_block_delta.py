"""The port's block-delta wrapper (plain version on the CPU) against the JAX
kernel in interpret mode, mirroring tests/kernels/test_block_delta.py, and
the port's dirty-block detector against the reference's.

q must equal IEEE float32 arithmetic's int8 exactly, and the JAX kernel's
except at quotients within 1e-5 of a half-integer (see _assert_q_matches);
norm2 and scale match at rtol 1e-5. On rows with NaN, +-inf and subnormal
values q and scale equal JAX's exactly (every quotient there is 0, NaN,
+-inf or a whole number) and norm2 matches with NaN equal to NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_delta.ops import compute_block_delta as jax_block_delta
from repro.state.checkpoint import dirty_block_indices as jax_dirty_block_indices
from repro_torch.kernels.block_delta import ops
from repro_torch.kernels.block_delta.ref import apply_delta_ref, block_delta_ref
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
    ops.compute_block_delta_flat(x, x, 48)
    assert ops.block_delta.launches == before
    with pytest.raises(ValueError):
        ops.block_delta(x, x)
    with pytest.raises(ValueError):
        ops.block_delta_flat(x, x, 64)


# ------------------------------------------------------------------------- #
# special values: the plain version against JAX on NaN, +-inf, +-0 and
# subnormal rows (XLA flushes subnormals; so does the plain version)
# ------------------------------------------------------------------------- #
SPECIAL_ROWS = {
    "nan": lambda r, d: (d.__setitem__(7, np.nan), d)[1],           # scale 1, q = round(d)
    "inf": lambda r, d: (d.__setitem__(3, np.inf), d)[1],           # scale inf, q 0
    "neg_inf": lambda r, d: (d.__setitem__(3, -np.inf), d)[1],
    "inf_and_neg_inf": lambda r, d: (d.__setitem__([3, 9], [np.inf, -np.inf]), d)[1],
    "nan_and_inf": lambda r, d: (d.__setitem__([3, 9], [np.nan, np.inf]), d)[1],
    "scale_flushes": lambda r, d: d * np.float32(1e-38),            # max|d|/127 < tiny: scale 0
    "subnormal_max": lambda r, d: (d * np.float32(1e-44)).astype(np.float32),  # deltas flush
    "zero_signs": lambda r, d: np.where(r.random(d.shape) < 0.5, -0.0, 0.0).astype(np.float32),
}


def _special_pair(kind, be=256, seed=5):
    """Three rows of ``be``: an ordinary one, the special one, an ordinary
    one. The special row's delta is built first and added to old = 0 (or
    carried in new and old as infinities where inf - inf is meant)."""
    r = np.random.default_rng(seed)
    old = r.standard_normal((3, be)).astype(np.float32)
    new = (old + np.float32(0.01) * r.standard_normal((3, be))).astype(np.float32)
    d = SPECIAL_ROWS[kind](r, r.standard_normal(be).astype(np.float32) * np.float32(3))
    old[1] = 0.0
    new[1] = d
    return new, old


@pytest.mark.parametrize("kind", list(SPECIAL_ROWS))
def test_plain_special_rows_match_jax(kind):
    new, old = _special_pair(kind)
    qt, nt, st = ops.compute_block_delta(torch.from_numpy(new), torch.from_numpy(old))
    qj, nj, sj = jax_block_delta(jnp.asarray(new), jnp.asarray(old), impl="pallas_interpret")
    np.testing.assert_array_equal(qt.numpy()[1], np.asarray(qj)[1])
    np.testing.assert_array_equal(st.numpy()[1], np.asarray(sj)[1])
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-5, equal_nan=True)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


def test_plain_special_rows_read_as_stated():
    """The semantics the kernels share, stated on one row each."""
    def row(kind):
        new, old = _special_pair(kind)
        q, n2, sc = block_delta_ref(torch.from_numpy(new), torch.from_numpy(old))
        return q[1], float(n2[1]), float(sc[1]), torch.from_numpy(new[1] - old[1])
    q, n2, sc, d = row("nan")
    assert np.isnan(n2) and sc == 1.0 and int(q[7]) == 0
    assert torch.equal(q[:7], torch.clamp(torch.round(d[:7]), -127, 127).to(torch.int8))
    q, n2, sc, _ = row("inf_and_neg_inf")
    assert n2 == np.inf and sc == np.inf and int(q.abs().max()) == 0
    q, n2, sc, d = row("scale_flushes")
    assert n2 == 0.0 and sc == 0.0                    # 1e-38 deltas: their squares flush
    normal = d.abs() >= torch.finfo(torch.float32).tiny  # subnormal deltas flush to 0
    assert torch.equal(q, torch.where(normal, torch.sign(d) * 127, 0).to(torch.int8))
    assert 0 < int(normal.sum()) < len(d)
    q, n2, sc, _ = row("subnormal_max")
    assert n2 == 0.0 and sc == 1.0 and int(q.abs().max()) == 0


# ------------------------------------------------------------------------- #
# the flat entry: ragged leaves padded inside, plus the exact dirty flag
# ------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,be", [(1000, 256), (1024, 256), (77, 256), (3 * 512 + 5, 512)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flat_ref_equals_blockify_rows_and_bitwise_flag(n, be, dtype):
    tdt = DTYPES[dtype][0]
    r = np.random.default_rng(n)
    old = torch.from_numpy(r.standard_normal(n).astype(np.float32)).to(tdt)
    new = old.clone()
    new[r.choice(n, 3, replace=False)] += 1.0
    new[-1] = -0.0 if float(old[-1]) == 0.0 else -new[-1]
    q, n2, sc, dirty = ops.compute_block_delta_flat(new, old, be)
    nb_, ob_ = ops.blockify(new, be), ops.blockify(old, be)
    qr, nr, sr = block_delta_ref(nb_, ob_)
    bits = torch.int32 if tdt == torch.float32 else torch.int16
    want_dirty = (nb_.view(bits) != ob_.view(bits)).any(dim=1)
    assert torch.equal(q, qr) and torch.equal(sc, sr) and torch.equal(dirty, want_dirty)
    np.testing.assert_array_equal(n2.numpy(), nr.numpy())
    assert dirty.dtype == torch.bool and q.shape == (-(-n // be), be)
    assert dirty.tolist() == [i in exact_dirty_blocks(new, old, be * new.element_size())
                              for i in range(len(dirty))]


def test_flat_ref_flag_sees_what_norm2_and_q_do_not():
    old = torch.zeros(4 * 64)
    old[64] = float("nan")
    new = old.clone()
    new[5] = -0.0                                                   # block 0: zero sign
    new[64] = torch.tensor(0x7fc00001, dtype=torch.int32).view(torch.float32)  # 1: payload
    new[2 * 64 + 1] = float("nan")                                  # 2: finite -> NaN
    q, n2, sc, dirty = ops.compute_block_delta_flat(new, old, 64)
    assert dirty.tolist() == [True, True, True, False]
    assert int(q.abs().max()) == 0
    assert float(n2[0]) == 0.0 and np.isnan(float(n2[1])) and np.isnan(float(n2[2]))


def test_cluster_route_takes_serving_rows_and_leaves_the_rest():
    """The route is plain Python: the serving rows (65,536 float32) go to
    the cluster kernel at the first block size whose cluster fits; long
    rows, lengths that are not whole 16-byte loads, to the two-pass kernel."""
    for be, dt in [(65536, torch.float32), (32768, torch.float32), (131072, torch.bfloat16),
                   (256, torch.float32), (1000, torch.bfloat16)]:
        nt, c = ops.cluster_shape(be, dt)
        fits = [t for t in ops.CLUSTER_THREADS
                if -(-be // (t * ops.VALUES_PER_THREAD)) <= ops.MAX_CLUSTER]
        assert nt == fits[0] and c == -(-be // (nt * ops.VALUES_PER_THREAD)) <= 16
    assert ops.cluster_shape(1 << 20, torch.float32) is None
    assert ops.cluster_shape(1 << 18, torch.float32) == (1024, 16)
    assert ops.cluster_shape(1002, torch.float32) is None           # 4008 B rows
    assert ops.cluster_shape(1004, torch.bfloat16) is None          # 2008 B rows
    assert ops.cluster_shape(65536, torch.float32) == (256, 16)
    assert ops.cluster_shape(131072, torch.float32) == (512, 16)


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


def _special_change(shape, change, seed):
    """float32 leaves whose change the kernel's norm^2 and q may not see;
    each change lands on three elements in random blocks, and on the last
    element of the leaf (a ragged last block where the shape gives one)."""
    r = np.random.default_rng(seed)
    old = r.standard_normal(shape).astype(np.float32)
    new = old.copy()
    o, f = old.reshape(-1), new.reshape(-1)
    idx = list(r.choice(f.size - 1, 3, replace=False)) + [f.size - 1]
    bits = {"nan_payload": (0x7fc00000, 0x7fc00123), "zero_sign": (0x00000000, 0x80000000)}
    for i in idx:
        if change in bits:
            o[i:i + 1].view(np.uint32)[0], f[i:i + 1].view(np.uint32)[0] = bits[change]
        elif change == "to_nan":
            f[i] = np.nan
        elif change in ("to_inf", "to_neg_inf"):
            f[i] = np.inf if change == "to_inf" else -np.inf
        elif change == "tiny":
            o[i], f[i] = 0.0, np.float32(1e-25)
        else:
            raise ValueError(change)
    return new, old


@pytest.mark.parametrize("shape,dtype,block_bytes,change", [
    pytest.param((64, 100), np.float32, 1024, None, id="shape0-float32-1024"),  # whole blocks
    pytest.param((32, 32), np.float32, 1024, None, id="shape1-float32-1024"),   # whole blocks
    pytest.param((10,), np.float32, 1024, None, id="shape2-float32-1024"),  # under a block: bytes
    pytest.param((40, 30), np.int32, 512, None, id="shape3-int32-512"),     # not float32: bytes
    pytest.param((50, 20), np.float16, 256, None, id="shape4-float16-256"),  # not float32: bytes
    pytest.param((50, 77), np.float32, 1024, None, id="ragged"),        # 3850 = 15 x 256 + 10
    pytest.param((50, 77), np.float32, 1024, "zero_sign", id="zero_sign"),
    pytest.param((50, 77), np.float32, 1024, "nan_payload", id="nan_payload"),
    pytest.param((50, 77), np.float32, 1024, "to_nan", id="to_nan"),
    pytest.param((50, 77), np.float32, 1024, "to_inf", id="to_inf"),
    pytest.param((50, 77), np.float32, 1024, "to_neg_inf", id="to_neg_inf"),
    pytest.param((50, 77), np.float32, 1024, "tiny", id="tiny"),
    pytest.param((64, 100), np.float32, 1024, "to_nan", id="whole_to_nan"),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_dirty_block_indices_matches_reference(shape, dtype, block_bytes, change, seed):
    """The port's detector equals the reference's default (``impl="auto"``,
    the exact byte compare) on ordinary changes and on those the kernel's
    norm^2 and q miss: the sign of a zero, NaN payloads, finite -> NaN,
    +-inf, a delta of 1e-25, each also in a ragged last block."""
    if change is None:
        new, old = _sparse_change(shape, dtype, seed)
    else:
        new, old = _special_change(shape, change, seed)
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
