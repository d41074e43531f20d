"""The port's one-copy publish (``repro_torch.state.publish``) against the
verbatim ``TensorStore.save``, on the CPU: the same committed blocks,
versions, file metadata, ``.meta`` bytes, stats and client cache, for the
tiny dense and hybrid configs and for leaves that are 0-d, empty, under one
block, an exact multiple of a block and ragged; an in-place delta publish
through a dirty-block mask, with the earlier version still read back at its
timestamp; every stored block a ``bytes``; a forced ``Conflict`` retried
into one commit; ``faasfs_ml_publish_blocks_total{path}`` counting exactly."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.core import obs
from repro_torch.core.backend import BackendService
from repro_torch.core.blockstore import BlockStore
from repro_torch.core.client import LocalServer, Transaction
from repro_torch.core.posix import O_CREAT, FaaSFS
from repro_torch.core.runtime import FunctionRuntime
from repro_torch.core.tensorstate import TensorStore, flatten_with_names
from repro_torch.core.types import CachePolicy, WriteRecord
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model as M
from repro_torch.state import publish as P

ROOT, NAME = "/mnt/tsfs/train", "state"
ARCHS = {"dense": "qwen2-1.5b", "hybrid": "hymba-1.5b"}


def _shapes_tree(bs: int) -> dict:
    """One leaf of each kind a block layout can give, and one that is not
    contiguous in memory."""
    rng = np.random.default_rng(7)
    f = bs // 4
    return {
        "scalar": np.float32(3.5),
        "empty": np.zeros((0, 3), np.float32),
        "small": rng.standard_normal(10).astype(np.float32),
        "exact": rng.standard_normal((2, f)).astype(np.float32),
        "ragged": rng.standard_normal(5 * f // 2).astype(np.float32),
        "strided": rng.standard_normal((3, 2 * f)).astype(np.float32)[:, ::3].T,
        "nested": {"ints": rng.integers(-9, 9, 3 * f + 7).astype(np.int32),
                   "bytes": rng.integers(0, 255, bs + 1).astype(np.uint8)},
    }


def _tree(kind: str, bs: int) -> dict:
    if kind == "shapes":
        return _shapes_tree(bs)
    cfg = reduced_config(get_config(ARCHS[kind]))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return params_to_numpy({"params": params})


def _save_new(fs, tree, dirty=None):
    return P.PublishStore(fs, prefix=ROOT).publish(NAME, tree, dirty_blocks=dirty)


def _save_old(fs, tree, dirty=None):
    return TensorStore(fs, prefix=ROOT).save(NAME, tree, block_bytes=fs.txn.block_size,
                                             dirty_blocks=dirty)


class Side:
    """One backend, the client that publishes into it, and its runtime."""

    def __init__(self, backend, local=None):
        self.backend = backend
        self.local = local or LocalServer(backend)
        self.rt = FunctionRuntime(self.local)

    def write(self, save, tree, dirty=None):
        out = {}
        self.rt.invoke(lambda fs: out.update(r=save(fs, tree, dirty)))
        return out["r"], self.backend.latest_ts

    def state(self):
        """Every chain of the store and the client cache, by value."""
        st = self.backend.store
        cache = {k: (e.version, e.data) for k, e in self.local.cache.items()}
        return ({k: list(v.versions) for k, v in st._blocks.items()},
                {k: list(v.versions) for k, v in st._meta.items()},
                {k: list(v.versions) for k, v in st._names.items()}, cache)

    def load(self, ts=None):
        if ts is None:
            return self.rt.invoke(lambda fs: TensorStore(fs, prefix=ROOT).load(NAME))
        txn = Transaction(self.local, ts, read_only=True)
        return TensorStore(FaaSFS(txn), prefix=ROOT).load(NAME)

    def meta_bytes(self):
        def read(fs):
            fd = fs.open(f"{ROOT}/{NAME}/.meta")
            return fs.pread(fd, 1 << 20, 0)
        return self.rt.invoke(read, read_only=True)


def _pair(bs):
    return (Side(P.PublishBackend(bs, policy=CachePolicy.EAGER)),
            Side(BackendService(bs, policy=CachePolicy.EAGER)))


def _whole_blocks(tree, bs, dirty=None):
    """Blocks a publish of ``tree`` hands over whole, counted from sizes."""
    n = 0
    for name, arr in flatten_with_names(tree):
        size = arr.nbytes
        mask = dirty.get(name) if dirty else None
        blocks = range(-(-size // bs)) if mask is None else set(mask)
        n += sum(1 for b in blocks if 0 <= b and (b + 1) * bs <= size)
    return n


def _assert_same(new: Side, old: Side):
    got, want = new.state(), old.state()
    assert got == want
    assert all(type(data) is bytes for chain in got[0].values() for _, data in chain)
    assert all(type(data) is bytes for _, data in got[3].values())
    assert new.meta_bytes() == old.meta_bytes()


def _assert_tree(loaded, tree):
    flat = dict(flatten_with_names(tree))
    assert sorted(loaded) == sorted(flat)
    for name, arr in flat.items():
        assert loaded[name].dtype == arr.dtype and loaded[name].shape == arr.shape
        assert loaded[name].tobytes() == np.ascontiguousarray(arr).tobytes(), name


@pytest.mark.parametrize("bs", [1024, 4096])
@pytest.mark.parametrize("kind", ["dense", "hybrid", "shapes"])
def test_publish_equals_verbatim_save(kind, bs):
    tree = _tree(kind, bs)
    new, old = _pair(bs)
    (stats, whole), ts_new = new.write(_save_new, tree)
    want, ts_old = old.write(_save_old, tree)
    assert stats == want and ts_new == ts_old
    assert stats["blocks_written"] > whole == _whole_blocks(tree, bs) > 0
    _assert_same(new, old)
    _assert_tree(new.load(), tree)
    _assert_tree(old.load(), tree)


@pytest.mark.parametrize("kind", ["dense", "shapes"])
def test_delta_publish_equals_verbatim_and_keeps_the_old_version(kind):
    bs = 1024
    v0 = _tree(kind, bs)
    flat0 = dict(flatten_with_names(v0))
    v1, dirty = {}, {}
    for i, (name, arr) in enumerate(flat0.items()):
        a = np.array(arr, copy=True)
        if a.size:
            a.reshape(-1)[a.size // 2] += 1   # a block in the middle
            a.reshape(-1)[-1] += 1            # the last, maybe ragged, block
        v1[name] = a
        if i % 4 == 3:
            continue                          # not in the mask: written whole
        old_b, new_b = np.ascontiguousarray(arr).tobytes(), a.tobytes()
        idx = [b for b in range(-(-len(new_b) // bs))
               if new_b[b * bs:(b + 1) * bs] != old_b[b * bs:(b + 1) * bs]]
        # an index past the end writes nothing in either
        dirty[name] = idx + [len(new_b) // bs + 3]
    new, old = _pair(bs)
    new.write(_save_new, v0)
    _, ts0 = old.write(_save_old, v0)
    (stats, whole), ts1 = new.write(_save_new, v1, dirty)
    want, _ = old.write(_save_old, v1, dirty)
    assert stats == want and whole == _whole_blocks(v1, bs, dirty)
    assert 0 < stats["blocks_written"] < sum(-(-a.nbytes // bs) for a in v1.values())
    _assert_same(new, old)
    _assert_tree(new.load(), v1)
    _assert_tree(new.load(ts0), v0)
    _assert_tree(old.load(ts0), v0)
    assert ts1 > ts0


def test_whole_block_is_handed_over_and_other_patches_apply():
    bs = 16
    blk = bytes(range(bs))
    w = P.WholeBlockWrite((1, 0))
    w.add(0, blk)
    assert w.apply_to(b"\1" * bs, bs) is blk and w.apply_to(b"", bs) is blk
    for patches in ([(0, bytearray(blk))], [(0, blk[:8])], [(1, blk[:15])],
                    [(0, blk), (3, b"xy")]):
        w = P.WholeBlockWrite((1, 0), list(patches))
        ref = WriteRecord((1, 0), list(patches))
        assert w.apply_to(b"\7" * bs, bs) == ref.apply_to(b"\7" * bs, bs)
        assert type(w.apply_to(b"", bs)) is bytes


def test_zero_block_is_shared_and_reads_as_the_verbatim_one():
    store = P.SharedZeroBlockStore(64)
    ref = BlockStore(64)
    assert store.block((1, 0)) == ref.block((1, 0)) == (0, bytes(64))
    assert store.block((1, 0))[1] is store.block((2, 5), 3)[1]
    store.put_block((1, 0), b"a" * 64, 4)
    ref.put_block((1, 0), b"a" * 64, 4)
    for ts in (None, 3, 4, 9):
        assert store.block((1, 0), ts) == ref.block((1, 0), ts)


def _counted():
    fam = obs.REGISTRY.snapshot()["faasfs_ml_publish_blocks_total"]
    return tuple(fam["values"].get(f"path={p}", 0) for p in ("whole", "patched"))


def test_conflict_retries_into_one_commit_and_blocks_are_counted(monkeypatch):
    """A writer that creates the ``.meta`` file during the first attempt
    makes that attempt's commit fail validation; the retry builds fresh
    records and commits once, and the counter counts the committed
    publish's blocks, whole and patched, once."""
    cfg = reduced_config(get_config("qwen2-1.5b"))
    bs = 4096
    sl = serve_mod.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, block_bytes=bs)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    host = params_to_numpy({"params": params})
    real = P.PublishStore.publish
    attempts = []

    def publish(self, name, tree, **kw):
        out = real(self, name, tree, **kw)
        if not attempts:
            FunctionRuntime(LocalServer(sl.backend)).invoke(
                lambda fs: fs.close(fs.open(f"{ROOT}/{NAME}/.meta", O_CREAT)))
        attempts.append(dict(self.fs.txn.writes))
        return out

    monkeypatch.setattr(P.PublishStore, "publish", publish)
    before = _counted()
    info = sl.publish(params)
    assert len(attempts) == 2 and len(attempts[0]) == len(attempts[1])
    assert not {id(w) for w in attempts[0].values()} & {id(w) for w in attempts[1].values()}
    assert sl.backend.stats.commits == 2 and sl.backend.stats.aborts == 1
    blocks = sl.backend.store._blocks
    assert all(len(blocks[k].versions) == 1 for k in attempts[1])
    assert not any(k in blocks for k in attempts[0] if k not in attempts[1])
    whole = _whole_blocks(host, bs)
    assert 0 < whole < info.stats["blocks_written"]
    after = _counted()
    assert (after[0] - before[0], after[1] - before[1]) == \
        (whole, info.stats["blocks_written"] - whole)
    _assert_tree(Side(sl.backend, sl.boot).load(), host)

    before = _counted()
    info = sl.publish(serve_mod.sparse_update(cfg, params, torch.Generator().manual_seed(2)))
    whole = _whole_blocks(host, bs, info.dirty)
    after = _counted()
    assert info.stats["blocks_written"] > 0
    assert (after[0] - before[0], after[1] - before[1]) == \
        (whole, info.stats["blocks_written"] - whole)
