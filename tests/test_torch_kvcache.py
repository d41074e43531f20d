"""Twin of tests/test_kvcache.py over the port's copy of
``serving/kvcache.py`` (``PagedKVCache``) and its copies of the backends:
allocation, assembly, persistence, prefix reuse.

The reference's persistence test runs over its ``backend_factory`` kinds;
here over the port's: the monolithic ``BackendService``, ``ShardedBackend``
(2 and 4 shards), the networked ``RemoteBackend`` speaking the wire
protocol to an in-process ``BackendServer`` with a WAL, in front of one
backend or of 2 shards, and the reference's sixth kind, ``sharded-proc``:
two shard server processes behind a coordinator process, started by the
port's ``ClusterHarness`` (``core/cluster.py``).
"""
import numpy as np
import pytest

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.sharded import ShardedBackend
from repro_torch.serving.kvcache import PagedKVCache

KINDS = ("mono", "sharded2", "sharded4", "remote-mono", "remote-sharded2", "sharded-proc")
HARNESS_TIMEOUT_S = 60.0   # a harness process's start and a client's connect


def start_harness(h, timeout_s: float = HARNESS_TIMEOUT_S):
    """``h.start()`` within ``timeout_s``: the harness reads each process's
    port from its first line and would wait for it forever; past the
    timeout its processes are killed, which ends the wait, and the test
    fails."""
    import threading

    errors = []

    def run():
        try:
            h.start()
        except Exception as e:   # reported by the caller's thread
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        for proc in list(h.shard_procs) + [h.coord_proc]:
            if proc is not None:
                proc.kill()
        t.join(10)
        pytest.fail(f"ClusterHarness did not start within {timeout_s} s")
    if errors:
        raise errors[0]
    return h


@pytest.fixture(params=KINDS)
def backend_factory(request, tmp_path):
    """The reference conftest's factory for the port's backends."""
    kind = request.param
    live = []
    clusters = []

    def make(**kwargs):
        if kind == "mono":
            return BackendService(**kwargs)
        if kind == "sharded-proc":
            from repro_torch.core.cluster import ClusterHarness

            h = ClusterHarness(str(tmp_path / f"cluster-{len(clusters)}"), n_servers=2,
                               n_slots=4, block_size=kwargs.pop("block_size", 4096),
                               policy="invalidate", checkpoint_records=400,
                               startup_timeout_s=HARNESS_TIMEOUT_S)
            clusters.append(h)
            start_harness(h)
            assert not kwargs, f"sharded-proc kind can't plumb {kwargs}"
            client = h.client()
            live.append((None, client))
            return client
        if kind.startswith("sharded"):
            return ShardedBackend(n_shards=int(kind[len("sharded"):]), **kwargs)
        from repro_torch.core.remote import RemoteBackend
        from repro_torch.core.server import BackendServer

        inner = (BackendService(**kwargs) if kind == "remote-mono"
                 else ShardedBackend(n_shards=int(kind[len("remote-sharded"):]), **kwargs))
        server = BackendServer(inner, wal_path=str(tmp_path / f"wal-{len(live)}"),
                               checkpoint_records=400, checkpoint_interval_s=0.1).start()
        client = RemoteBackend("127.0.0.1", server.port)
        live.append((server, client))
        return client

    make.kind = kind
    yield make
    for server, client in live:
        client.close()
        if server is not None:
            server.shutdown()
    for h in clusters:
        h.stop()


@pytest.fixture
def cfg():
    return reduced_config(get_config("minitron-8b"))


def tok_kv(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
    return rng.normal(size=shape).astype(np.float32), \
        rng.normal(size=shape).astype(np.float32)


def test_append_and_materialize(cfg):
    pk = PagedKVCache(cfg, num_pages=8, page_tokens=4)
    pk.new_sequence("s0")
    toks = [tok_kv(cfg, i) for i in range(10)]   # spans 3 pages
    for k, v in toks:
        pk.append("s0", k, v)
    assert pk.length("s0") == 10
    K, V = pk.materialize("s0", max_seq=16)
    assert K.shape == (cfg.num_layers, 16, cfg.num_kv_heads, cfg.head_dim)
    for i, (k, v) in enumerate(toks):
        np.testing.assert_array_equal(K[:, i], k)
        np.testing.assert_array_equal(V[:, i], v)
    np.testing.assert_array_equal(K[:, 10:], 0)


def test_pool_accounting_and_release(cfg):
    pk = PagedKVCache(cfg, num_pages=4, page_tokens=2)
    pk.new_sequence("a")
    pk.new_sequence("b")
    for i in range(4):
        pk.append("a", *tok_kv(cfg, i))       # 2 pages
    for i in range(3):
        pk.append("b", *tok_kv(cfg, 100 + i))  # 2 pages
    assert pk.free_pages == 0
    pk.new_sequence("c")
    with pytest.raises(MemoryError):
        pk.append("c", *tok_kv(cfg, 999))
    pk.release("a")
    assert pk.free_pages == 2
    pk.append("c", *tok_kv(cfg, 999))          # now fits


def test_isolation_between_sequences(cfg):
    pk = PagedKVCache(cfg, num_pages=8, page_tokens=2)
    pk.new_sequence("x")
    pk.new_sequence("y")
    kx, vx = tok_kv(cfg, 1)
    ky, vy = tok_kv(cfg, 2)
    pk.append("x", kx, vx)
    pk.append("y", ky, vy)
    KX, _ = pk.materialize("x", 4)
    KY, _ = pk.materialize("y", 4)
    np.testing.assert_array_equal(KX[:, 0], kx)
    np.testing.assert_array_equal(KY[:, 0], ky)


def test_persist_and_attach_across_workers(cfg, backend_factory):
    """Commit a conversation's KV pages, re-hydrate them on a different
    worker, bit-exact, over every port backend kind; on the networked
    kinds the page bytes land straight off the wire in the pool slabs."""
    be = backend_factory(block_size=256)
    w1, w2 = LocalServer(be), LocalServer(be)

    pk1 = PagedKVCache(cfg, num_pages=8, page_tokens=4)
    pk1.new_sequence("conv1")
    toks = [tok_kv(cfg, i) for i in range(7)]
    for k, v in toks:
        pk1.append("conv1", k, v)
    ts = pk1.persist(w1, "conv1")
    assert ts > 0

    remote = backend_factory.kind.startswith("remote")
    if remote:
        sunk_before = be.connection_stats()["bytes_sunk"]
    pk2 = PagedKVCache(cfg, num_pages=8, page_tokens=4)
    length = pk2.attach(w2, "conv1")
    assert length == 7
    K1, V1 = pk1.materialize("conv1", 8)
    K2, V2 = pk2.materialize("conv1", 8)
    np.testing.assert_array_equal(K1, K2)
    np.testing.assert_array_equal(V1, V2)
    if remote:
        # 2 pages x (k + v): all page payload crossed the wire zero-copy
        page_bytes = pk2.k_pages[0].nbytes
        assert be.connection_stats()["bytes_sunk"] - sunk_before >= 4 * page_bytes

    # appended continuation stays local until the next persist
    pk2.append("conv1", *tok_kv(cfg, 50))
    assert pk2.length("conv1") == 8

