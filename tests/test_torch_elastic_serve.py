"""The reference's integration tests of the transactional training loop,
elastic membership and snapshot serving (tests/test_train_elastic_serve.py),
on the port: its ``TransactionalTrainer`` with a torch train step on the
CPU, its copies of ``ElasticCoordinator`` (``train/elastic.py``) and
``SnapshotServer``, over its copies of the FaaSFS core.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.tensorstate import TensorStore
from repro_torch.core.types import CachePolicy, Conflict
from repro_torch.serving.engine import SnapshotServer
from repro_torch.train.elastic import ElasticCoordinator
from repro_torch.train.loop import TransactionalTrainer


def template():
    return {"w": np.zeros((8, 8), np.float32), "count": np.int64(0)}


def torch_train_step(state, batch):
    """Toy 'model': gradient descent pulling w toward the batch mean, on
    the trainer's tensors."""
    w = state["w"]
    g = w - torch.as_tensor(batch, device=w.device)
    return (
        {"w": w - 0.5 * g, "count": state["count"] + 1},
        {"loss": float(torch.mean(g * g))},
    )


def trainer(local):
    return TransactionalTrainer(local, torch_train_step, template(), device="cpu")


def test_single_worker_training_progresses():
    be = BackendService(block_size=512)
    tr = trainer(LocalServer(be))
    tr.init(template())
    target = np.full((8, 8), 3.0, np.float32)
    losses = [tr.step(target).metrics["loss"] for _ in range(20)]
    assert losses[-1] < losses[0] * 1e-3
    final = tr.read_state()
    assert int(final["count"]) == 20
    np.testing.assert_allclose(final["w"].numpy(), target, atol=1e-2)


def test_concurrent_workers_occ_no_lost_steps():
    """Two workers hammer the same state; OCC must count every committed step
    exactly once (conflicts abort + retry, never double-apply)."""
    be = BackendService(block_size=512, policy=CachePolicy.EAGER)
    workers = [trainer(LocalServer(be)) for _ in range(2)]
    workers[0].init(template())
    target = np.full((8, 8), 1.0, np.float32)
    N = 8

    def run(tr):
        for _ in range(N):
            tr.step(target)

    ts = [threading.Thread(target=run, args=(w,)) for w in workers]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    final = workers[0].read_state()
    assert int(final["count"]) == 2 * N  # every commit counted exactly once
    total_aborts = sum(w.stats.aborts for w in workers)
    assert total_aborts >= 0  # contention stats recorded


def test_elastic_generation_aborts_stale_steps():
    be = BackendService(block_size=512)
    a, b = LocalServer(be), LocalServer(be)
    coord_a, coord_b = ElasticCoordinator(a), ElasticCoordinator(b)
    coord_a.bootstrap(["w0"], {"w0": ["all"]})

    # worker A begins a step and reads the topology (joins its read set)
    txn = a.begin()
    fs = FaaSFS(txn)
    topo = coord_a.read(fs)
    assert topo.generation == 1

    # meanwhile a new worker joins (commits a topology change)
    coord_b.join("w1", ["half"])

    # A's in-flight step now fails validation at commit — no barrier needed
    fd = fs.open("/mnt/tsfs/cluster/topology")
    fs.pwrite(fd, b"x", 4096)  # any dependent write
    with pytest.raises(Conflict):
        txn.commit()

    # A retries and observes the new generation
    txn2 = a.begin()
    topo2 = coord_a.read(FaaSFS(txn2))
    assert topo2.generation == 2 and "w1" in topo2.workers
    txn2.commit()


def test_leave_reassigns_partitions():
    be = BackendService(block_size=512)
    coord = ElasticCoordinator(LocalServer(be))
    coord.bootstrap(["w0", "w1"], {"w0": ["p0", "p1"], "w1": ["p2"]})
    topo = coord.leave("w1")
    assert topo.workers == ["w0"]
    assert sorted(topo.partitions["w0"]) == ["p0", "p1", "p2"]


def test_snapshot_server_serves_while_training():
    be = BackendService(block_size=512, policy=CachePolicy.EAGER)
    tr = trainer(LocalServer(be))
    tr.init(template())
    target = np.full((8, 8), 2.0, np.float32)
    tr.step(target)

    def decode_fn(params, batch):
        return (torch.tensor(np.asarray(params["w"])) @ torch.from_numpy(batch)).numpy()

    srv = SnapshotServer(LocalServer(be), decode_fn, template())
    v1 = srv.refresh()
    out1 = srv.serve(np.eye(8, dtype=np.float32))

    # more training commits land; the pinned snapshot keeps serving v1
    for _ in range(3):
        tr.step(target)
    out_same = srv.serve(np.eye(8, dtype=np.float32))
    np.testing.assert_array_equal(out1, out_same)

    v2 = srv.refresh()
    assert v2 > v1
    out2 = srv.serve(np.eye(8, dtype=np.float32))
    assert not np.array_equal(out1, out2)
    assert srv.stats.requests == 3


def test_straggler_backup_worker_harmless():
    """A backup worker racing the same logical step aborts at validation
    instead of double-applying (OCC straggler mitigation)."""
    be = BackendService(block_size=512)
    a, b = LocalServer(be), LocalServer(be)
    tr = trainer(a)
    tr.init(template())

    # simulate: both replicas read state, both compute, both try to commit
    txn_a, txn_b = a.begin(), b.begin()
    fs_a, fs_b = FaaSFS(txn_a), FaaSFS(txn_b)
    st_a = TensorStore(fs_a, prefix="/mnt/tsfs/train")
    st_b = TensorStore(fs_b, prefix="/mnt/tsfs/train")
    flat_a, flat_b = st_a.load("state"), st_b.load("state")
    st_a.save("state", {"w": flat_a["w"] + 1, "count": flat_a["count"] + 1}, baseline=flat_a)
    st_b.save("state", {"w": flat_b["w"] + 1, "count": flat_b["count"] + 1}, baseline=flat_b)
    txn_a.commit()
    with pytest.raises(Conflict):
        txn_b.commit()   # the duplicate is rejected, state applied once
    final = tr.read_state()
    assert int(final["count"]) == 1
