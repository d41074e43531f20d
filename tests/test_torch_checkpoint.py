"""The port's ``CheckpointManager``: the reference's checkpoint tests
(tests/test_checkpoint.py) on the port, and the fix of the reference's
delta-save fault (ROADMAP, Queue 3, item 1).

The reference's SIGKILL test needs the networked server
(``repro.core.server``, with its WAL, wire and lease modules), which the
port has not copied; it is listed in ROADMAP.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.state.checkpoint import CheckpointManager


@pytest.fixture
def local():
    return LocalServer(BackendService(block_size=512))


def state(v=0.0):
    return {
        "params": {"w": np.full((32, 32), v, np.float32)},
        "opt": {"m": np.zeros((32, 32), np.float32)},
        "count": np.int32(0),
    }


def test_save_restore_roundtrip(local):
    cm = CheckpointManager(local)
    s = state(1.5)
    info = cm.save(100, s)
    assert info.step == 100 and info.bytes_written > 0
    restored, step = cm.restore(state())
    assert step == 100
    np.testing.assert_array_equal(restored["params"]["w"], s["params"]["w"])


def test_latest_pointer_advances(local):
    cm = CheckpointManager(local)
    cm.save(1, state(1.0))
    cm.save(2, state(2.0))
    assert cm.latest_step() == 2
    restored, step = cm.restore(state())
    assert step == 2
    assert restored["params"]["w"][0, 0] == 2.0
    r1, _ = cm.restore(state(), step=1)
    assert r1["params"]["w"][0, 0] == 1.0
    # every value of both steps, not only [0, 0]
    np.testing.assert_array_equal(restored["params"]["w"], state(2.0)["params"]["w"])
    np.testing.assert_array_equal(r1["params"]["w"], state(1.0)["params"]["w"])


def test_delta_checkpoint_ships_fewer_bytes(local):
    cm = CheckpointManager(local)
    s = state(1.0)
    full = cm.save(1, s)
    s2 = {"params": {"w": s["params"]["w"].copy()}, "opt": s["opt"], "count": s["count"]}
    s2["params"]["w"][0, 0] = 9.0  # tiny change
    delta = cm.save(2, s2)
    assert delta.bytes_written < full.bytes_written / 2
    restored, _ = cm.restore(state())
    assert restored["params"]["w"][0, 0] == 9.0


def test_restore_from_second_worker(local):
    cm = CheckpointManager(local)
    cm.save(5, state(5.0))
    other = LocalServer(local.backend)
    cm2 = CheckpointManager(other)
    restored, step = cm2.restore(state())
    assert step == 5 and restored["params"]["w"][0, 0] == 5.0


def test_delta_save_restores_every_value(local):
    """ROADMAP Queue 3, fault 1: 32x32 float32 of 1.0, then [0, 0] = 9.0,
    ``block_bytes=1024``. The reference's restore of step 2 has 256
    non-zero values of 1024; the port's has all 1024, and the delta
    writes one 1024-byte block."""
    cm = CheckpointManager(local, block_bytes=1024)
    s = state(1.0)
    cm.save(1, s)
    s2 = {"params": {"w": s["params"]["w"].copy()}, "opt": s["opt"], "count": s["count"]}
    s2["params"]["w"][0, 0] = 9.0
    delta = cm.save(2, s2)
    assert delta.blocks_written == 1 and delta.bytes_written == 1024
    assert delta.dirty == {"count": [], "opt/m": [], "params/w": [0]}
    restored, _ = cm.restore(state())
    np.testing.assert_array_equal(restored["params"]["w"], s2["params"]["w"])
    assert np.count_nonzero(restored["params"]["w"]) == 1024
    np.testing.assert_array_equal(restored["opt"]["m"], 0)
    r1, _ = cm.restore(state(), step=1)
    np.testing.assert_array_equal(r1["params"]["w"], s["params"]["w"])


def test_delta_chain_restores_each_step_bit_identical(local):
    """A full save and three deltas, one of which changes a leaf's shape
    (written whole) and adds a leaf: each step restores to the bytes saved,
    from a second worker too."""
    cm = CheckpointManager(local, block_bytes=1024)
    rng = np.random.default_rng(0)
    saved = {}
    cur = {"a": rng.standard_normal((64, 40)).astype(np.float32),
           "b": rng.standard_normal((100,)).astype(np.float32), "n": np.int32(0)}
    for step in range(1, 5):
        cur = {k: np.array(v) for k, v in cur.items()}
        if step > 1:
            cur["a"][rng.integers(0, 64), :] += 1.0
            cur["n"] = np.int32(step)
        if step == 3:
            cur["b"] = rng.standard_normal((7, 3)).astype(np.float32)
            cur["c"] = np.arange(300, dtype=np.float32)
        info = cm.save(step, cur)
        assert (info.dirty is None) == (step == 1)
        saved[step] = cur
    tpl = {k: None for k in saved[4]}
    for step in range(1, 5):
        got, _ = CheckpointManager(LocalServer(local.backend)).restore(
            {k: None for k in saved[step]}, step=step)
        for k, v in saved[step].items():
            assert got[k].dtype == np.asarray(v).dtype and got[k].shape == np.shape(v), k
            assert got[k].tobytes() == np.asarray(v).tobytes(), (step, k)
    latest, step = cm.restore(tpl)
    assert step == 4 and latest["c"].tobytes() == saved[4]["c"].tobytes()


def test_delta_save_detects_on_tensors_and_writes_what_changed(local):
    cm = CheckpointManager(local, block_bytes=1024)
    w = torch.ones(32, 32)
    cm.save(1, {"w": w})
    w2 = w.clone()
    w2[16, 5] = 2.0
    w2[31, 31] = float("nan")
    info = cm.save(2, {"w": w2})
    assert info.dirty == {"w": [2, 3]}
    got, _ = cm.restore({"w": None})
    assert got["w"].tobytes() == w2.numpy().tobytes()
