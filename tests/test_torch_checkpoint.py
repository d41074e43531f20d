"""The port's ``CheckpointManager``: the reference's checkpoint tests
(tests/test_checkpoint.py) on the port, and the fix of the reference's
delta-save fault (ROADMAP, Queue 3, item 1) and of the two faults of its
own delta chain (items 8 and 9: a re-saved base, a chain that loops).

The reference's SIGKILL test runs against ``python -m
repro_torch.core.server``, the port's copy of the networked server (with
its WAL, wire, lease, sharded and remote modules), reached through the
port's ``RemoteBackend``.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import O_CREAT, O_TRUNC
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


def _grid(v):
    return {"w": np.full((32, 32), v, np.float32)}


def test_resaved_base_makes_the_delta_step_raise(local):
    """ROADMAP Queue 3, item 8: manager A saves step 2 (all 2.0) and step 3
    (a delta, [0, 0] = 3.0); manager B saves step 2 again (all 5.0). The
    restore of step 3 refuses instead of returning 3.0 at [0, 0] over 5.0
    elsewhere; step 2 restores B's values."""
    a = CheckpointManager(local, block_bytes=1024)
    a.save(2, _grid(2.0))
    s3 = _grid(2.0)
    s3["w"][0, 0] = 3.0
    assert a.save(3, s3).dirty == {"w": [0]}
    np.testing.assert_array_equal(a.restore({"w": None}, step=3)[0]["w"], s3["w"])
    b = CheckpointManager(LocalServer(local.backend), block_bytes=1024)
    assert b.save(2, _grid(5.0)).dirty is None
    with pytest.raises(ValueError, match=r"step_3 .*step_2"):
        a.restore({"w": None}, step=3)
    np.testing.assert_array_equal(a.restore({"w": None}, step=2)[0]["w"], _grid(5.0)["w"])


def _restore_in_thread(cm, step, limit_s=10.0):
    """``cm.restore`` in a thread joined with a time limit; returns the
    restored leaves or the exception raised, and fails if it did not end."""
    out = {}

    def run():
        try:
            out["value"] = cm.restore({"w": None}, step=step)[0]
        except Exception as e:   # noqa: BLE001 - handed back to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit_s)
    assert not t.is_alive(), f"restore(step={step}) did not return within {limit_s} s"
    return out


def test_saving_a_lower_step_again_is_full_and_restore_returns(local):
    """ROADMAP Queue 3, item 9: saves of steps 2, 3 and 2 again by one
    manager. The second save of step 2 is full (no delta against step 3),
    so ``restore(step=2)`` returns its values, and step 3, a delta against
    the first step 2, raises."""
    cm = CheckpointManager(local, block_bytes=1024)
    cm.save(2, _grid(2.0))
    s3 = _grid(2.0)
    s3["w"][0, 0] = 3.0
    assert cm.save(3, s3).dirty is not None
    s2 = _grid(7.0)
    s2["w"][31, 31] = 8.0
    assert cm.save(2, s2).dirty is None
    got = _restore_in_thread(cm, 2)
    assert "error" not in got, got.get("error")
    np.testing.assert_array_equal(got["value"]["w"], s2["w"])
    got = _restore_in_thread(cm, 3)
    assert isinstance(got.get("error"), ValueError), got


def test_hand_written_delta_cycle_raises(local):
    """Two old-format ``.delta`` records (no base identity) that name each
    other: the chain walk raises instead of looping."""
    cm = CheckpointManager(local, block_bytes=1024)
    cm.save(1, _grid(1.0))
    cm.save(2, _grid(1.0))

    def make_cycle(fs):
        for step, base in ((1, 2), (2, 1)):
            fd = fs.open(f"{cm.root}/step_{step}/.delta", O_CREAT | O_TRUNC)
            fs.write(fd, json.dumps({"base": base, "dirty": {"w": []}}).encode())
            fs.close(fd)

    cm.runtime.invoke(make_cycle)
    got = _restore_in_thread(cm, 2)
    assert isinstance(got.get("error"), ValueError) and "loops" in str(got["error"]), got


def test_checkpoint_without_identities_still_restores(local):
    """A chain as written before saves had identities (no ``.id`` files,
    ``.delta`` naming its base by step only) restores by the chain walk."""
    cm = CheckpointManager(local, block_bytes=1024)
    cm.save(1, _grid(1.0))
    s2 = _grid(1.0)
    s2["w"][16, 3] = 4.0
    cm.save(2, s2)

    def strip_identities(fs):
        for step in (1, 2):
            fs.unlink(f"{cm.root}/step_{step}/.id")
        path = f"{cm.root}/step_2/.delta"
        fd = fs.open(path)
        rec = json.loads(fs.pread(fd, fs.fstat(fd)["st_size"], 0))
        fs.close(fd)
        del rec["base_id"]
        fd = fs.open(path, O_CREAT | O_TRUNC)
        fs.write(fd, json.dumps(rec).encode())
        fs.close(fd)

    cm.runtime.invoke(strip_identities)
    fresh = CheckpointManager(LocalServer(local.backend), block_bytes=1024)
    got, _ = fresh.restore({"w": None}, step=2)
    assert got["w"].tobytes() == s2["w"].tobytes()
    got, _ = fresh.restore({"w": None}, step=1)
    assert got["w"].tobytes() == _grid(1.0)["w"].tobytes()


def test_sigkill_during_save_never_restores_torn_checkpoint(tmp_path):
    """Twin of tests/test_checkpoint.py::test_sigkill_during_save_never_restores_torn_checkpoint:
    SIGKILL a real ``repro_torch.core.server`` process mid-save-stream,
    restart it on the same WAL directory: every acked save survives, and
    the latest pointer names a fully committed checkpoint (all leaves from
    the same step)."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    from repro_torch.core.remote import RemoteBackend

    repo_root = Path(__file__).resolve().parents[1]
    wal = tmp_path / "wal"

    def spawn():
        env = dict(os.environ)
        env["PYTHONPATH"] = str(repo_root / "src") + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.server",
             "--wal", str(wal), "--block-size", "4096"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(repo_root),
        )
        line = proc.stdout.readline()
        assert line.startswith("LISTENING"), (line, proc.stderr.read())
        return proc, int(line.split()[1])

    proc, port = spawn()
    rb = RemoteBackend("127.0.0.1", port)
    cm = CheckpointManager(LocalServer(rb))
    acked = []
    stop = threading.Event()

    def save_loop():
        step = 0
        while not stop.is_set():
            step += 1
            try:
                cm.save(step, state(float(step)), delta_from_last=False)
            except Exception:
                return                     # server died mid-save: expected
            acked.append(step)

    t = threading.Thread(target=save_loop)
    t.start()
    deadline = time.monotonic() + 30
    while len(acked) < 3 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert len(acked) >= 3
    proc.kill()                            # SIGKILL, mid-save with high odds
    proc.wait()
    stop.set()
    t.join()
    rb.close()

    proc2, port2 = spawn()                 # recovers checkpoint + WAL tail
    try:
        rb2 = RemoteBackend("127.0.0.1", port2)
        cm2 = CheckpointManager(LocalServer(rb2))
        step = cm2.latest_step()
        # acked saves are durable; a commit may outrun its lost ack, so
        # the recovered latest can only be >= the last acked step
        assert step is not None and step >= max(acked)
        restored, got = cm2.restore(state(), zero_copy=False)
        assert got == step
        np.testing.assert_array_equal(restored["params"]["w"],
                                      np.full((32, 32), float(step), np.float32))
        np.testing.assert_array_equal(restored["opt"]["m"], 0)
        rb2.close()
    finally:
        proc2.kill()
        proc2.wait()
