"""Quickstart: the FaaSFS core API in five minutes.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
import numpy as np

from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS, O_CREAT, O_RDWR
from repro_torch.core.runtime import FunctionRuntime
from repro_torch.core.tensorstate import TensorStore, unflatten_like
from repro_torch.core.types import CachePolicy, Conflict


def run_function(local, fn, **kw):
    """Invoke ``fn`` as a cloud function (implicit BEGIN/COMMIT/retry).

    One-liner form of the function-first API; see docs/posix.md. For
    decorated functions use ``@runtime.function`` below."""
    return FunctionRuntime(local).invoke(fn, **kw)


def main() -> None:
    # ---- the backend service (paper: monolithic in-memory prototype) ----
    backend = BackendService(block_size=4096, policy=CachePolicy.EAGER)

    # ---- each worker gets a LocalServer (cache survives invocations);
    # readahead_blocks turns a sequential read's cache misses into ONE
    # batched fetch_blocks round trip that also warms the next blocks ----
    worker_a = LocalServer(backend, readahead_blocks=8)
    worker_b = LocalServer(backend, readahead_blocks=8)

    # ---- 1. a cloud function is an implicit transaction -----------------
    def write_config(fs: FaaSFS) -> None:
        fd = fs.open("/mnt/tsfs/app/config.json", O_CREAT)
        fs.write(fd, b'{"lr": 3e-4}')
        fs.close(fd)

    run_function(worker_a, write_config)
    print("1. committed config atomically at function return")

    # ---- 1b. the POSIX surface is errno-faithful: real directories,
    # access modes, vectored I/O, OSError subclasses with correct errno --
    def posix_surface(fs: FaaSFS) -> None:
        fs.makedirs("/mnt/tsfs/app/logs", exist_ok=True)
        assert fs.readdir("/mnt/tsfs/app") == ["config.json", "logs"]
        try:
            fs.rmdir("/mnt/tsfs/app")          # not empty
        except OSError as e:
            import errno as errno_mod
            assert e.errno == errno_mod.ENOTEMPTY
        fd = fs.open("/mnt/tsfs/app/logs/req", O_CREAT | O_RDWR)
        fs.pwritev(fd, [b"GET /", b" 200\n"], 0)   # one write, one iovec
        head, tail = fs.preadv(fd, [5, 5], 0)       # ONE fetch_blocks RPC
        assert head == b"GET /" and tail == b" 200\n"
        st = fs.stat("/mnt/tsfs/app/logs/req")      # full stat: size,
        assert st["st_size"] == 10                  # kind, mtime/ctime
        fs.close(fd)                                # (commit timestamps)

    run_function(worker_a, posix_surface)
    print("1b. errno-faithful VFS: real dirs, ENOTEMPTY, vectored I/O")

    # ---- 2. POSIX semantics: rename is atomic, reads are consistent -----
    def rotate(fs: FaaSFS) -> None:
        fd = fs.open("/mnt/tsfs/app/config.v2", O_CREAT)
        fs.write(fd, b'{"lr": 1e-4}')
        fs.close(fd)
        fs.rename("/mnt/tsfs/app/config.v2", "/mnt/tsfs/app/config.json")

    run_function(worker_a, rotate)
    print("2. atomic rename flipped the config")

    # ---- 3. optimistic concurrency: conflicts abort and retry -----------
    def bump_counter(fs: FaaSFS) -> None:
        fd = fs.open("/mnt/tsfs/app/counter", O_CREAT)
        raw = fs.pread(fd, 8, 0)
        n = int.from_bytes(raw, "little") if raw else 0
        fs.pwrite(fd, (n + 1).to_bytes(8, "little"), 0)

    import threading

    rt_a, rt_b = FunctionRuntime(worker_a), FunctionRuntime(worker_b)
    bump_a, bump_b = rt_a.function(bump_counter), rt_b.function(bump_counter)
    threads = [
        threading.Thread(target=lambda f=f: [f() for _ in range(50)])
        for f in (bump_a, bump_b)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    def read_counter(fs: FaaSFS) -> None:
        fd = fs.open("/mnt/tsfs/app/counter")
        print("3. counter after 2x50 concurrent increments:",
              int.from_bytes(fs.pread(fd, 8, 0), "little"),
              f"(aborts retried transparently; backend aborts={backend.stats.aborts})")

    run_function(worker_a, read_counter, read_only=True)

    # ---- 4. tensors as files: block-granular delta commits ---------------
    params = {"layer0": {"w": np.random.randn(256, 256).astype(np.float32)}}

    def save_params(fs: FaaSFS) -> None:
        TensorStore(fs).save("model", params, block_bytes=65536)

    run_function(worker_a, save_params)

    params2 = {"layer0": {"w": params["layer0"]["w"].copy()}}
    params2["layer0"]["w"][:4] += 0.01  # touch a slab
    stats = {}

    def save_delta(fs: FaaSFS) -> None:
        from repro_torch.core.tensorstate import flatten_with_names
        base = {n: a for n, a in flatten_with_names(params)}
        stats.update(TensorStore(fs).save("model", params2, baseline=base, block_bytes=65536))

    run_function(worker_a, save_delta)
    print(f"4. delta commit shipped {stats['bytes_written']:,} of "
          f"{stats['bytes_total']:,} bytes ({stats['blocks_written']} dirty blocks)")

    # ---- 5. snapshot reads: consistent state while writers commit --------
    txn = worker_b.begin(read_only=True)
    fs = FaaSFS(txn)
    pinned = TensorStore(fs).load("model")["layer0/w"]
    run_function(worker_a, save_params)  # concurrent new version
    pinned_again = TensorStore(fs).load("model")["layer0/w"]
    assert np.array_equal(pinned, pinned_again)
    txn.commit()
    print("5. snapshot reader saw a consistent version despite concurrent commits")

    # ---- 6. batch-first API: plural ops and futures ----------------------
    # Every backend (in-process, sharded, networked) implements ONE batch
    # surface; scalar calls are shims. A batch is one logical round trip.
    txn = worker_a.begin(read_only=True)
    fid = txn.lookup("/mnt/tsfs/app/config.json")
    keys = [(fid, 0)]
    versions_and_blocks = backend.fetch_blocks(keys)       # one round trip
    futs = [backend.submit("fetch_block", k) for k in keys]  # pipelined form
    assert [f.result() for f in futs] == versions_and_blocks
    txn.abort()
    print(f"6. fetched {len(keys)} block(s) in one batched call; "
          "futures resolve out of band on networked transports")

    # ---- 7. the real thing: a networked server, pipelined client, and a
    # clean SIGTERM teardown (drains in-flight requests, flushes the WAL —
    # no torn log tail for the next start to truncate) ---------------------
    import os
    import signal
    import subprocess
    import sys
    import tempfile

    from repro_torch.core.remote import RemoteBackend

    with tempfile.TemporaryDirectory() as td:
        env = dict(os.environ)
        env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.core.server",
             "--wal", os.path.join(td, "faasfs.wal")],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        port = int(proc.stdout.readline().split()[1])
        rb = RemoteBackend("127.0.0.1", port)
        remote_worker = LocalServer(rb, readahead_blocks=8)

        def remote_write(fs: FaaSFS) -> None:
            fd = fs.open("/mnt/tsfs/remote/hello", O_CREAT)
            fs.write(fd, b"over the wire, durably")

        run_function(remote_worker, remote_write)
        rb.close()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=15)
        tail = proc.stdout.read().strip()
        print(f"7. remote commit fsync'd; server exited {proc.returncode} "
              f"({tail})")


if __name__ == "__main__":
    main()
