"""Networked RPC server hosting a transactional backend (paper §4.1's
Backend Service, finally behind a real socket).

``BackendServer`` wraps any in-process ``BackendAPI`` implementation —
monolithic ``BackendService`` or ``ShardedBackend`` — and serves it to
concurrent ``RemoteBackend`` clients over TCP:

  * **event-loop core**: one single-threaded ``selectors`` loop owns the
    listener and every connection. Sockets are non-blocking; requests
    are parsed straight out of each connection's ``recv_into`` buffer
    and replies accumulate in a per-connection scatter-gather
    ``SendQueue`` that leaves in one ``sendmsg`` per burst — block
    payloads ride as their own segments, uncopied. No per-connection
    reader threads, so a busy server spends its cycles on requests
    instead of GIL hand-offs between dozens of parked readers.
  * **fast ops inline, blockable ops pooled**: pure in-memory requests
    (fetches, lookups, sync, stats) are dispatched inline on the loop —
    no scheduling hop. Requests that may block (``begin`` group-commit
    windows, ``commit`` WAL fsyncs, lease grants, checkpoint cycles) go
    to a small worker pool and complete via a wakeup pipe back into the
    loop, which then queues the reply — an fsync never stalls the loop,
    and a slow commit cannot head-of-line block the reads pipelined
    behind it on the same connection.
  * **pipelined connections** (wire v2): every request frame carries a
    request id and replies are sent *as handlers finish*, out of order
    if a later request completes first. One connection therefore
    carries many in-flight requests — the client multiplexes futures by
    id instead of holding one pooled connection per outstanding call.
  * **one client RPC per logical operation**: ``begin`` and the batch
    ops (``fetch_blocks`` / ``fetch_metas`` / ``lookup_many`` /
    ``sync_files``) against a ``ShardedBackend`` are a single frame —
    the per-shard fan-out and the reply merge happen server-side, so the
    client pays one round trip, not one per shard or per item.
  * **durability**: pass ``wal_path`` and the server attaches a
    segmented ``SegmentedWal`` directory to the backend — commit acks
    then imply fsync'd log records. On start the directory is
    crash-recovered first: load the newest valid checkpoint, replay only
    the WAL tail after it, truncate the torn tail, resume the
    sequencers, and bump the epoch. (A pre-existing regular file at
    ``wal_path`` is served in the legacy single-file layout.)
  * **bounded recovery**: a background trigger (live-segment bytes or
    records-since-checkpoint, plus the ``T_CHECKPOINT`` admin op)
    rotates the log, snapshots the backend under a brief all-commit-lock
    freeze, serializes + installs the checkpoint concurrently with new
    commits, and deletes every covered segment — restart cost is
    O(tail), not O(history).
  * **pipelining backpressure**: each connection may have at most
    ``max_inflight_per_conn`` dispatched-but-unreplied blockable
    requests; past the cap the loop deregisters the connection's read
    event and stops parsing its buffer, so a hostile client flooding
    ``begin``/``commit`` frames stalls in its own TCP send path instead
    of growing the worker queue without bound. Completions re-arm the
    read event and resume parsing the already-buffered frames.
  * **fenced file-id allocation**: instead of proxying the coordinator
    counter one id at a time, the server grants *range leases*
    ``(epoch, start, count)``. Each grant is WAL-logged durably before
    it is sent, so a restarted server never re-grants overlapping ids;
    the epoch (bumped on every restart) fences stale clients — a lease
    refresh carrying an old epoch gets ``StaleEpoch`` and must re-lease.
  * **clean shutdown**: ``shutdown(drain=True)`` (what the standalone
    entry point does on SIGTERM/SIGINT) stops accepting, lets the loop
    finish in-flight requests and flush their replies, fsyncs the WAL,
    and only then tears the sockets down — no torn-tail noise for
    examples or orchestrators that stop the process politely.

Run standalone (the crash-recovery tests SIGKILL this process; SIGTERM
exits cleanly)::

    python -m repro.core.server --wal /tmp/faasfs.wal --shards 2
"""
from __future__ import annotations

import argparse
import hmac
import os
import queue
import selectors
import signal
import socket
import sys
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core import leases as leasemod
from repro_torch.core import obs
from repro_torch.core import wal as walmod
from repro_torch.core import wire
from repro_torch.core.api import BackendAPI
from repro_torch.core.backend import BackendService
from repro_torch.core.sharded import ShardedBackend
from repro_torch.core.types import CachePolicy, Conflict

#: cap on a single lease grant (a greedy client cannot drain the id space)
MAX_LEASE = 1 << 16

# ---------------------------------------------------------------------------
# server metrics (see core/obs.py and docs/observability.md). All label
# children are pre-bound here, at import time, keyed by msg type: the
# per-request work is a dict[int] lookup + one locked increment — no
# string joins, no allocation.
# ---------------------------------------------------------------------------
_OP_NAMES = {
    t: n for t, n in wire.MSG_NAMES.items()
    if t not in (wire.T_HELLO, wire.T_OK, wire.T_ERR)
}
_REQS = {
    t: obs.REGISTRY.counter(
        "faasfs_server_requests_total", labels=("op",),
        help="requests dispatched, by op",
    ).labels(n)
    for t, n in _OP_NAMES.items()
}
_EXEC_US = {
    t: obs.REGISTRY.histogram(
        "faasfs_server_exec_us", labels=("op",), unit="us",
        help="handler execution time (inline or worker), by op",
    ).labels(n)
    for t, n in _OP_NAMES.items()
}
_QWAIT_US = {
    t: obs.REGISTRY.histogram(
        "faasfs_server_queue_wait_us", labels=("op",), unit="us",
        help="parse-to-worker-start wait for pooled (blockable) ops",
    ).labels(n)
    for t, n in _OP_NAMES.items()
}
_BYTES_IN = obs.REGISTRY.counter(
    "faasfs_server_bytes_in_total", unit="bytes",
    help="bytes received across all connections",
).labels()
_BYTES_OUT = obs.REGISTRY.counter(
    "faasfs_server_bytes_out_total", unit="bytes",
    help="bytes flushed across all connections",
).labels()


class FileIdAllocator:
    """Epoch-fenced file-id range leases, durably logged before grant."""

    def __init__(self, wal: Optional[walmod.WriteAheadLog], epoch: int,
                 next_fid: int = 1):
        self.wal = wal
        self.epoch = epoch
        self._next = next_fid
        self._mu = threading.Lock()
        self.grants = 0

    def grant(self, client_epoch: int, count: int) -> Tuple[int, int, int]:
        """Returns ``(epoch, start, count)``. ``client_epoch`` 0 means
        "no lease yet"; a non-zero epoch from a previous server
        incarnation is fenced off."""
        if client_epoch and client_epoch != self.epoch:
            raise wire.StaleEpoch(
                f"lease epoch {client_epoch} fenced (server epoch "
                f"{self.epoch})"
            )
        count = max(1, min(int(count), MAX_LEASE))
        with self._mu:
            start = self._next
            self._next += count
            if self.wal is not None:
                # durable BEFORE the grant leaves the server
                lsn = self.wal.append(("lease", self.epoch, start, count))
                self.wal.sync(lsn)
            self.grants += 1
        return self.epoch, start, count

    def peek_next(self) -> int:
        """Current allocator position — the fid floor a checkpoint must
        record. The checkpointer calls this after rotating the WAL, so
        every lease record a compaction could delete is already counted
        (grants bump the counter before appending their record)."""
        with self._mu:
            return self._next


class _WorkerPool:
    """Minimal fixed-size pool: ``submit`` enqueues ``fn(*args)`` with
    no Future allocation — completion travels back to the event loop
    through the server's own wakeup pipe, not a pool abstraction."""

    def __init__(self, n: int, name: str = "faasfs-rpc"):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._shut = False
        self._threads = []
        for i in range(n):
            t = threading.Thread(
                target=self._run, name=f"{name}-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def submit(self, fn, *args) -> None:
        if self._shut:
            raise RuntimeError("worker pool is shut down")
        self._q.put((fn, args))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args = item
            fn(*args)

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        self._shut = True
        for _ in self._threads:
            self._q.put(None)
        if wait:
            for t in self._threads:
                t.join(timeout=timeout)


class _Conn:
    """Per-connection event-loop state: the rolling read buffer, the
    scatter-gather output queue, and the backpressure window."""

    __slots__ = ("sock", "reader", "out", "inflight", "mask", "closed",
                 "authed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.reader = wire.FrameReader(sock)
        self.out = wire.SendQueue()
        self.inflight = 0    # dispatched-but-unreplied blockable requests
        self.mask = 0        # currently registered selector events
        self.closed = False
        self.authed = False  # passed T_AUTH with the server's admin token


class BackendServer:
    #: checkpoint trigger defaults: compact once the live segments exceed
    #: this many bytes (or this many appended records, whichever first)
    CHECKPOINT_BYTES_DEFAULT = 16 << 20
    CHECKPOINT_RECORDS_DEFAULT = 50_000

    #: stop parsing/reading a connection whose unflushed replies exceed
    #: this many bytes — flow control toward a slow-reading client
    OUT_HIGH_WATER = 1 << 20

    def __init__(
        self,
        backend: BackendAPI,
        host: str = "127.0.0.1",
        port: int = 0,
        wal_path: Optional[str] = None,
        sync_mode: str = "fsync",
        max_workers: int = 16,
        max_inflight_per_conn: int = 64,
        checkpoint_bytes: Optional[int] = None,
        checkpoint_records: Optional[int] = None,
        checkpoint_interval_s: float = 0.25,
        slow_op_us: int = 50_000,
        admin_token: Optional[str] = None,
        resolve_addr: Optional[Tuple[str, int]] = None,
        lease_ttl_s: float = leasemod.DEFAULT_TTL_S,
        push_max_blocks: int = 64,
    ):
        self.backend = backend
        self.metrics = obs.REGISTRY
        self.slow_op_us = slow_op_us
        self.admin_token = admin_token
        self._resolve_addr = resolve_addr
        self.wal = None  # WriteAheadLog (legacy file) | SegmentedWal (dir)
        self.recovery: Optional[Dict[str, int]] = None
        self.max_inflight_per_conn = max(1, int(max_inflight_per_conn))
        self.checkpoint_bytes = (
            self.CHECKPOINT_BYTES_DEFAULT if checkpoint_bytes is None
            else checkpoint_bytes
        )
        self.checkpoint_records = (
            self.CHECKPOINT_RECORDS_DEFAULT if checkpoint_records is None
            else checkpoint_records
        )
        self.checkpoint_interval_s = checkpoint_interval_s
        self.checkpoints = 0            # completed checkpoint cycles
        self.checkpoint_failures = 0    # failed background cycles
        self._ckpt_mu = threading.Lock()  # one checkpoint at a time
        self._ckpt_appends = 0          # wal.appends at the last checkpoint
        # delta checkpoints: previous cycle's summary (covered seg +
        # version floor). None => next cycle writes a self-contained
        # full — in particular the FIRST cycle after any restart, so a
        # floor never crosses process lifetimes.
        self._ckpt_base: Optional[Dict] = None
        self.ckpt_chain_max = 8         # force a full every N deltas
        self._ckpt_thread: Optional[threading.Thread] = None
        epoch, next_fid = 1, 1
        if wal_path is not None:
            if os.path.isfile(wal_path):
                # legacy single-file log: recover + append, no compaction
                if os.path.getsize(wal_path) > 0:
                    self.recovery = walmod.recover(backend, wal_path)
                    epoch = self.recovery["epoch"] + 1
                    next_fid = self.recovery["fid_floor"]
                self.wal = walmod.WriteAheadLog(wal_path, sync_mode=sync_mode)
            else:
                # segmented directory: newest valid checkpoint + WAL tail
                self.recovery = walmod.recover_dir(backend, wal_path)
                epoch = self.recovery["epoch"] + 1
                next_fid = self.recovery["fid_floor"]
                self.wal = walmod.SegmentedWal(wal_path, sync_mode=sync_mode)
            self.wal.append(("epoch", epoch))
            self.wal.sync()
            self._ckpt_appends = self.wal.appends
            backend.set_wal(self.wal)  # type: ignore[attr-defined]
            if hasattr(backend, "finish_recovery"):
                # re-pin in-doubt prepares' slot locks before serving
                backend.finish_recovery()
        self.epoch = epoch
        self.allocator = FileIdAllocator(self.wal, epoch, next_fid)

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(128)
        self.host, self.port = self._lsock.getsockname()

        self._stop = threading.Event()    # begin shutdown: no new requests
        self._exit = threading.Event()    # loop must terminate now
        self._drained_evt = threading.Event()
        self._conns: Set[_Conn] = set()
        self._loop_thread: Optional[threading.Thread] = None
        # blockable requests run here so one connection can have many in
        # flight; completed replies hop back into the loop via the pipe
        self._workers = _WorkerPool(max_workers)
        # lock-RELEASING cluster ops (2PC decide, migration drop/abort)
        # get their own lane: if every general worker is parked inside a
        # prepare waiting on a slot lock, the decide that would release
        # it must still find a thread to run on
        self._release_workers = _WorkerPool(2, name="faasfs-release")
        self._completions: deque = deque()
        # lease tier: per-file read-lease holders, revoked at commit time
        # by push frames (req_id 0) queued here by worker threads and
        # written by the loop — put_frame is loop-thread-only
        self._leases = leasemod.LeaseTable(ttl_s=lease_ttl_s)
        self.push_max_blocks = max(0, int(push_max_blocks))
        self._push_jobs: deque = deque()
        self._inflight = 0               # dispatched blockable requests
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._wal_closed = False
        # live-state gauges: callback-backed, sampled only at scrape time
        # (zero hot-path cost). Labeled by listen address so several
        # servers — in one process, or scraped/merged into one registry
        # from many shard processes — never collide on one child.
        addr = (f"{self.host}:{self.port}",)
        self.metrics.gauge_fn(
            "faasfs_server_conns", lambda: len(self._conns),
            help="open client connections",
            labels=("addr",), label_values=addr,
        )
        self.metrics.gauge_fn(
            "faasfs_server_inflight", lambda: self._inflight,
            help="dispatched-but-unreplied blockable requests",
            labels=("addr",), label_values=addr,
        )
        self.metrics.gauge_fn(
            "faasfs_server_sendq_bytes",
            lambda: sum(c.out.size for c in list(self._conns)),
            unit="bytes", help="unflushed reply bytes across connections",
            labels=("addr",), label_values=addr,
        )
        self.metrics.gauge_fn(
            "faasfs_server_lease_holders",
            self._leases.holder_count,
            help="connections holding at least one read lease",
            labels=("addr",), label_values=addr,
        )

    # ------------------------------------------------------------------ #
    def start(self) -> "BackendServer":
        t = threading.Thread(
            target=self._loop, name="faasfs-loop", daemon=True
        )
        t.start()
        self._loop_thread = t
        if isinstance(self.wal, walmod.SegmentedWal) and (
            self.checkpoint_bytes or self.checkpoint_records
        ):
            ct = threading.Thread(
                target=self._ckpt_loop, name="faasfs-ckpt", daemon=True
            )
            ct.start()
            self._ckpt_thread = ct
        if self._resolve_addr is not None and getattr(
            self.backend, "in_doubt", lambda: []
        )():
            rt = threading.Thread(
                target=self._resolve_loop, name="faasfs-resolve", daemon=True
            )
            rt.start()
        return self

    def _resolve_loop(self) -> None:
        """Termination protocol for in-doubt 2PC participants: ask the
        coordinator (T_RESOLVE) for each recovered-but-undecided txid
        until every one is settled. The coordinator may independently
        push T_DECIDE at its own startup — decide() is idempotent, so
        both paths racing is fine."""
        backoff = 0.05
        while not self._stop.is_set():
            pending = self.backend.in_doubt()
            if not pending:
                return
            try:
                sock = socket.create_connection(self._resolve_addr, timeout=5)
                try:
                    wire.recv_frame(sock)  # hello
                    rid = 1
                    for txid in pending:
                        wire.send_frame(
                            sock, wire.T_RESOLVE, {"txid": list(txid)}, rid
                        )
                        mt, _, reply = wire.recv_frame(sock)
                        rid += 1
                        if mt != wire.T_OK:
                            continue
                        verdict = reply.get("d")
                        if verdict in ("c", "a"):
                            self.backend.decide(tuple(txid), verdict == "c")
                        # "pending": coordinator still deciding — retry
                finally:
                    sock.close()
            except OSError:
                pass  # coordinator not up yet: retry
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, 2.0)

    # ------------------------------------------------------------------ #
    # checkpoint + compaction (the admin op and the background trigger)
    # ------------------------------------------------------------------ #
    def run_checkpoint(self, full: bool = False) -> Dict[str, int]:
        """Force one checkpoint + compaction cycle now. Serialized with
        the background trigger; safe to call while commits are in flight
        (the commit locks are held only for the O(state) capture and the
        WAL rotation, not the serialization/fsync).

        Cycles after the first export DELTAS against the previous
        cycle's version floor (for backends that support it); every
        ``ckpt_chain_max``-th cycle — or ``full=True`` — writes a
        self-contained full, bounding recovery's chain walk."""
        wal = self.wal
        if not isinstance(wal, walmod.SegmentedWal):
            raise ValueError(
                "checkpointing requires a segmented WAL directory "
                "(server started without --wal, or with a legacy "
                "single-file log)"
            )
        with self._ckpt_mu:
            base = None if full else self._ckpt_base
            if base is not None and base.get("chain_len", 1) >= \
                    self.ckpt_chain_max:
                base = None
            summary = walmod.checkpoint_backend(
                wal, self.backend, self.epoch,
                next_fid_fn=self.allocator.peek_next, base=base,
            )
            self._ckpt_base = summary
            self._ckpt_appends = wal.appends
            self.checkpoints += 1
            return summary

    def _ckpt_due(self) -> bool:
        wal = self.wal
        if self.checkpoint_records and (
            wal.appends - self._ckpt_appends >= self.checkpoint_records
        ):
            return True
        if self.checkpoint_bytes and wal.live_bytes() >= self.checkpoint_bytes:
            return True
        return False

    def _ckpt_loop(self) -> None:
        delay = self.checkpoint_interval_s
        while not self._stop.wait(delay):
            try:
                if self._ckpt_due():
                    self.run_checkpoint()
                delay = self.checkpoint_interval_s
            except walmod.WalFailed:
                return  # poisoned log: no further durability work
            except Exception as e:
                # A failed cycle leaves a .tmp at worst (recovery ignores
                # it) — but each attempt also rotates the log, so retry
                # with exponential backoff instead of minting a fresh
                # segment file every tick against e.g. a full disk, and
                # say so instead of failing silently.
                self.checkpoint_failures += 1
                delay = min(max(delay, 0.05) * 2, 30.0)
                obs.LOG.warn(
                    "checkpoint_failed", error=repr(e), retry_in_s=delay,
                    failures=self.checkpoint_failures,
                )

    def serve_forever(self) -> None:
        self.start()
        self._stop.wait()

    def shutdown(self, drain: bool = False, drain_timeout_s: float = 10.0) -> None:
        """Stop the server. With ``drain=True``, in-flight requests are
        allowed to finish (and their replies to be flushed) and the WAL
        is fsync'd before any socket is torn down — the clean-SIGTERM
        path."""
        self._stop.set()
        # join the checkpoint trigger BEFORE touching the WAL: a tick
        # that already passed its _stop check must finish (or never
        # start) its cycle now — a stale daemon thread must not rotate /
        # install / delete segments after shutdown() returned and a new
        # incarnation reopened the directory. (_stop.wait wakes sleepers
        # immediately; the join only ever waits out an in-flight cycle.)
        ct = self._ckpt_thread
        if ct is not None and ct is not threading.current_thread():
            ct.join(timeout=drain_timeout_s)
        lt = self._loop_thread
        self._wake()
        if lt is None:
            # never started: nothing in flight, just close the listener
            try:
                self._lsock.close()
            except OSError:
                pass
        elif drain and lt.is_alive():
            # the loop keeps running: it stops reading, finishes the
            # dispatched requests, flushes every reply, then signals
            self._drained_evt.wait(timeout=drain_timeout_s)
            if self.wal is not None:
                try:
                    self.wal.sync()
                except Exception:
                    pass
        self._exit.set()
        self._wake()
        if lt is not None and lt is not threading.current_thread():
            lt.join(timeout=drain_timeout_s)
        if lt is None or not lt.is_alive():
            for fd in (self._wake_r, self._wake_w):
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._workers.shutdown(wait=drain)
        self._release_workers.shutdown(wait=drain)
        if self.wal is not None and not self._wal_closed:
            with self._ckpt_mu:  # let a mid-flight checkpoint finish
                self._wal_closed = True
                self.wal.close()

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\0")
        except OSError:
            pass  # pipe full (wakeup already pending) or already closed

    # ------------------------------------------------------------------ #
    # the event loop
    # ------------------------------------------------------------------ #
    def _loop(self) -> None:
        sel = selectors.DefaultSelector()
        self._lsock.setblocking(False)
        sel.register(self._lsock, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        listening = True
        try:
            while not self._exit.is_set():
                try:
                    events = sel.select()
                except OSError:
                    break
                for key, mask in events:
                    data = key.data
                    if data == "accept":
                        if listening:
                            self._on_accept(sel)
                    elif data == "wake":
                        try:
                            os.read(self._wake_r, 65536)
                        except OSError:
                            pass
                    else:
                        conn = data
                        if conn.closed:
                            continue
                        if mask & selectors.EVENT_READ:
                            self._on_readable(sel, conn)
                        if mask & selectors.EVENT_WRITE and not conn.closed:
                            self._pump_conn(sel, conn)
                if self._completions:
                    self._drain_completions(sel)
                if self._push_jobs:
                    self._drain_pushes(sel)
                if self._stop.is_set():
                    if listening:
                        listening = False
                        sel.unregister(self._lsock)
                        try:
                            self._lsock.close()
                        except OSError:
                            pass
                        # no more request parsing: deregister reads
                        for conn in list(self._conns):
                            self._update_events(sel, conn)
                    if self._inflight == 0 and all(
                        c.out.size == 0 for c in self._conns
                    ):
                        self._drained_evt.set()
        finally:
            if listening:
                try:
                    sel.unregister(self._lsock)
                except (KeyError, ValueError):
                    pass
                try:
                    self._lsock.close()
                except OSError:
                    pass
            for conn in list(self._conns):
                self._close_conn(sel, conn)
            sel.close()
            self._drained_evt.set()

    def _on_accept(self, sel) -> None:
        while True:
            try:
                sock, _ = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.setblocking(False)
            conn = _Conn(sock)
            self._conns.add(conn)
            conn.out.put_frame(wire.T_HELLO, self._hello(), 0,
                               mapv=self.reply_mapv())
            self._pump_conn(sel, conn)

    def _on_readable(self, sel, conn: _Conn) -> None:
        try:
            n = conn.reader.fill()
        except OSError:
            self._close_conn(sel, conn)
            return
        if n == 0:
            self._close_conn(sel, conn)
            return
        if n is None:
            return  # spurious wakeup
        _BYTES_IN.inc(n)
        self._pump_conn(sel, conn)

    def _pump_conn(self, sel, conn: _Conn) -> None:
        """Parse buffered frames (respecting the backpressure window and
        the output high-water mark), flush replies, re-arm events."""
        while not conn.closed:
            before = conn.reader.frames
            if not self._stop.is_set():
                self._parse_conn(sel, conn)
            if conn.closed:
                return
            self._flush_conn(sel, conn)
            if conn.closed:
                return
            if conn.reader.frames == before:
                break  # no parse progress: wait for socket events
            if conn.out.size >= self.OUT_HIGH_WATER:
                break  # still clogged toward the client
        if not conn.closed:
            self._update_events(sel, conn)

    @staticmethod
    def _lease_fids(obj: Any) -> Optional[List[int]]:
        """The validated ``"f"`` list of a T_LEASE / T_LEASE_RELEASE
        body, or None if the (well-framed but hostile) body is not a
        dict holding a list/tuple of ints."""
        if not isinstance(obj, dict):
            return None
        fids = obj.get("f")
        if fids is None:
            return []
        if not isinstance(fids, (list, tuple)):
            return None
        if not all(isinstance(f, int) for f in fids):
            return None
        return list(fids)

    def _parse_conn(self, sel, conn: _Conn) -> None:
        cap = self.max_inflight_per_conn
        reader = conn.reader
        out = conn.out
        while conn.inflight < cap and out.size < self.OUT_HIGH_WATER:
            try:
                frame = reader.next_frame()
            except wire.WireError:
                self._close_conn(sel, conn)  # malformed peer: drop it
                return
            if frame is None:
                return
            msg_type, req_id, obj = frame
            ctr = _REQS.get(msg_type)
            if ctr is not None:
                ctr.inc()
            if msg_type == wire.T_AUTH:
                # handled inline (needs the connection, which _dispatch
                # never sees). With no --admin-token configured, auth is
                # a benign no-op: everything is allowed anyway.
                token = obj.get("token") if isinstance(obj, dict) else None
                if self.admin_token is not None and not (
                    isinstance(token, str)
                    and hmac.compare_digest(token, self.admin_token)
                ):
                    out.put_frame(
                        wire.T_ERR,
                        wire.exception_to_obj(
                            wire.PermissionDenied("bad admin token")),
                        req_id, mapv=self.reply_mapv(),
                    )
                else:
                    conn.authed = True
                    out.put_frame(wire.T_OK, {"authed": True}, req_id,
                                  mapv=self.reply_mapv())
                continue
            if msg_type == wire.T_LEASE:
                # inline like T_AUTH: the holder IS the connection, which
                # _dispatch never sees. Leases are interest registrations
                # with a TTL — cheap dict inserts, never blocking. The
                # body is validated here like T_AUTH's: these handlers
                # run ON the event loop, so a wrong-typed field must
                # become a T_ERR reply, never an exception that unwinds
                # the loop for every connection.
                fids = self._lease_fids(obj)
                mode = (obj.get("m") if isinstance(obj, dict) else None) \
                    or leasemod.MODE_INV
                if fids is None or not isinstance(mode, str):
                    out.put_frame(
                        wire.T_ERR,
                        wire.exception_to_obj(
                            ValueError("bad lease body")),
                        req_id, mapv=self.reply_mapv(),
                    )
                    continue
                granted = self._leases.grant(conn, fids, mode)
                out.put_frame(
                    wire.T_OK,
                    {"e": self.epoch, "ttl": self._leases.ttl_s,
                     "g": granted},
                    req_id, mapv=self.reply_mapv(),
                )
                continue
            if msg_type == wire.T_LEASE_RELEASE:
                fids = self._lease_fids(obj)
                if fids is None:
                    out.put_frame(
                        wire.T_ERR,
                        wire.exception_to_obj(
                            ValueError("bad lease body")),
                        req_id, mapv=self.reply_mapv(),
                    )
                    continue
                n = self._leases.release(conn, fids)
                out.put_frame(wire.T_OK, {"r": n}, req_id,
                              mapv=self.reply_mapv())
                continue
            if (
                self.admin_token is not None
                and not conn.authed
                and msg_type in self._ADMIN_OPS
            ):
                op = _OP_NAMES.get(msg_type, str(msg_type))
                out.put_frame(
                    wire.T_ERR,
                    wire.exception_to_obj(wire.PermissionDenied(
                        f"{op} requires admin auth (T_AUTH with the "
                        "server's --admin-token)")),
                    req_id, mapv=self.reply_mapv(),
                )
                continue
            if msg_type in self._SLOW_OPS:
                pool = (
                    self._release_workers
                    if msg_type in self._RELEASE_OPS else self._workers
                )
                conn.inflight += 1
                self._inflight += 1
                try:
                    pool.submit(
                        self._work_one, conn, msg_type, req_id, obj,
                        obs.now_us(), reader.last_trace,
                    )
                except RuntimeError:  # pool shut down mid-race
                    conn.inflight -= 1
                    self._inflight -= 1
                    self._close_conn(sel, conn)
                    return
            else:
                t0 = obs.now_us()
                try:
                    reply_type, reply = (
                        wire.T_OK, self._dispatch(msg_type, obj)
                    )
                except Exception as e:  # backend errors travel as frames
                    reply_type, reply = wire.T_ERR, wire.exception_to_obj(e)
                dur = obs.now_us() - t0
                h = _EXEC_US.get(msg_type)
                if h is not None:
                    h.observe(dur)
                trace = reader.last_trace
                if trace is not None:
                    obs.SPANS.record(
                        f"server.exec.{_OP_NAMES.get(msg_type, msg_type)}",
                        "server", trace[0], obs.new_span_id(), t0, dur,
                        parent_id=trace[1],
                    )
                out.put_frame(reply_type, reply, req_id,
                              mapv=self.reply_mapv())

    def _work_one(self, conn: _Conn, msg_type: int, req_id: int,
                  obj: Any, t_enq: int, trace) -> None:
        # worker thread: compute, then hop back into the loop. The trace
        # context (propagated on the request frame) is installed for the
        # duration so nested spans — the WAL fsync — land in the same
        # timeline, under this op's span.
        op = _OP_NAMES.get(msg_type, str(msg_type))
        t0 = obs.now_us()
        _QWAIT_US[msg_type].observe(t0 - t_enq)
        span_id = 0
        prev = None
        if trace is not None:
            span_id = obs.new_span_id()
            obs.SPANS.record(f"server.queue.{op}", "server", trace[0],
                             obs.new_span_id(), t_enq, t0 - t_enq,
                             parent_id=trace[1])
            prev = obs.set_trace((trace[0], span_id))
        aborted = None
        try:
            reply_type, reply = wire.T_OK, self._dispatch(msg_type, obj)
        except Exception as e:
            if isinstance(e, Conflict):
                aborted = e
            reply_type, reply = wire.T_ERR, wire.exception_to_obj(e)
        finally:
            if trace is not None:
                obs.set_trace(prev)
        dur = obs.now_us() - t0
        _EXEC_US[msg_type].observe(dur)
        if trace is not None:
            obs.SPANS.record(f"server.exec.{op}", "server", trace[0],
                             span_id, t0, dur, parent_id=trace[1])
        if aborted is not None:
            obs.SLOW_OPS.record(
                f"abort.{op}", dur, detail=str(aborted),
                trace_id=trace[0] if trace else 0,
            )
        elif dur >= self.slow_op_us:
            obs.SLOW_OPS.record(
                f"slow.{op}", dur, trace_id=trace[0] if trace else 0,
            )
            obs.LOG.warn("slow_op", op=op, dur_us=dur,
                         trace=f"{trace[0]:016x}" if trace else "-")
        if msg_type == wire.T_COMMIT and reply_type == wire.T_OK:
            # revoke/push-update lease holders. Queued before the reply
            # completion so the loop writes the committer's ack and the
            # holders' invalidations in the same drain pass.
            self._queue_lease_pushes(obj, reply)
        self._completions.append((conn, reply_type, reply, req_id, trace))
        self._wake()

    def _queue_lease_pushes(self, obj: Any, reply: Any) -> None:
        """Worker thread, commit already durably applied: build one push
        frame per live lease holder of any touched file. The committer's
        own connection is NOT excluded — many clients multiplex one
        connection, and even for the writer itself the pre-commit view is
        now stale. Freshness-only: a failure here is counted, never
        surfaced to the committer."""
        try:
            fids, names, write_keys = leasemod.touched_obj(obj)
            if not fids:
                return
            holders = self._leases.holders_for(fids)
            if not holders:
                return
            commit_ts = reply.get("ts") if isinstance(reply, dict) else None
            blocks = None
            for hconn, (mode, hfids) in holders.items():
                body = {
                    "e": self.epoch, "f": hfids, "n": names,
                    "t": commit_ts, "us": obs.now_us(),
                }
                ptype = wire.T_INVALIDATE
                if mode == leasemod.MODE_PUSH and write_keys:
                    if blocks is None:  # lazily, once per commit
                        blocks = self._fetch_push_blocks(obj, reply,
                                                         write_keys)
                    hset = set(hfids)
                    hblocks = {
                        k: v for k, v in blocks.items() if k[0] in hset
                    }
                    if hblocks:
                        ptype = wire.T_PUSH_VERSION
                        body["b"] = hblocks
                # fan-out cost: one frame per holder per commit
                (leasemod._FANOUT_PUSH if ptype == wire.T_PUSH_VERSION
                 else leasemod._FANOUT_INV).inc()
                self._push_jobs.append((hconn, ptype, body))
            self._wake()
        except Exception:
            leasemod._PUSH_ERRORS.inc()

    def _fetch_push_blocks(self, obj: Any, reply: Any, write_keys):
        """The committed bytes for push-mode holders, re-read at latest.
        A block that raced PAST the committed version is skipped — the
        invalidation itself still ends the holder's view, so shipping
        nothing is always safe."""
        bv = reply.get("bv") if isinstance(reply, dict) else None
        if not isinstance(bv, dict):
            return {}
        keys = write_keys[: self.push_max_blocks]
        out = {}
        fetched = self.backend.fetch_blocks(keys, None)
        for k, ent in zip(keys, fetched):
            want = bv.get(k)
            if ent is not None and want is not None and ent[0] == want:
                out[k] = (ent[0], ent[1])
        return out

    def _drain_pushes(self, sel) -> None:
        touched = set()
        jobs = self._push_jobs
        while jobs:
            try:
                conn, ptype, body = jobs.popleft()
            except IndexError:
                break
            if conn.closed:
                continue
            conn.out.put_frame(ptype, body, 0, mapv=self.reply_mapv())
            touched.add(conn)
        for conn in touched:
            if not conn.closed:
                self._pump_conn(sel, conn)

    def _drain_completions(self, sel) -> None:
        touched = set()
        traced = []
        completions = self._completions
        t0 = obs.now_us()
        while completions:
            try:
                conn, reply_type, reply, req_id, trace = \
                    completions.popleft()
            except IndexError:
                break
            self._inflight -= 1
            conn.inflight -= 1
            if not conn.closed:
                conn.out.put_frame(reply_type, reply, req_id,
                                   mapv=self.reply_mapv())
                touched.add(conn)
                if trace is not None:
                    traced.append(trace)
        for conn in touched:
            if not conn.closed:
                # the freed window may unblock frames already buffered
                self._pump_conn(sel, conn)
        if traced:
            # one reply-flush span per traced completion in the burst
            dur = obs.now_us() - t0
            for trace in traced:
                obs.SPANS.record("server.flush", "server", trace[0],
                                 obs.new_span_id(), t0, dur,
                                 parent_id=trace[1])

    def _flush_conn(self, sel, conn: _Conn) -> None:
        if conn.out.size == 0:
            return
        before = conn.out.size
        try:
            conn.out.flush(conn.sock)
        except OSError:
            self._close_conn(sel, conn)
            return
        _BYTES_OUT.inc(before - conn.out.size)

    def _update_events(self, sel, conn: _Conn) -> None:
        want_r = (
            not self._stop.is_set()
            and conn.inflight < self.max_inflight_per_conn
            and conn.out.size < self.OUT_HIGH_WATER
        )
        want_w = conn.out.size > 0
        mask = (selectors.EVENT_READ if want_r else 0) | (
            selectors.EVENT_WRITE if want_w else 0
        )
        if mask == conn.mask:
            return
        try:
            if conn.mask == 0:
                sel.register(conn.sock, mask, conn)
            elif mask == 0:
                sel.unregister(conn.sock)
            else:
                sel.modify(conn.sock, mask, conn)
        except (KeyError, ValueError, OSError):
            self._close_conn(sel, conn)
            return
        conn.mask = mask

    def _close_conn(self, sel, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.mask:
            try:
                sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.mask = 0
        self._conns.discard(conn)
        self._leases.drop_holder(conn)  # leases die with the connection
        try:
            conn.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------------ #
    def _hello(self) -> Dict[str, Any]:
        return {
            "server": "faasfs",
            "version": wire.VERSION,
            "block_size": self.backend.block_size,
            "policy": self.backend.policy.value,
            # 0 = scalar timestamps (monolithic); N = sync vectors over N
            # fid-hash shards (the partition function is wire contract)
            "n_shards": getattr(self.backend, "n_shards", 0),
            "epoch": self.epoch,
            "lease_ttl": self._leases.ttl_s,
        }

    def reply_mapv(self) -> Optional[int]:
        """ShardMap version advertised on every reply frame (FLAG_MAPV
        envelope). None on a plain backend server; the cluster
        coordinator overrides this with its live map version so clients
        learn about rebalances passively, epoch-style."""
        return None

    #: requests that may block (commit-lock waits, group-commit windows,
    #: WAL fsyncs, checkpoint cycles) run on the worker pool so they
    #: cannot head-of-line block the fast reads pipelined behind them on
    #: the same connection; everything else is pure in-memory work
    #: handled inline on the event loop — no scheduling hop, and replies
    #: to a burst of buffered requests coalesce into one sendmsg
    _SLOW_OPS = frozenset((
        wire.T_BEGIN, wire.T_COMMIT, wire.T_ALLOC_RANGE, wire.T_CHECKPOINT,
        wire.T_PREPARE, wire.T_DECIDE, wire.T_SHARD_STATUS,
        wire.T_MIG_EXPORT, wire.T_MIG_IMPORT, wire.T_MIG_DROP,
        wire.T_MIG_ABORT, wire.T_REBALANCE,
    ))

    #: ops that RELEASE slot commit locks taken by an earlier request
    #: (2PC decide; migration drop/abort). They run on a dedicated lane
    #: — see _release_workers — so a prepare-saturated general pool can
    #: never deadlock the decide that would unblock it.
    _RELEASE_OPS = frozenset(
        (wire.T_DECIDE, wire.T_MIG_DROP, wire.T_MIG_ABORT)
    )

    #: admin-gated requests: when the server was started with
    #: --admin-token, these require a prior successful T_AUTH on the
    #: same connection. Checkpoint/trace-dump are operator tools; the
    #: 2PC and migration verbs are coordinator-only — an unauthenticated
    #: client must not be able to hold slot locks or move slot state.
    _ADMIN_OPS = frozenset((
        wire.T_CHECKPOINT, wire.T_TRACE_DUMP, wire.T_REBALANCE,
        wire.T_PREPARE, wire.T_DECIDE,
        wire.T_MIG_EXPORT, wire.T_MIG_IMPORT, wire.T_MIG_DROP,
        wire.T_MIG_ABORT,
    ))

    # ------------------------------------------------------------------ #
    def _dispatch(self, msg_type: int, obj: Any) -> Any:
        # NOTE reply trees use *lists* around block payloads (not tuples):
        # list elements pack incrementally, so a large bytes payload can
        # spill into its own sendmsg segment — a tuple's ext envelope
        # needs the packed length upfront and would force a copy. The
        # client decoders accept either shape.
        be = self.backend
        if msg_type == wire.T_BEGIN:
            cached = obj["k"]
            reply = be.begin(
                obj["t"],
                None if cached is None else {tuple(k) for k in cached},
                CachePolicy(obj["p"]) if obj["p"] is not None else None,
            )
            return wire.begin_reply_to_obj(reply)
        if msg_type == wire.T_COMMIT:
            return wire.commit_reply_to_obj(
                be.commit(wire.payload_from_obj(obj))
            )
        if msg_type == wire.T_FETCH_BLOCK:
            key, at_ts = obj
            return list(be.fetch_block(tuple(key), at_ts))
        if msg_type == wire.T_FETCH_BLOCKS:
            keys, at_ts = obj
            return [
                list(e)
                for e in be.fetch_blocks([tuple(k) for k in keys], at_ts)
            ]
        if msg_type == wire.T_FETCH_META:
            fid, at_ts = obj
            ver, meta = be.fetch_meta(fid, at_ts)
            return (ver, meta.length, meta.exists, meta.kind, meta.mtime_ts)
        if msg_type == wire.T_FETCH_METAS:
            fids, at_ts = obj
            return wire.metas_to_obj(be.fetch_metas(list(fids), at_ts))
        if msg_type == wire.T_LOOKUP:
            path, at_ts = obj
            return tuple(be.lookup(path, at_ts))
        if msg_type == wire.T_LOOKUP_MANY:
            paths, at_ts = obj
            return [tuple(e) for e in be.lookup_many(list(paths), at_ts)]
        if msg_type == wire.T_LISTDIR:
            prefix, at_ts = obj
            return [tuple(e) for e in be.listdir(prefix, at_ts)]
        if msg_type == wire.T_SYNC_FILE:
            fid, known = obj
            out = be.sync_file(fid, {tuple(k): v for k, v in known.items()})
            return {k: list(v) for k, v in out.items()}
        if msg_type == wire.T_SYNC_FILES:
            reqs = {
                fid: {tuple(k): v for k, v in known.items()}
                for fid, known in obj.items()
            }
            return {
                fid: {k: list(v) for k, v in upd.items()}
                for fid, upd in be.sync_files(reqs).items()
            }
        if msg_type == wire.T_ALLOC_RANGE:
            client_epoch, count = obj
            return tuple(self.allocator.grant(client_epoch, count))
        if msg_type == wire.T_CHECKPOINT:
            return dict(self.run_checkpoint())
        if msg_type == wire.T_STATS:
            # the metrics snapshot rides as an extra key: new-enough
            # clients surface it (RemoteBackend.metrics_snapshot), old
            # ones keep it on stats.extra (wire.stats_from_obj is
            # forward-compatible)
            d = wire.stats_to_obj(be.stats)
            d["metrics"] = self.metrics.snapshot()
            return d
        if msg_type == wire.T_TRACE_DUMP:
            clear = bool(obj.get("clear")) if isinstance(obj, dict) else False
            return {
                "spans": obs.SPANS.spans(clear=clear),
                "slow": obs.SLOW_OPS.entries(clear=clear),
            }
        if msg_type == wire.T_LATEST_TS:
            return be.latest_ts
        if msg_type == wire.T_PING:
            return None
        if msg_type == wire.T_PREPARE:
            ts_map = be.prepare(
                tuple(obj["txid"]),
                {int(s): wire.payload_from_obj(p)
                 for s, p in obj["parts"].items()},
            )
            return {"ts": {int(s): t for s, t in ts_map.items()}}
        if msg_type == wire.T_DECIDE:
            ts_map = be.decide(tuple(obj["txid"]), bool(obj["c"]))
            return {"ts": {int(s): t for s, t in ts_map.items()}}
        if msg_type == wire.T_SHARD_STATUS:
            dig = bool(obj.get("digests")) if isinstance(obj, dict) else False
            return be.shard_status(dig)
        if msg_type == wire.T_MIG_EXPORT:
            return {"states": be.mig_export([int(s) for s in obj["slots"]])}
        if msg_type == wire.T_MIG_IMPORT:
            be.mig_import([(int(s), st) for s, st in obj["states"]])
            return {"ok": True}
        if msg_type == wire.T_MIG_DROP:
            be.mig_drop([int(s) for s in obj["slots"]])
            return {"ok": True}
        if msg_type == wire.T_MIG_ABORT:
            be.mig_abort([int(s) for s in obj["slots"]])
            return {"ok": True}
        raise wire.WireError(f"unknown request type 0x{msg_type:02x}")


# --------------------------------------------------------------------------- #
# standalone entry point (crash-recovery tests SIGKILL this process;
# SIGTERM/SIGINT drain in-flight requests, fsync the WAL, and exit 0)
# --------------------------------------------------------------------------- #
def make_backend(
    n_shards: int,
    block_size: int,
    policy: str,
    versions_kept: int = 16,
    group_commit_window_s: float = 0.0,
    slots: Optional[List[int]] = None,
    n_slots: Optional[int] = None,
    name_by_parent: bool = False,
    commit_service_s: float = 0.0,
) -> BackendAPI:
    kwargs = dict(
        block_size=block_size,
        policy=CachePolicy(policy),
        versions_kept=versions_kept,
        group_commit_window_s=group_commit_window_s,
        commit_service_s=commit_service_s,
    )
    if n_shards <= 0 and slots is None and n_slots is None:
        return BackendService(**kwargs)
    return ShardedBackend(
        n_shards=n_shards if n_shards > 0 else 1,
        slots=slots, n_slots=n_slots, name_by_parent=name_by_parent,
        **kwargs,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="FaaSFS backend server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--wal", default=None,
                   help="durable log directory (segmented + checkpointed);"
                        " an existing regular file is served in the legacy"
                        " single-file layout")
    p.add_argument("--sync-mode", default="fsync", choices=walmod.SYNC_MODES)
    p.add_argument("--shards", type=int, default=0,
                   help="0 = monolithic backend, N = sharded")
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--policy", default="invalidate")
    p.add_argument("--versions-kept", type=int, default=16)
    p.add_argument("--group-window", type=float, default=0.0)
    p.add_argument("--checkpoint-bytes", type=int, default=None,
                   help="compact once live WAL segments exceed this size "
                        f"(default {BackendServer.CHECKPOINT_BYTES_DEFAULT}; "
                        "0 disables the size trigger)")
    p.add_argument("--checkpoint-records", type=int, default=None,
                   help="compact once this many records were appended since "
                        "the last checkpoint "
                        f"(default {BackendServer.CHECKPOINT_RECORDS_DEFAULT};"
                        " 0 disables the record trigger)")
    p.add_argument("--checkpoint-interval", type=float, default=0.25,
                   help="seconds between checkpoint-trigger checks")
    p.add_argument("--max-inflight", type=int, default=64,
                   help="per-connection cap on dispatched-but-unreplied "
                        "blockable requests (pipelining backpressure)")
    p.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warn", "error", "off"),
                   help="structured key=value stderr log level (the "
                        "LISTENING/SHUTDOWN stdout protocol lines are "
                        "unaffected)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="expose the metrics registry as Prometheus text "
                        "on this HTTP port (0 = ephemeral)")
    p.add_argument("--slow-op-us", type=int, default=50_000,
                   help="ops slower than this land in the slow-op log")
    p.add_argument("--slots", default=None,
                   help="comma-separated slot list this server owns "
                        "(cluster member mode; implies a sharded backend)")
    p.add_argument("--n-slots", type=int, default=None,
                   help="total slots in the cluster's partition space "
                        "(sync-vector width; fixed for the cluster's life)")
    p.add_argument("--admin-token", default=None,
                   help="shared secret gating admin + cluster-internal ops"
                        " (checkpoint, trace dump, 2PC, migration); unset ="
                        " open access")
    p.add_argument("--name-by-parent", action="store_true",
                   help="hash directory-entry keys by parent directory so"
                        " one dir's entries colocate on one slot")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the cluster coordinator, used to "
                        "resolve in-doubt 2PC txids after a crash restart")
    p.add_argument("--commit-service", type=float, default=0.0,
                   help="simulated per-commit service time in seconds "
                        "(benchmarks only)")
    p.add_argument("--crash-at", default=None,
                   help="failpoint name: SIGKILL this process the moment "
                        "the named crash point is reached (tests only)")
    args = p.parse_args(argv)

    obs.LOG.set_level(args.log_level)
    if args.crash_at:
        obs.CRASH_POINTS.add(args.crash_at)
    slots = None
    if args.slots is not None:
        slots = [int(s) for s in args.slots.split(",") if s != ""]
    resolve_addr = None
    if args.coordinator:
        chost, _, cport = args.coordinator.rpartition(":")
        resolve_addr = (chost, int(cport))
    backend = make_backend(
        args.shards, args.block_size, args.policy,
        versions_kept=args.versions_kept,
        group_commit_window_s=args.group_window,
        slots=slots, n_slots=args.n_slots,
        name_by_parent=args.name_by_parent,
        commit_service_s=args.commit_service,
    )
    server = BackendServer(
        backend, host=args.host, port=args.port,
        wal_path=args.wal, sync_mode=args.sync_mode,
        max_inflight_per_conn=args.max_inflight,
        checkpoint_bytes=args.checkpoint_bytes,
        checkpoint_records=args.checkpoint_records,
        checkpoint_interval_s=args.checkpoint_interval,
        slow_op_us=args.slow_op_us,
        admin_token=args.admin_token,
        resolve_addr=resolve_addr,
    )
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = obs.serve_metrics(args.metrics_port, server.metrics)
        obs.LOG.info("metrics_listening", port=metrics_srv.server_port)

    def _graceful(signum, frame):  # noqa: ARG001 - signal handler shape
        # wake serve_forever; the drain + WAL flush happen below, in the
        # main thread, so the handler itself stays tiny and reentrant
        server._stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    recovered = (server.recovery or {}).get("commits", 0)
    ckpt_seg = (server.recovery or {}).get("ckpt_seg", 0)
    print(f"LISTENING {server.port} epoch={server.epoch} "
          f"recovered={recovered} ckpt_seg={ckpt_seg}", flush=True)
    server.serve_forever()
    server.shutdown(drain=True)
    if metrics_srv is not None:
        metrics_srv.shutdown()
    print("SHUTDOWN clean", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
