"""``RemoteBackend`` — the networked transport as just another
``BackendAPI``.

The client side of `repro.core.server`: every RPC becomes one frame
exchange, so ``LocalServer`` / the POSIX facade / the OCC and snapshot
test suites run unchanged over a real socket.

Design points:

  * **One multiplexed connection** (wire v2). Every request frame
    carries a request id; a dedicated reader thread routes each reply to
    the ``BackendFuture`` registered under that id, so MANY requests are
    in flight on one socket and replies may arrive out of order as
    server handlers finish. ``submit(op, *args)`` exposes the pipeline
    to callers; the blocking methods are just ``submit(...).result()``.
    This replaces PR 2's pool-per-in-flight-request model
    (``PooledRemoteBackend`` below survives only so ``bench_remote`` can
    keep measuring the old design against the new one).
  * **Batch ops are one frame.** ``fetch_blocks`` / ``fetch_metas`` /
    ``lookup_many`` / ``sync_files`` ship the whole batch in a single
    request; against a sharded server the fan-out and merge run
    server-side, exactly like ``begin``.
  * **Connection death fans out.** If the socket dies — peer closed,
    frame corruption, or a local ``close()`` — every pending future
    fails with a typed ``ConnectionClosed`` instead of hanging; the next
    call transparently re-dials (picking up epoch bumps from the new
    hello). Stray replies (unknown or already-answered request ids) are
    counted and dropped, never mis-delivered.
  * **Push direction.** Frames the server originates carry request id 0
    (client ids start at 1) and route to a handler registered via
    ``set_push_handler`` — the lease/invalidation tier
    (`repro.core.leases`) subscribes here. With no handler registered
    they are counted (``pushes_dropped``) and discarded.
  * **Hello handshake.** The server's first frame pins the wire version
    and carries ``block_size`` / ``policy`` / ``n_shards`` / ``epoch``,
    so one client class speaks to monolithic (scalar timestamps) and
    sharded (sync-vector) backends alike. Sync timestamps stay opaque
    values the client only moves through the timestamp algebra; for the
    vector algebra the client mirrors the fid-hash partition function
    ``shard = fid % n_shards`` — the partition map is part of the wire
    contract, exactly like a client-side shard map in λFS-style systems.
  * **Leased file ids.** ``alloc_file_id`` draws from an
    ``(epoch, start, count)`` range lease granted (and durably logged)
    by the server, refreshed when drained — one RPC per *lease*, not per
    id. A server restart bumps the epoch; a stale lease refresh gets
    ``StaleEpoch`` and transparently re-leases from scratch.
"""
from __future__ import annotations

import socket
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import obs, wire
from repro_torch.core.api import BackendAPI, BackendFuture, CommitReply
from repro_torch.core.blockstore import FileMeta
from repro_torch.core.types import BlockKey, CachePolicy, FileId, Timestamp

DEFAULT_LEASE = 64

# client-side metrics, pre-bound at import time (see core/obs.py)
_RPC_US = obs.REGISTRY.histogram(
    "faasfs_client_rpc_us", unit="us",
    help="submit-to-reply latency per RPC",
).labels()
_STRAYS = obs.REGISTRY.counter(
    "faasfs_client_stray_replies_total",
    help="unknown/duplicate reply ids dropped",
).labels()
_PUSHES_DROPPED = obs.REGISTRY.counter(
    "faasfs_client_pushes_dropped_total",
    help="server-initiated push frames dropped (no handler registered)",
).labels()

#: ops submit() can put on the wire without blocking; everything else
#: (alloc_file_id with its lease state, stats, ...) falls back to inline
_Decoder = Optional[Callable[[Any], Any]]


class _RemoteCore(BackendAPI):
    """Handshake, timestamp algebra, lease-based id allocation, and the
    RPC encode/decode surface — shared by the multiplexed client and the
    legacy pooled client. Subclasses provide ``_call`` (one blocking
    frame exchange)."""

    def __init__(self, host: str, port: int, lease_size: int = DEFAULT_LEASE,
                 connect_timeout_s: float = 10.0,
                 admin_token: Optional[str] = None):
        self.host = host
        self.port = port
        self.lease_size = lease_size
        self.connect_timeout_s = connect_timeout_s
        self.admin_token = admin_token
        self._hello: Optional[Dict] = None
        self._alloc_mu = threading.Lock()
        self._lease_epoch = 0
        self._lease_next = 0
        self._lease_end = 0
        self.rpcs = 0
        self.reconnects = 0
        self.disconnects = 0
        self._closed = False

    # -- transport hook ------------------------------------------------ #
    def _call(self, msg_type: int, obj: Any, decode: _Decoder = None) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def _handshake(self, sock: socket.socket) -> None:
        try:
            msg_type, _, hello = wire.recv_frame(sock)
        except BaseException:
            sock.close()
            raise
        if msg_type != wire.T_HELLO:
            sock.close()
            raise wire.WireError(f"expected hello, got 0x{msg_type:02x}")
        if self._hello is not None and hello["n_shards"] != self._hello["n_shards"]:
            sock.close()
            raise wire.WireError(
                "server changed shard count mid-session "
                f"({self._hello['n_shards']} -> {hello['n_shards']})"
            )
        self._hello = hello  # pick up epoch bumps on reconnect
        self.reconnects += 1

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout stays armed through the hello: a server
        # that accepts but never greets must not wedge the dialer (the
        # mux client dials under its state lock — an unbounded hello
        # read would block every other caller, close() included)
        self._handshake(sock)
        if self.admin_token is not None:
            # authenticate synchronously on every (re)dial, still under
            # the connect timeout: auth is per-connection server state,
            # so a transparent reconnect must re-establish it before any
            # admin-gated frame can be pipelined behind it
            try:
                wire.send_frame(sock, wire.T_AUTH,
                                {"token": self.admin_token}, 0)
                reply_type, _, reply = wire.recv_frame(sock)
            except BaseException:
                sock.close()
                raise
            if reply_type == wire.T_ERR:
                sock.close()
                raise wire.exception_from_obj(reply)
        sock.settimeout(None)
        return sock

    # ------------------------------------------------------------------ #
    # handshake-derived properties
    # ------------------------------------------------------------------ #
    @property
    def block_size(self) -> int:
        return self._hello["block_size"]

    @property
    def policy(self) -> CachePolicy:
        return CachePolicy(self._hello["policy"])

    @property
    def n_shards(self) -> int:
        """0 = scalar-timestamp (monolithic) server."""
        return self._hello["n_shards"]

    @property
    def server_epoch(self) -> int:
        return self._hello["epoch"]

    # ------------------------------------------------------------------ #
    # timestamp algebra (local: mirrors the server's backend kind)
    # ------------------------------------------------------------------ #
    @property
    def zero_ts(self):
        n = self.n_shards
        return 0 if n == 0 else (0,) * n

    def ts_geq(self, a, b) -> bool:
        if self.n_shards == 0:
            return a >= b
        return all(x >= y for x, y in zip(a, b))

    def snapshot_cache_ok(self, key, version, at_ts, last_sync_ts) -> bool:
        if self.n_shards == 0:
            return version <= at_ts and last_sync_ts >= at_ts
        s = key[0] % self.n_shards  # fid-hash partition: wire contract
        return version <= at_ts[s] and last_sync_ts[s] >= at_ts[s]

    # ------------------------------------------------------------------ #
    # RPC encoders/decoders (shared by blocking calls and submit())
    # ------------------------------------------------------------------ #
    def _frame_for(self, op: str, *args, **kwargs):
        """(msg_type, body, decode) for a pipelinable op, or None when the
        op needs local state (alloc_file_id) / has no frame mapping."""
        enc = getattr(self, f"_enc_{op}", None)
        if enc is None:
            return None
        return enc(*args, **kwargs)

    def _enc_begin(self, last_sync_ts, cached_keys=None, policy=None):
        return (
            wire.T_BEGIN,
            {
                "t": last_sync_ts,
                "k": None if cached_keys is None else sorted(cached_keys),
                "p": None if policy is None else policy.value,
            },
            wire.begin_reply_from_obj,
        )

    def _enc_commit(self, payload):
        return wire.T_COMMIT, wire.payload_to_obj(payload), wire.commit_reply_from_obj

    def _enc_fetch_block(self, key, at_ts=None):
        return wire.T_FETCH_BLOCK, (tuple(key), at_ts), lambda r: (r[0], r[1])

    def _enc_fetch_blocks(self, keys, at_ts=None):
        return (
            wire.T_FETCH_BLOCKS,
            ([tuple(k) for k in keys], at_ts),
            lambda r: [(ver, data) for ver, data in r],
        )

    def _enc_fetch_meta(self, fid, at_ts=None):
        return (
            wire.T_FETCH_META,
            (fid, at_ts),
            lambda r: (r[0], FileMeta(r[1], r[2], r[3], r[4])),
        )

    def _enc_fetch_metas(self, fids, at_ts=None):
        return wire.T_FETCH_METAS, (list(fids), at_ts), wire.metas_from_obj

    def _enc_lookup(self, path, at_ts=None):
        return wire.T_LOOKUP, (path, at_ts), lambda r: (r[0], r[1])

    def _enc_lookup_many(self, paths, at_ts=None):
        return (
            wire.T_LOOKUP_MANY,
            (list(paths), at_ts),
            lambda r: [(ver, fid) for ver, fid in r],
        )

    def _enc_listdir(self, prefix, at_ts=None):
        return (
            wire.T_LISTDIR,
            (prefix, at_ts),
            lambda r: [(path, ver, fid) for path, ver, fid in r],
        )

    def _enc_sync_file(self, fid, known_versions):
        return (
            wire.T_SYNC_FILE,
            (fid, dict(known_versions)),
            lambda r: {tuple(k): (ts, data) for k, (ts, data) in r.items()},
        )

    def _enc_sync_files(self, reqs):
        return (
            wire.T_SYNC_FILES,
            {fid: dict(known) for fid, known in reqs.items()},
            lambda r: {
                fid: {tuple(k): (ts, data) for k, (ts, data) in upd.items()}
                for fid, upd in r.items()
            },
        )

    # ------------------------------------------------------------------ #
    # BackendAPI surface: every RPC is one (pipelinable) frame exchange
    # ------------------------------------------------------------------ #
    def begin(self, last_sync_ts, cached_keys: Optional[Set[BlockKey]] = None,
              policy: Optional[CachePolicy] = None):
        # ONE frame regardless of shard count: the per-shard fan-out and
        # reply merge run server-side behind ShardedBackend.begin
        return self._call(*self._enc_begin(last_sync_ts, cached_keys, policy))

    def commit(self, payload) -> CommitReply:
        return self._call(*self._enc_commit(payload))

    def fetch_block(self, key: BlockKey, at_ts=None):
        return self._call(*self._enc_fetch_block(key, at_ts))

    def fetch_blocks(self, keys: List[BlockKey], at_ts=None):
        return self._call(*self._enc_fetch_blocks(keys, at_ts))

    def fetch_blocks_into(self, keys: List[BlockKey], at_ts, sink):
        """Zero-copy ``fetch_blocks``: block payloads decode straight out
        of the reader's ``recv_into`` rolling buffer into whatever
        writable memoryview ``sink(i, nbytes)`` returns (arena or tensor
        memory), skipping the per-payload ``bytes`` materialization.

        The T_FETCH_BLOCKS reply carries exactly one bin per key, in key
        order, and versions never encode as bins — so the wire-level bin
        sink maps positionally onto the API-level sink. If the reply is
        decoded without the sink (reader replaced by a redial, or an
        error reply) the future fails typed or the entries come back as
        plain bytes; callers must accept both."""
        mt, body, decode = self._enc_fetch_blocks(keys, at_ts)
        counter = [0]

        def wire_sink(nbytes):
            i = counter[0]
            counter[0] += 1
            if i >= len(keys):
                return None
            return sink(i, nbytes)

        return self.submit_frame(mt, body, decode, sink=wire_sink).result()

    def fetch_meta(self, fid: FileId, at_ts=None):
        return self._call(*self._enc_fetch_meta(fid, at_ts))

    def fetch_metas(self, fids: List[FileId], at_ts=None):
        return self._call(*self._enc_fetch_metas(fids, at_ts))

    def lookup(self, path: str, at_ts=None):
        return self._call(*self._enc_lookup(path, at_ts))

    def lookup_many(self, paths: List[str], at_ts=None):
        return self._call(*self._enc_lookup_many(paths, at_ts))

    def listdir(self, prefix: str, at_ts=None):
        return self._call(*self._enc_listdir(prefix, at_ts))

    def sync_file(self, fid: FileId, known_versions: Dict[BlockKey, Timestamp]):
        return self._call(*self._enc_sync_file(fid, known_versions))

    def sync_files(self, reqs):
        return self._call(*self._enc_sync_files(reqs))

    def alloc_file_id(self) -> FileId:
        with self._alloc_mu:
            if self._lease_next >= self._lease_end:
                self._refill_lease()
            fid = self._lease_next
            self._lease_next += 1
            return fid

    def _refill_lease(self) -> None:
        try:
            epoch, start, count = self._call(
                wire.T_ALLOC_RANGE, (self._lease_epoch, self.lease_size)
            )
        except wire.StaleEpoch:
            # server restarted since our lease: drop it and re-lease fresh
            self._lease_epoch = 0
            epoch, start, count = self._call(
                wire.T_ALLOC_RANGE, (0, self.lease_size)
            )
        self._lease_epoch = epoch
        self._lease_next = start
        self._lease_end = start + count

    # ------------------------------------------------------------------ #
    # observability passthrough (tests/benchmarks read these)
    # ------------------------------------------------------------------ #
    @property
    def stats(self):
        return self._call(wire.T_STATS, None, wire.stats_from_obj)

    @property
    def latest_ts(self):
        return self._call(wire.T_LATEST_TS, None)

    def ping(self) -> None:
        self._call(wire.T_PING, None)

    def checkpoint(self) -> Dict[str, int]:
        """Admin op: force a server-side WAL checkpoint + compaction
        cycle; returns its summary ``{seg, bytes, segments_removed}``."""
        return self._call(wire.T_CHECKPOINT, None)

    def trace_dump(self, clear: bool = False) -> Dict[str, Any]:
        """Admin op: drain the server's span ring + slow-op log —
        ``{"spans": [...], "slow": [...]}`` (see core/obs.py)."""
        return self._call(wire.T_TRACE_DUMP, {"clear": bool(clear)})

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Server-side metrics registry snapshot, riding on T_STATS as a
        forward-compatible extra key (old clients just ignore it)."""
        s = self.stats
        return getattr(s, "extra", {}).get("metrics", {})


class RemoteBackend(_RemoteCore):
    """Multiplexed, pipelined transport (the default).

    ``submit(op, *args)`` puts the request on the wire and returns a
    ``BackendFuture`` immediately; replies (possibly out of order) are
    matched back to futures by request id. Blocking calls are futures
    the caller waits on — one code path either way.

    **Serial fast path.** Receiving is lease-based: whichever thread
    blocks first on an unresolved future takes the *reader lease* and
    recvs replies itself, resolving every future whose reply it sees —
    a serial RPC therefore completes on the calling thread with zero
    extra wakeups (the pre-PR-6 design crossed ~2: reader-thread recv,
    then event hand-off to the caller). A standing reader thread still
    exists, but parked: it only reads when woken for timed waits or
    hand-offs, plus a low-frequency opportunistic drain that catches
    unsolicited frames (stray replies, server FIN) while no caller is
    waiting."""

    #: parked-reader tick: how often the standing reader opportunistically
    #: drains the socket when nobody holds the lease
    IDLE_TICK = 0.05
    #: follower retry tick while another thread holds the reader lease
    FOLLOW_TICK = 0.05

    def __init__(self, host: str, port: int, lease_size: int = DEFAULT_LEASE,
                 connect_timeout_s: float = 10.0,
                 admin_token: Optional[str] = None):
        super().__init__(host, port, lease_size, connect_timeout_s,
                         admin_token=admin_token)
        self._mu = threading.Lock()          # conn state + pending table
        self._send_mu = threading.Lock()     # guards the send buffer
        self._write_mu = threading.Lock()    # serializes socket writes
        self._send_buf = bytearray()         # frames awaiting a flush
        self._send_sock: Optional[socket.socket] = None
        self._sock: Optional[socket.socket] = None
        self._rdr: Optional[wire.FrameReader] = None
        self._reader: Optional[threading.Thread] = None
        self._rx_lease = threading.Lock()    # whoever holds it recvs
        self._rx_wake = threading.Event()    # kicks the parked reader
        self._next_id = 1
        self._pending: Dict[int, Tuple[BackendFuture, _Decoder]] = {}
        self._push_handler: Optional[Callable[[int, Any], None]] = None
        self.pushes = 0          # server-initiated frames delivered
        self.pushes_dropped = 0  # server-initiated frames w/o a handler
        self.stray_replies = 0   # unknown/duplicate request ids observed
        self.flushes = 0         # coalesced sends actually performed
        self.lease_completions = 0   # replies read by a waiting caller
        self.parked_completions = 0  # replies read by the parked reader
        self._rdr_base = 0       # bytes_copied carried over dead readers
        self._sunk_base = 0      # bytes_sunk carried over dead readers
        self._frames_base = 0    # frame count carried over dead readers
        # eager dial: surfaces connection/handshake errors at construction
        with self._mu:
            self._connect_locked()

    # ------------------------------------------------------------------ #
    # connection lifecycle
    # ------------------------------------------------------------------ #
    def _connect_locked(self) -> socket.socket:
        sock = self._dial()
        self._sock = sock
        self._rdr = wire.FrameReader(sock)
        if self._reader is None:
            # ONE standing (parked) reader for the client's lifetime —
            # reconnects swap the socket, not the thread
            t = threading.Thread(
                target=self._reader_loop,
                name="faasfs-mux-reader", daemon=True,
            )
            t.start()
            self._reader = t
        return sock

    # ------------------------------------------------------------------ #
    # receive path (always under the reader lease)
    # ------------------------------------------------------------------ #
    def set_push_handler(
        self, handler: Optional[Callable[[int, Any], None]]
    ) -> None:
        """Register ``handler(msg_type, obj)`` for server-initiated frames
        (request id 0 — the push direction of the mux connection). The
        handler runs on whichever thread holds the reader lease, so it
        must be fast and must never call back into this client's blocking
        RPC surface. ``None`` unregisters."""
        self._push_handler = handler

    def _dispatch_push(self, msg_type: int, obj: Any) -> None:
        handler = self._push_handler
        if handler is None:
            # push direction active but nobody subscribed: drop, but
            # separately from strays — a stray is a protocol anomaly, an
            # unhandled push is merely an unused feature
            self.pushes_dropped += 1
            _PUSHES_DROPPED.inc()
            return
        self.pushes += 1
        try:
            handler(msg_type, obj)
        except Exception:
            # a buggy push consumer must not kill the receive path that
            # every pending RPC on this connection depends on
            obs.REGISTRY.counter(
                "faasfs_client_push_handler_errors_total",
                help="exceptions raised by the registered push handler",
            ).labels().inc()

    def _dispatch_reply(self, msg_type: int, req_id: int, obj: Any,
                        parked: bool = False) -> None:
        if req_id == 0:
            # server-initiated frame: request id 0 is never allocated by
            # submit_frame (ids start at 1), so this is unambiguously the
            # push direction, not a reply
            self._dispatch_push(msg_type, obj)
            return
        with self._mu:
            entry = self._pending.pop(req_id, None)
        if entry is None:
            # unknown or already-answered id: never mis-deliver — count
            # it and keep the stream (framing is intact)
            self.stray_replies += 1
            _STRAYS.inc()
            return
        fut, decode = entry
        if parked:
            self.parked_completions += 1
        else:
            self.lease_completions += 1
        ob = fut._obs
        if ob is not None:
            fut._obs = None
            t0, opname, trace = ob
            dur = obs.now_us() - t0
            _RPC_US.observe(dur)
            if trace is not None:
                obs.SPANS.record(
                    f"rpc.{opname}", "client", trace[0], trace[1],
                    t0, dur, parent_id=trace[2],
                )
        if msg_type == wire.T_ERR:
            fut.set_exception(wire.exception_from_obj(obj))
        elif msg_type == wire.T_OK:
            try:
                fut.set_result(obj if decode is None else decode(obj))
            except Exception as e:  # decoder bug ≠ wedged caller
                fut.set_exception(e)
        else:
            fut.set_exception(
                wire.WireError(f"unexpected reply type 0x{msg_type:02x}")
            )

    def _rx_block(self, sock, rdr, parked: bool = False) -> bool:
        """Blocking read of at least one frame, then drain whatever else
        is already buffered — one recv resolves a whole reply burst."""
        try:
            self._dispatch_reply(*rdr.recv_frame(), parked=parked)
            while True:
                frame = rdr.next_frame()
                if frame is None:
                    return True
                self._dispatch_reply(*frame, parked=parked)
        except (wire.WireError, OSError) as e:
            self._fail_conn(sock, e)
            return False

    def _rx_opportunistic(self, sock, rdr) -> None:
        """Drain frames that already arrived, without ever blocking."""
        try:
            while True:
                frame = rdr.next_frame()
                if frame is None:
                    n = rdr.fill(socket.MSG_DONTWAIT)
                    if n is None:
                        return  # nothing queued in the kernel
                    if n == 0:
                        raise wire.ConnectionClosed("socket closed")
                    continue
                self._dispatch_reply(*frame, parked=True)
        except (wire.WireError, OSError) as e:
            self._fail_conn(sock, e)

    def _reader_loop(self) -> None:
        while True:
            self._rx_wake.wait(self.IDLE_TICK)
            if self._closed:
                return
            self._rx_wake.clear()
            self._drain_replies()

    def _drain_replies(self) -> None:
        while True:
            if not self._rx_lease.acquire(blocking=False):
                return  # a waiting caller is reading; it hands back
            try:
                if self._closed:
                    return
                with self._mu:
                    sock, rdr = self._sock, self._rdr
                    has_pending = bool(self._pending)
                if sock is None or rdr is None:
                    return
                if has_pending:
                    if not self._rx_block(sock, rdr, parked=True):
                        return
                    # loop: re-check for still-pending requests
                else:
                    self._rx_opportunistic(sock, rdr)
                    return
            finally:
                self._rx_lease.release()

    def _wait_for(self, fut: BackendFuture, timeout) -> None:
        """``BackendFuture._wait`` hook: drive the receive path from the
        waiting thread (untimed waits), or kick the parked reader and
        let the caller park on the event (timed waits / done() polls)."""
        ev = fut._event
        if timeout is not None:
            self._rx_wake.set()
            return
        while not ev.is_set():
            if self._rx_lease.acquire(blocking=False):
                try:
                    if ev.is_set():
                        break
                    with self._mu:
                        sock, rdr = self._sock, self._rdr
                    if sock is None or rdr is None:
                        # connection gone: _fail_conn / close resolves
                        # our future; tolerate the tiny re-dial window
                        ev.wait(0.01)
                        continue
                    self._rx_block(sock, rdr)
                finally:
                    self._rx_lease.release()
            else:
                # another thread holds the lease; its reads resolve our
                # event, and the tick guards the lease hand-off race
                ev.wait(self.FOLLOW_TICK)
        with self._mu:
            others = bool(self._pending)
        if others:
            self._rx_wake.set()  # hand off: wake the parked reader

    def _fail_conn(self, sock: socket.socket, cause: BaseException) -> None:
        """Tear down ``sock`` and fail every future still waiting on it.
        A stale socket (already replaced by a reconnect) only gets closed
        — the pending table belongs to the current connection.

        Ordering matters: futures are failed BEFORE the send buffer is
        cleared. ``submit_frame`` buffers only while its future is still
        unresolved (checked under ``_send_mu``), so a request racing this
        teardown either sees its future already failed and never buffers,
        or buffers first and has its bytes swept here — a frame whose
        caller was told ConnectionClosed can never be flushed onto a
        replacement connection later."""
        with self._mu:
            current = self._sock is sock
            if current:
                if self._rdr is not None:
                    self._rdr_base += self._rdr.bytes_copied
                    self._sunk_base += self._rdr.bytes_sunk
                    self._frames_base += self._rdr.frames
                self._sock = None
                self._rdr = None
                self.disconnects += 1
                pending, self._pending = self._pending, {}
            else:
                pending = {}
        if pending:
            exc = (
                cause
                if isinstance(cause, wire.ConnectionClosed)
                else wire.ConnectionClosed(f"connection lost: {cause}")
            )
            for fut, _ in pending.values():
                fut.set_exception(exc)
        with self._send_mu:
            if self._send_sock is sock:
                self._send_buf = bytearray()
                self._send_sock = None
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._mu:
            self._closed = True
            sock, self._sock = self._sock, None
            if self._rdr is not None:
                self._rdr_base += self._rdr.bytes_copied
                self._sunk_base += self._rdr.bytes_sunk
                self._frames_base += self._rdr.frames
            self._rdr = None
            pending, self._pending = self._pending, {}
        self._rx_wake.set()  # unpark the reader so it can exit
        # in-flight requests fail typed instead of hanging or leaking;
        # fail-then-sweep ordering as in _fail_conn
        for fut, _ in pending.values():
            fut.set_exception(wire.ConnectionClosed("client closed"))
        with self._send_mu:
            self._send_buf = bytearray()
            self._send_sock = None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        reader = self._reader
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=1.0)

    def mapv_seen(self) -> Optional[int]:
        """Highest ShardMap version any reply frame on the current
        connection has advertised (FLAG_MAPV envelope), or None. The
        cluster client compares this against its cached map to notice
        rebalances passively, without a StaleShardMap bounce."""
        with self._mu:
            rdr = self._rdr
            return rdr.last_mapv if rdr is not None else None

    def connection_stats(self) -> Dict[str, Any]:
        """Public transport-health snapshot (tests and benchmarks assert
        on this instead of reaching into private fields)."""
        with self._mu:
            rdr = self._rdr
            pending = len(self._pending)
            connected = self._sock is not None
            bytes_copied = self._rdr_base + (rdr.bytes_copied if rdr else 0)
            bytes_sunk = self._sunk_base + (rdr.bytes_sunk if rdr else 0)
            frames = self._frames_base + (rdr.frames if rdr else 0)
        return {
            "rpcs": self.rpcs,
            # _handshake counts every dial including the first; redials
            # is what a health check actually wants
            "redials": max(0, self.reconnects - 1),
            "disconnects": self.disconnects,
            "stray_replies": self.stray_replies,
            "flushes": self.flushes,
            "bytes_copied": bytes_copied,
            "bytes_sunk": bytes_sunk,
            "frames": frames,
            "lease_completions": self.lease_completions,
            "parked_completions": self.parked_completions,
            "pushes": self.pushes,
            "pushes_dropped": self.pushes_dropped,
            "pending": pending,
            "connected": connected,
        }

    # ------------------------------------------------------------------ #
    # the pipeline
    # ------------------------------------------------------------------ #
    #: a submit burst larger than this flushes eagerly instead of waiting
    #: for a consumer to block on one of its futures
    MAX_SEND_BUF = 256 * 1024

    def submit_frame(
        self, msg_type: int, obj: Any, decode: _Decoder = None,
        sink=None,
    ) -> BackendFuture:
        """Register a future under a fresh request id and buffer the frame
        for the wire; the reader thread resolves it. The frame goes out on
        the first of: a consumer blocking on any future of this client
        (flush-on-wait), the buffer exceeding ``MAX_SEND_BUF``, or the
        next blocking call — so a burst of submits costs ONE coalesced
        send instead of a syscall + GIL hand-off each."""
        fut = BackendFuture()
        with self._mu:
            if self._closed:
                fut.set_exception(wire.ConnectionClosed("client closed"))
                return fut
            sock = self._sock
            if sock is None:
                try:
                    sock = self._connect_locked()
                except OSError as e:
                    fut.set_exception(
                        wire.ConnectionClosed(f"reconnect failed: {e}")
                    )
                    return fut
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = (fut, decode)
            if sink is not None and self._rdr is not None:
                # armed on THIS reader only: a redial replaces the reader
                # (and fails this future), so a sink can never fire against
                # a reply from a different connection generation
                self._rdr.set_sink(rid, sink)
        self.rpcs += 1
        # trace context rides the frame (16-byte envelope, FLAG_TRACE);
        # untraced requests stay byte-identical to the v2 wire format
        ctx = obs.current_trace()
        if ctx is not None:
            span_id = obs.new_span_id()
            trace: Optional[Tuple[int, int]] = (ctx[0], span_id)
            span3: Optional[Tuple[int, int, int]] = (ctx[0], span_id, ctx[1])
        else:
            trace = None
            span3 = None
        fut._obs = (
            obs.now_us(), wire.MSG_NAMES.get(msg_type, hex(msg_type)), span3,
        )
        with self._send_mu:
            if fut.done():
                # the connection died between registration and here and
                # _fail_conn already failed this future (and will sweep /
                # has swept the buffer): never buffer a frame whose
                # caller has been told ConnectionClosed — it must not be
                # flushed onto a replacement connection later
                return fut
            wire.encode_frame_into(self._send_buf, msg_type, obj, rid, trace)
            self._send_sock = sock
            big = len(self._send_buf) >= self.MAX_SEND_BUF
        fut._flush = self._flush_sends
        fut._wait = self._wait_for
        if big:
            self._flush_sends()
        return fut

    def _flush_sends(self) -> None:
        """Push every buffered request frame onto the socket in one send."""
        with self._send_mu:
            if not self._send_buf:
                return
            buf, self._send_buf = self._send_buf, bytearray()
            sock, self._send_sock = self._send_sock, None
        if sock is None:
            return
        try:
            with self._write_mu:
                sock.sendall(buf)
            self.flushes += 1
        except OSError as e:
            self._fail_conn(sock, e)  # fails the buffered futures too

    def submit(self, op: str, *args, **kwargs) -> BackendFuture:
        frame = self._frame_for(op, *args, **kwargs)
        if frame is None:  # lease-stateful / local ops run inline
            return super().submit(op, *args, **kwargs)
        return self.submit_frame(*frame)

    def _call(self, msg_type: int, obj: Any, decode: _Decoder = None) -> Any:
        return self.submit_frame(msg_type, obj, decode).result()


class PooledRemoteBackend(_RemoteCore):
    """PR 2's pool-per-in-flight-request transport, kept ONLY as the
    benchmark baseline (``bench_remote`` pooled-vs-pipelined rows) — one
    synchronous request per checked-out connection, concurrency by
    growing the pool."""

    def __init__(self, host: str, port: int, lease_size: int = DEFAULT_LEASE,
                 connect_timeout_s: float = 10.0,
                 admin_token: Optional[str] = None):
        super().__init__(host, port, lease_size, connect_timeout_s,
                         admin_token=admin_token)
        self._pool: List[socket.socket] = []
        self._pool_mu = threading.Lock()
        with self._pool_mu:
            self._pool.append(self._dial())

    @contextmanager
    def _conn(self):
        with self._pool_mu:
            sock = self._pool.pop() if self._pool else None
        if sock is None:
            sock = self._dial()
        try:
            yield sock
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        else:
            with self._pool_mu:
                if self._closed:
                    sock.close()
                else:
                    self._pool.append(sock)

    def _call(self, msg_type: int, obj: Any, decode: _Decoder = None) -> Any:
        self.rpcs += 1
        with self._conn() as sock:
            wire.send_frame(sock, msg_type, obj, 1)
            reply_type, _, reply = wire.recv_frame(sock)
        if reply_type == wire.T_OK:
            return reply if decode is None else decode(reply)
        if reply_type == wire.T_ERR:
            raise wire.exception_from_obj(reply)
        raise wire.WireError(f"unexpected reply type 0x{reply_type:02x}")

    def close(self) -> None:
        with self._pool_mu:
            self._closed = True
            conns, self._pool = self._pool, []
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass
