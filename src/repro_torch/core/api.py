"""Backend transport API — the contract between clients and any backend.

The paper's prototype wires the Local Server directly to one in-process
monolithic backend. To grow past that (sharded backends, networked
transports), every client-visible operation is pinned down here as an
abstract ``BackendAPI``.

**Batch-first.** The abstract surface is *plural*: backends implement

  begin / sync_files / fetch_blocks / fetch_metas / lookup_many /
  listdir / commit / alloc_file_id

and the scalar forms the original API shipped with (``fetch_block``,
``fetch_meta``, ``lookup``, ``sync_file``) are concrete shims over the
batch core defined once, here. A backend therefore implements ONE
surface; clients may call either form, and a batch is one logical round
trip on every transport (`LatencyInjector` charges it as one, the wire
ships it as one frame, `ShardedBackend` fans it out and merges
server-side exactly like ``begin``).

**Futures.** ``submit(op, *args) -> BackendFuture`` is the pipelining
hook: callers get a completion handle instead of blocking the thread.
The default implementation runs the call inline (correct for every
in-process backend); ``RemoteBackend`` overrides it to put many requests
in flight on one multiplexed connection, matching request ids to
out-of-order replies (see docs/api.md and docs/transport.md).

A small *timestamp algebra* (``zero_ts`` / ``ts_geq`` /
``snapshot_cache_ok``) rides along so clients never interpret sync
timestamps themselves: the monolithic backend uses scalar timestamps,
the sharded backend a per-shard vector, and client code works unchanged
over both.

Transport concerns live in wrappers, not in the backend:
``LatencyInjector`` charges one simulated network round trip per
client-visible call — batch or scalar — replacing the old ad-hoc
``rpc_latency_s`` sleeps inside ``BackendService``. The real networked
transport is ``repro.core.remote.RemoteBackend`` — the same calls
serialized over a socket to ``repro.core.server.BackendServer`` (wire
format in ``repro.core.wire``, durable commit log in ``repro.core.wal``;
see docs/transport.md). ``bench_remote`` calibrates the injector's
simulated RTT against the real thing.
"""
from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.types import (
    BlockKey,
    CachePolicy,
    FileId,
    NotFound,
    SyncTimestamp,
    Timestamp,
)

if TYPE_CHECKING:  # avoid an import cycle with backend.py at runtime
    from repro_torch.core.backend import BeginReply


@dataclass
class CommitReply:
    """Result of a successful commit.

    ``ts``             — backend-assigned commit token, one uniform kind
                         per backend: the commit timestamp under the
                         monolithic backend (its read timestamp for
                         read-only commits), the coordinator's global
                         scalar timestamp under the sharded backend.
                         Monotone across a client's sequential commits;
                         informational only — never fed back into reads.
    ``block_versions`` — shard-local version assigned to each written
                         block, so the client can write committed data
                         through into its cache with the exact version
                         that commit validation will later compare.
    ``slot_ts``        — per-slot commit timestamps the commit advanced
                         (sharded backends only; empty elsewhere). A
                         cluster coordinator proxying the commit uses
                         these to advance its applied-vector view.
    """

    ts: SyncTimestamp
    block_versions: Dict[BlockKey, Timestamp] = field(default_factory=dict)
    slot_ts: Dict[int, Timestamp] = field(default_factory=dict)


class BackendFuture:
    """Completion handle for a pipelined backend call.

    A minimal future: ``result()`` blocks until the value (or error)
    arrives, ``done()`` polls. Produced completed by the default inline
    ``BackendAPI.submit`` and resolved asynchronously by transports that
    really pipeline (``RemoteBackend``'s reader thread).

    ``_flush`` is the transport's lazy-send hook: a pipelining client may
    buffer the request frame instead of paying a syscall (and a GIL
    hand-off) per submit; the first consumer about to wait triggers one
    coalesced flush of everything buffered behind it.

    ``_wait`` is the transport's serial fast-path hook: called (if set)
    with ``(future, timeout)`` before parking on the event, it lets the
    waiting thread drive the transport's receive path itself — the
    common serial RPC then completes with zero extra thread wakeups
    instead of hopping through a dedicated reader thread."""

    __slots__ = ("_event", "_value", "_error", "_flush", "_wait", "_obs")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._flush: Optional[Any] = None
        self._wait: Optional[Any] = None
        self._obs: Optional[Any] = None  # transport-stamped (t0_us, op, trace)

    def _ensure_sent(self) -> None:
        flush, self._flush = self._flush, None
        if flush is not None and not self._event.is_set():
            flush()

    # -- producer side ------------------------------------------------- #
    def set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    @classmethod
    def completed(cls, value: Any) -> "BackendFuture":
        f = cls()
        f.set_result(value)
        return f

    @classmethod
    def failed(cls, exc: BaseException) -> "BackendFuture":
        f = cls()
        f.set_exception(exc)
        return f

    # -- consumer side ------------------------------------------------- #
    def done(self) -> bool:
        if not self._event.is_set():
            self._ensure_sent()
            w = self._wait
            if w is not None and not self._event.is_set():
                w(self, 0)  # poll: nudge the transport, never block
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        self._ensure_sent()
        w = self._wait
        if w is not None and not self._event.is_set():
            w(self, timeout)
        if not self._event.wait(timeout):
            raise TimeoutError("backend call still in flight")
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        self._ensure_sent()
        w = self._wait
        if w is not None and not self._event.is_set():
            w(self, timeout)
        if not self._event.wait(timeout):
            raise TimeoutError("backend call still in flight")
        return self._error


class BackendAPI(ABC):
    """Abstract transactional backend (paper §4.1's Backend Service)."""

    # Implementations expose these (attribute or property):
    block_size: int
    policy: CachePolicy

    @property
    def zero_ts(self) -> SyncTimestamp:
        """The sync timestamp of a brand-new client (never synced)."""
        return 0

    # ------------------------- timestamp algebra ---------------------- #
    def ts_geq(self, a: SyncTimestamp, b: SyncTimestamp) -> bool:
        """a >= b, componentwise for vector timestamps."""
        return a >= b  # type: ignore[operator]

    def snapshot_cache_ok(
        self,
        key: BlockKey,
        version: Timestamp,
        at_ts: SyncTimestamp,
        last_sync_ts: SyncTimestamp,
    ) -> bool:
        """May a cached entry (``version``) serve a snapshot read at
        ``at_ts``?  Only if it is provably the latest version <= at_ts,
        i.e. the cache has been synced past the snapshot point."""
        return version <= at_ts and last_sync_ts >= at_ts  # type: ignore

    # ----------------------- RPCs: batch core ------------------------- #
    @abstractmethod
    def begin(
        self,
        last_sync_ts: SyncTimestamp,
        cached_keys: Optional[Set[BlockKey]] = None,
        policy: Optional[CachePolicy] = None,
    ) -> "BeginReply": ...

    @abstractmethod
    def fetch_blocks(
        self, keys: List[BlockKey], at_ts: Optional[SyncTimestamp] = None
    ) -> List[Tuple[Timestamp, bytes]]:
        """Current (or snapshot) contents of ``keys``, one entry per key,
        in input order. One logical round trip regardless of len(keys)."""

    @abstractmethod
    def fetch_metas(
        self, fids: List[FileId], at_ts: Optional[SyncTimestamp] = None
    ) -> List[Optional[Tuple[Timestamp, Any]]]:
        """Per-fid ``(version, FileMeta)`` in input order; ``None`` for a
        file the backend has never seen (the scalar shim raises
        ``NotFound`` for those)."""

    @abstractmethod
    def lookup_many(
        self, paths: List[str], at_ts: Optional[SyncTimestamp] = None
    ) -> List[Tuple[Timestamp, Optional[FileId]]]:
        """(observed name version, bound file id or None) per path,
        atomically per entry, in input order."""

    @abstractmethod
    def sync_files(
        self, reqs: Dict[FileId, Dict[BlockKey, Timestamp]]
    ) -> Dict[FileId, Dict[BlockKey, Tuple[Timestamp, bytes]]]:
        """Bring several files' cached blocks current in one round trip:
        ``{fid: {key: known_version}} -> {fid: {key: (version, data)}}``
        (only entries newer than the known version are returned)."""

    @abstractmethod
    def listdir(
        self, prefix: str, at_ts: Optional[SyncTimestamp] = None
    ) -> List[Tuple[str, Timestamp, Optional[FileId]]]:
        """Direct children of ``prefix`` as (full_path, version, fid);
        unbound tombstones are included (fid None) so callers can record
        the observed absence."""

    @abstractmethod
    def commit(self, payload) -> CommitReply:
        """OCC-validate and apply a TxnPayload; raises Conflict."""

    @abstractmethod
    def alloc_file_id(self) -> FileId: ...

    # ---------------------- zero-copy variant ------------------------- #
    def fetch_blocks_into(
        self,
        keys: List[BlockKey],
        at_ts: Optional[SyncTimestamp],
        sink,
    ) -> List[Tuple[Timestamp, Any]]:
        """``fetch_blocks`` that lands payloads in caller memory.

        ``sink(i, nbytes)`` is asked, per result index, for a writable
        memoryview of exactly ``nbytes``; when it returns one the
        payload is placed there and the result entry's data IS that
        view, otherwise the entry is the usual ``bytes``. The default
        shim copies once out of ``fetch_blocks`` (in-process backends
        hand out their interned store bytes, so this is the single
        materializing copy); ``RemoteBackend`` overrides it to decode
        straight out of the ``recv_into`` rolling buffer into the sink
        destination — zero bytes objects on the block hot path."""
        out: List[Tuple[Timestamp, Any]] = []
        for i, (ver, data) in enumerate(self.fetch_blocks(keys, at_ts)):
            dst = sink(i, len(data))
            if dst is not None:
                dst[:] = data
                out.append((ver, dst))
            else:
                out.append((ver, data))
        return out

    # ------------------- scalar shims over the batch core ------------- #
    def fetch_block(
        self, key: BlockKey, at_ts: Optional[SyncTimestamp] = None
    ) -> Tuple[Timestamp, bytes]:
        return self.fetch_blocks([key], at_ts)[0]

    def fetch_meta(self, fid: FileId, at_ts: Optional[SyncTimestamp] = None):
        out = self.fetch_metas([fid], at_ts)[0]
        if out is None:
            raise NotFound(f"file {fid}")
        return out

    def lookup(
        self, path: str, at_ts: Optional[SyncTimestamp] = None
    ) -> Tuple[Timestamp, Optional[FileId]]:
        return self.lookup_many([path], at_ts)[0]

    def sync_file(
        self, fid: FileId, known_versions: Dict[BlockKey, Timestamp]
    ) -> Dict[BlockKey, Tuple[Timestamp, bytes]]:
        return self.sync_files({fid: dict(known_versions)}).get(fid, {})

    # --------------------------- pipelining --------------------------- #
    def submit(self, op: str, *args, **kwargs) -> BackendFuture:
        """Asynchronous form of any RPC: returns a ``BackendFuture``
        instead of blocking. ``op`` names a method on this API
        (``"fetch_blocks"``, ``"commit"``, ...). The default executes
        inline — in-process backends have no round trip to hide;
        ``RemoteBackend`` overrides this with true request-id pipelining."""
        fut = BackendFuture()
        try:
            fut.set_result(getattr(self, op)(*args, **kwargs))
        except Exception as e:
            fut.set_exception(e)
        return fut


#: calls that cost one network round trip in the paper's EC2 deployment;
#: lookup/fetch_meta/listdir piggyback on other messages there. A batch
#: call is ONE round trip no matter how many items it carries.
DEFAULT_CHARGED_CALLS = (
    "begin",
    "sync_file",
    "sync_files",
    "fetch_block",
    "fetch_blocks",
    "commit",
)


class LatencyInjector(BackendAPI):
    """Transport wrapper charging a simulated RTT per client-visible call.

    Wrap any ``BackendAPI`` (monolithic or sharded) to model a networked
    deployment::

        be = LatencyInjector(BackendService(...), rpc_latency_s=100e-6)

    Batch calls are charged as ONE round trip — the whole point of the
    batch-first surface — so mono / sharded / remote backends stay
    comparable under the simulation.
    """

    def __init__(
        self,
        inner: BackendAPI,
        rpc_latency_s: float,
        charged_calls: Tuple[str, ...] = DEFAULT_CHARGED_CALLS,
    ):
        self.inner = inner
        self.rpc_latency_s = rpc_latency_s
        self.charged_calls = frozenset(charged_calls)

    def _rpc(self, call: str) -> None:
        if self.rpc_latency_s and call in self.charged_calls:
            time.sleep(self.rpc_latency_s)

    # -------------------------- delegation ---------------------------- #
    @property
    def block_size(self) -> int:
        return self.inner.block_size

    @property
    def policy(self) -> CachePolicy:
        return self.inner.policy

    @property
    def zero_ts(self) -> SyncTimestamp:
        return self.inner.zero_ts

    @property
    def stats(self):
        return self.inner.stats

    @property
    def latest_ts(self):
        return self.inner.latest_ts

    def ts_geq(self, a, b) -> bool:
        return self.inner.ts_geq(a, b)

    def snapshot_cache_ok(self, key, version, at_ts, last_sync_ts) -> bool:
        return self.inner.snapshot_cache_ok(key, version, at_ts, last_sync_ts)

    def begin(self, last_sync_ts, cached_keys=None, policy=None):
        self._rpc("begin")
        return self.inner.begin(last_sync_ts, cached_keys, policy)

    def fetch_blocks(self, keys, at_ts=None):
        self._rpc("fetch_blocks")
        return self.inner.fetch_blocks(keys, at_ts)

    def fetch_metas(self, fids, at_ts=None):
        self._rpc("fetch_meta")
        return self.inner.fetch_metas(fids, at_ts)

    def lookup_many(self, paths, at_ts=None):
        self._rpc("lookup")
        return self.inner.lookup_many(paths, at_ts)

    def sync_files(self, reqs):
        self._rpc("sync_files")
        return self.inner.sync_files(reqs)

    def fetch_block(self, key, at_ts=None):
        self._rpc("fetch_block")
        return self.inner.fetch_block(key, at_ts)

    def fetch_meta(self, fid, at_ts=None):
        self._rpc("fetch_meta")
        return self.inner.fetch_meta(fid, at_ts)

    def lookup(self, path, at_ts=None):
        self._rpc("lookup")
        return self.inner.lookup(path, at_ts)

    def sync_file(self, fid, known_versions):
        self._rpc("sync_file")
        return self.inner.sync_file(fid, known_versions)

    def listdir(self, prefix, at_ts=None):
        self._rpc("listdir")
        return self.inner.listdir(prefix, at_ts)

    def commit(self, payload) -> CommitReply:
        self._rpc("commit")
        return self.inner.commit(payload)

    def alloc_file_id(self) -> FileId:
        self._rpc("alloc_file_id")
        return self.inner.alloc_file_id()
