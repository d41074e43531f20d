"""The FaaSFS Local Server + Transactional Client (paper §4.1, Fig 2-3).

One ``LocalServer`` lives inside each cloud-function instance (for us: each
training/serving worker). It holds the block cache across invocations (the
paper's key performance lever: instances are reused, caches survive between
requests) and speaks to *any* backend through the abstract ``BackendAPI``
(in-process monolithic, sharded, latency-injected, or — eventually — a
networked transport).

A ``Transaction`` is implicitly created per function invocation: all lock
and read operations succeed locally and speculatively; reads record the
observed block versions in **R**, writes buffer (offset, bytes) patches in
**W**, and POSIX length semantics are captured as predicates — all shipped
to the backend at commit for OCC validation.

Sync timestamps (``last_sync_ts``, ``read_ts``) are opaque here: scalar
for the monolithic backend, a per-shard vector for the sharded one. All
comparisons go through the backend's timestamp algebra (``ts_geq`` /
``snapshot_cache_ok``), so this layer is shard-agnostic.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.api import BackendAPI
from repro_torch.core.backend import TxnPayload
from repro_torch.core.types import (
    KIND_DIR,
    KIND_FILE,
    LOCK_BLOCK_INDEX,
    META_TOUCH,
    BlockKey,
    CachePolicy,
    Conflict,
    FileId,
    LengthPredicate,
    NotFound,
    PredicateKind,
    ReadRecord,
    SyncTimestamp,
    Timestamp,
    TxnStateError,
    WriteRecord,
    meta_set,
)


@dataclass
class CacheEntry:
    version: Timestamp
    data: bytes


class LocalServer:
    """Per-worker block cache + backend connection (survives invocations).

    The cache is a true LRU: hits move entries to the MRU end, inserts
    evict from the LRU end once ``max_blocks`` is reached.

    ``readahead_blocks`` > 0 turns on contiguous-block read-ahead: a
    multi-block read that misses extends its (single) batched
    ``fetch_blocks`` round trip with up to that many following blocks of
    the same file, warming the LRU for the sequential access patterns
    checkpoint restore and model loading are made of. Speculative blocks
    are never recorded as transactional reads and don't touch the
    hit/miss counters until a transaction actually asks for them."""

    def __init__(
        self,
        backend: BackendAPI,
        policy: Optional[CachePolicy] = None,
        max_blocks: int = 65536,
        readahead_blocks: int = 0,
    ):
        self.backend = backend
        self.policy = policy or backend.policy
        self.max_blocks = max_blocks
        self.readahead_blocks = readahead_blocks
        self.cache: "OrderedDict[BlockKey, CacheEntry]" = OrderedDict()
        self.synced_files: Dict[FileId, SyncTimestamp] = {}
        self.last_sync_ts: SyncTimestamp = backend.zero_ts
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetched = 0
        # begins currently between their cached_keys snapshot and their
        # reply application, counted under _lock: lease-tier push warming
        # must pause while one is in flight, because a pushed block absent
        # from that snapshot is invisible to the begin diff (leases.py)
        self._begins_inflight = 0
        # bounded-staleness lease tier (core/leases.py); attached via
        # leases.attach_lease_tier, shared by every function running in
        # this container
        self.lease_tier = None

    # ------------------------------------------------------------------ #
    def begin(
        self,
        read_only: bool = False,
        max_staleness_s: Optional[float] = None,
    ) -> "Transaction":
        tier = self.lease_tier
        if read_only and tier is not None:
            # bounded-staleness view: reuse the LAST real begin's read
            # timestamp with zero round trips while it is within bound
            # and no commit-time revocation ended it. A snapshot at a
            # fixed past timestamp is immutable history, so this is
            # always serializable — the bound caps freshness, not safety.
            vts = tier.try_view(max_staleness_s)
            if vts is not None:
                txn = Transaction(self, vts, read_only=True)
                txn.lease_view = True
                return txn
        token = tier.begin_token() if tier is not None else None
        with self._lock:
            # snapshot under the lock: concurrent cache hits reorder the
            # LRU (move_to_end), which would break a bare iteration
            cached_keys = set(self.cache)
            last_sync = self.last_sync_ts
            self._begins_inflight += 1
        reply = None
        try:
            reply = self.backend.begin(last_sync, cached_keys, self.policy)
        finally:
            # decrement and apply under ONE lock acquisition: a lease
            # push applied between them would see the begin as done while
            # last_sync_ts still predates the reply (leases.py warms only
            # when _begins_inflight == 0)
            with self._lock:
                self._begins_inflight -= 1
                if reply is not None:
                    for key, (ver, data) in reply.updates.items():
                        self._put(key, ver, data)
                    for key in reply.invalidations:
                        self.cache.pop(key, None)
                    for fid in reply.file_invalidations:
                        self.synced_files.pop(fid, None)
                        for key in [k for k in self.cache if k[0] == fid]:
                            self.cache.pop(key, None)
                    if self.policy != CachePolicy.STALE:
                        self.last_sync_ts = reply.read_ts
        if tier is not None:
            tier.on_real_begin(reply.read_ts, token)
        return Transaction(self, reply.read_ts, read_only=read_only)

    def _put(self, key: BlockKey, version: Timestamp, data: bytes) -> None:
        if key in self.cache:
            self.cache.move_to_end(key)
            self.cache[key] = CacheEntry(version, data)
            return
        if len(self.cache) >= self.max_blocks:
            self.cache.popitem(last=False)  # evict least-recently-used
            self.evictions += 1
        self.cache[key] = CacheEntry(version, data)

    def cache_stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "size": len(self.cache),
                "capacity": self.max_blocks,
            }

    def cached_read(
        self, key: BlockKey, at_ts: Optional[SyncTimestamp] = None
    ) -> Tuple[Timestamp, bytes]:
        with self._lock:
            ent = self.cache.get(key)
            if ent is not None:
                if at_ts is None:
                    # optimistic path: staleness is caught at commit validation
                    self.hits += 1
                    self.cache.move_to_end(key)
                    return ent.version, ent.data
                if self.backend.snapshot_cache_ok(
                    key, ent.version, at_ts, self.last_sync_ts
                ):
                    # snapshot path: the entry is provably the latest version
                    # <= at_ts only if the cache has been synced past at_ts
                    self.hits += 1
                    self.cache.move_to_end(key)
                    return ent.version, ent.data
        self.misses += 1
        ver, data = self.backend.fetch_block(key, at_ts)
        with self._lock:
            if at_ts is None or at_ts == self.last_sync_ts:
                # a fetch at exactly last_sync_ts returns the latest
                # version <= last_sync_ts — precisely the invariant a
                # cache entry must satisfy, so snapshot reads at the sync
                # point (lease-tier views) may warm the LRU too
                self._put(key, ver, data)
        return ver, data

    def read_blocks(
        self,
        keys: List[BlockKey],
        at_ts: Optional[SyncTimestamp] = None,
        extra: Tuple[BlockKey, ...] = (),
    ) -> Dict[BlockKey, Tuple[Timestamp, bytes]]:
        """Read many blocks with ONE backend round trip for all misses.

        ``keys`` are demanded (hit/miss accounted exactly like
        ``cached_read``); ``extra`` are speculative read-ahead candidates
        that ride along in the same ``fetch_blocks`` call, warm the LRU,
        and are NOT returned or counted. Speculation is optimistic-path
        only (``at_ts is None``) — snapshot reads at arbitrary past
        timestamps cannot populate the cache, so prefetching there would
        be a wasted fetch."""
        out: Dict[BlockKey, Tuple[Timestamp, bytes]] = {}
        to_fetch: List[BlockKey] = []
        demanded = set(keys)
        with self._lock:
            for key in keys:
                ent = self.cache.get(key)
                ok = ent is not None and (
                    at_ts is None
                    or self.backend.snapshot_cache_ok(
                        key, ent.version, at_ts, self.last_sync_ts
                    )
                )
                if ok:
                    self.hits += 1
                    self.cache.move_to_end(key)
                    out[key] = (ent.version, ent.data)
                else:
                    self.misses += 1
                    to_fetch.append(key)
            if at_ts is None:
                for key in extra:
                    if key not in self.cache and key not in demanded:
                        to_fetch.append(key)
                        self.prefetched += 1
        if to_fetch:
            results = self.backend.fetch_blocks(to_fetch, at_ts)
            with self._lock:
                # see cached_read: at_ts == last_sync_ts fetches satisfy
                # the cache invariant (latest version <= last_sync_ts)
                populate = at_ts is None or at_ts == self.last_sync_ts
                for key, (ver, data) in zip(to_fetch, results):
                    if populate:
                        self._put(key, ver, data)
                    if key in demanded:
                        out[key] = (ver, data)
        return out

    def read_blocks_into(
        self,
        keys: List[BlockKey],
        at_ts: Optional[SyncTimestamp],
        dests: Dict[BlockKey, memoryview],
        stats: Optional[List[int]] = None,
    ) -> Dict[BlockKey, Timestamp]:
        """``read_blocks`` that scatters payloads into caller-owned
        writable memoryviews (``dests[key]``), for the zero-copy tensor
        path. Misses go through ``fetch_blocks_into`` so the payload
        lands in the destination straight off the wire; cache hits are
        copied out of the LRU (a local memcpy, counted). Sink-filled
        results are NEVER put in the LRU — the destination aliases
        arena/tensor memory that will be sealed and later recycled, and
        a cache must own its bytes. ``stats`` is a 2-element list
        accumulating ``[bytes_sunk, bytes_copied]``. Returns the
        observed version per key."""
        vers: Dict[BlockKey, Timestamp] = {}
        to_fetch: List[BlockKey] = []
        with self._lock:
            for key in keys:
                ent = self.cache.get(key)
                ok = ent is not None and (
                    at_ts is None
                    or self.backend.snapshot_cache_ok(
                        key, ent.version, at_ts, self.last_sync_ts
                    )
                )
                if ok:
                    self.hits += 1
                    self.cache.move_to_end(key)
                    dst = dests[key]
                    n = min(len(dst), len(ent.data))
                    dst[:n] = ent.data[:n]
                    if n < len(dst):
                        dst[n:] = bytes(len(dst) - n)
                    if stats is not None:
                        stats[1] += len(dst)
                    vers[key] = ent.version
                else:
                    self.misses += 1
                    to_fetch.append(key)
        if to_fetch:
            def sink(i: int, nbytes: int):
                dst = dests[to_fetch[i]]
                return dst if len(dst) == nbytes else None

            results = self.backend.fetch_blocks_into(to_fetch, at_ts, sink)
            populate = at_ts is None or at_ts == self.last_sync_ts
            for key, (ver, data) in zip(to_fetch, results):
                vers[key] = ver
                dst = dests[key]
                if data is dst:
                    if stats is not None:
                        stats[0] += len(dst)
                else:
                    # size-mismatch fallback: payload came back as bytes
                    n = min(len(dst), len(data))
                    dst[:n] = data[:n]
                    if n < len(dst):
                        dst[n:] = bytes(len(dst) - n)
                    if stats is not None:
                        stats[1] += len(dst)
                    if populate:
                        with self._lock:
                            self._put(key, ver, bytes(data))
        return vers

    def lazy_sync_file(self, fid: FileId) -> None:
        if self.policy != CachePolicy.LAZY:
            return
        with self._lock:
            synced = self.synced_files.get(fid)
            if synced is not None and self.backend.ts_geq(
                synced, self.last_sync_ts
            ):
                return
            # Single batched warm-up fetch: every file this cache has
            # synced before, whose sync point has fallen behind, and that
            # still holds cached blocks rides along in the same
            # sync_files round trip as ``fid`` — one RPC re-warms the
            # whole cached working set instead of one per file on each
            # subsequent open. (Files with nothing cached are left to
            # their own next open: syncing them here would fetch whole
            # cold files speculatively.)
            reqs = {
                fid: {
                    k: e.version for k, e in self.cache.items() if k[0] == fid
                }
            }
            for f, ts in self.synced_files.items():
                if f == fid or self.backend.ts_geq(ts, self.last_sync_ts):
                    continue
                known_f = {
                    k: e.version for k, e in self.cache.items() if k[0] == f
                }
                if known_f:
                    reqs[f] = known_f
        updates = self.backend.sync_files(reqs)
        with self._lock:
            for upd in updates.values():
                for key, (ver, data) in upd.items():
                    self._put(key, ver, data)
            for f in reqs:
                self.synced_files[f] = self.last_sync_ts


@dataclass
class _TxnFile:
    fid: FileId
    length: int           # txn-local view of the length
    base_length: int      # committed length observed
    meta_version: Timestamp
    dirty_meta: bool = False
    kind: str = KIND_FILE
    mtime: Timestamp = 0  # committed mtime observed (0 for txn-created)
    ctime: Timestamp = 0  # committed meta version ts (POSIX ctime)


class Transaction:
    """One function invocation's implicit transaction."""

    def __init__(
        self,
        local: LocalServer,
        read_ts: SyncTimestamp,
        read_only: bool = False,
    ):
        self.local = local
        self.backend = local.backend
        self.read_ts = read_ts
        self.read_only = read_only
        self.block_size = self.backend.block_size
        self.reads: Dict[BlockKey, Timestamp] = {}
        self.writes: Dict[BlockKey, WriteRecord] = {}
        self.predicates: List[LengthPredicate] = []
        self.name_reads: Dict[str, Timestamp] = {}
        self.name_updates: Dict[str, Optional[FileId]] = {}
        self.meta_reads: Dict[FileId, Timestamp] = {}
        self._files: Dict[FileId, _TxnFile] = {}
        self._created: Set[FileId] = set()
        self._deleted: Set[FileId] = set()
        self._dir_touches: Set[FileId] = set()
        # probe_meta results, reused by _file so a VFS kind-check +
        # file_info pair costs ONE fetch_meta round trip, not two
        self._probed: Dict[FileId, Tuple[Timestamp, object]] = {}
        # lookup results (ver, fid) by path: repeat lookups of a path the
        # txn already observed are free, and lookup_many prefetches a
        # whole directory walk into it in ONE round trip
        self._names: Dict[str, Tuple[Timestamp, Optional[FileId]]] = {}
        self.committed_payload: Optional[TxnPayload] = None
        # zero-copy accounting for read_into (extends the transport's
        # bytes_copied discipline up into the txn layer): payload bytes
        # landed directly in caller memory vs. fallback-copied there
        self.bytes_sunk = 0
        self.bytes_copied_into = 0
        self.done = False
        # True iff this txn was served from the lease tier's bounded-
        # staleness view (no begin RPC happened); such txns must stay
        # server-free on their read paths wherever the tier can answer
        self.lease_view = False

    # ------------------------------------------------------------------ #
    # lease-tier shims (no-ops when no tier is attached)
    # ------------------------------------------------------------------ #
    def _tier(self):
        tier = self.local.lease_tier
        if tier is not None and self.read_only:
            return tier
        return None

    def _note_fids(self, fids) -> None:
        # register read interest (acquire/renew leases) — only from
        # paths that already contacted the server: view-served reads
        # must not emit frames
        tier = self.local.lease_tier
        if tier is not None and not self.lease_view:
            tier.note_access(fids)

    # ------------------------------------------------------------------ #
    # namespace
    # ------------------------------------------------------------------ #
    def lookup(self, path: str) -> Optional[FileId]:
        at = self.read_ts if self.read_only else None
        if path in self.name_updates:
            return self.name_updates[path]
        cached = self._names.get(path)
        if cached is not None:
            return cached[1]
        tier = self._tier()
        if tier is not None:
            ent = tier.name_get(path, at)
            if ent is not None:
                self._names[path] = ent
                return ent[1]
        ver, fid = self.backend.lookup(path, at)
        self._names[path] = (ver, fid)
        if tier is not None:
            tier.name_put(path, at, ver, fid)
        if not self.read_only:
            self.name_reads.setdefault(path, ver)
        return fid

    def lookup_many(self, paths: List[str]) -> List[Optional[FileId]]:
        """Resolve many paths in ONE backend round trip (modulo txn-local
        overlays and already-cached names). Records the same name reads
        ``lookup`` would — a deep-path walk that prefetches its ancestry
        here has identical OCC validation, it just stops paying a round
        trip per component."""
        at = self.read_ts if self.read_only else None
        missing = [
            p for p in paths
            if p not in self.name_updates and p not in self._names
        ]
        tier = self._tier()
        if tier is not None and missing:
            still = []
            for p in missing:
                ent = tier.name_get(p, at)
                if ent is not None:
                    self._names[p] = ent
                else:
                    still.append(p)
            missing = still
        if missing:
            for p, (ver, fid) in zip(
                missing, self.backend.lookup_many(missing, at)
            ):
                self._names[p] = (ver, fid)
                if tier is not None:
                    tier.name_put(p, at, ver, fid)
                if not self.read_only:
                    self.name_reads.setdefault(p, ver)
        return [
            self.name_updates[p]
            if p in self.name_updates else self._names[p][1]
            for p in paths
        ]

    def probe_metas(self, fids: List[FileId]) -> None:
        """Prefetch unvalidated metas for many file ids in ONE round trip;
        subsequent ``probe_meta`` / ``file_info`` calls on these ids hit
        the probe cache. Ids the txn already has state for are skipped;
        never-bound ids cache as absent."""
        at = self.read_ts if self.read_only else None
        missing = [
            fid for fid in fids
            if fid not in self._files and fid not in self._probed
        ]
        tier = self._tier()
        if tier is not None and missing:
            still = []
            for fid in missing:
                ent = tier.meta_get(fid, at)
                if ent is not None:
                    self._probed[fid] = ent
                else:
                    still.append(fid)
            missing = still
        if not missing:
            return
        for fid, entry in zip(missing, self.backend.fetch_metas(missing, at)):
            # entry is None for a never-bound id; cache the miss so the
            # walk does not re-probe it (probe_meta maps it to None)
            ent = entry if entry is not None else (0, None)
            self._probed[fid] = ent
            if tier is not None:
                tier.meta_put(fid, at, ent[0], ent[1])
        self._note_fids(missing)

    def readdir(self, prefix: str) -> List[str]:
        """Direct children bound under ``prefix`` — a transactional read.

        Every observed entry (including unlink tombstones) is recorded as
        a name read, so commit validation catches a concurrent rename /
        unlink / re-create of anything this listing depended on.
        Txn-local name updates are overlaid, so a file created earlier in
        the same transaction is visible.

        Known limitation *at this layer*: a concurrent create of a
        *never-before-bound* name leaves no version to validate against,
        so such phantoms are not detected here. The POSIX VFS closes this
        for real directories: every link/unlink ships a namespace
        generation bump for the parent (``touch_dir``), and
        ``FaaSFS.readdir``/``rmdir`` record the directory's meta version,
        so phantom creates abort the lister at commit (cf. the paper,
        which does not validate directory listings at all)."""
        if not prefix.endswith("/"):
            prefix += "/"
        at = self.read_ts if self.read_only else None
        children: Dict[str, Optional[FileId]] = {}
        for path, ver, fid in self.backend.listdir(prefix, at):
            if not self.read_only:
                self.name_reads.setdefault(path, ver)
            children[path] = fid
        for path, fid in self.name_updates.items():
            if path.startswith(prefix) and "/" not in path[len(prefix):]:
                children[path] = fid
        return sorted(
            p[len(prefix):] for p, fid in children.items() if fid is not None
        )

    def _check_mutable(self) -> None:
        self._check_open()
        if self.read_only:
            raise TxnStateError("mutation in read-only transaction")

    def create(self, path: str, exist_ok: bool = False, kind: str = KIND_FILE) -> FileId:
        self._check_open()
        existing = self.lookup(path)
        if existing is None:
            self._check_mutable()
        if existing is not None:
            if exist_ok:
                return existing
            from repro_torch.core.types import Exists

            raise Exists(path)
        fid = self.backend.alloc_file_id()
        self.name_updates[path] = fid
        self._files[fid] = _TxnFile(fid, 0, 0, 0, dirty_meta=True, kind=kind)
        self._created.add(fid)
        return fid

    def bind(self, path: str, fid: Optional[FileId]) -> None:
        """Raw namespace update: bind ``path`` to ``fid`` (None unbinds).
        The VFS layer composes rename/replace semantics from this; the
        caller is responsible for having recorded any name reads its
        decision depended on (``lookup`` records them)."""
        self._check_mutable()
        self.name_updates[path] = fid

    def delete_fid(self, fid: FileId) -> None:
        """Mark a file id deleted (meta tombstone at commit). Records a
        meta read, so a concurrent resurrection conflicts."""
        self._check_mutable()
        tf = self._file(fid)
        tf.dirty_meta = True
        # the txn-local length is NOT zeroed: POSIX keeps an unlinked
        # file's contents readable through already-open descriptors
        self._deleted.add(fid)

    def unlink(self, path: str) -> None:
        self._check_mutable()
        fid = self.lookup(path)
        if fid is None:
            raise NotFound(path)
        self.name_updates[path] = None
        self.delete_fid(fid)

    def rename(self, src: str, dst: str) -> None:
        """Atomic rename (POSIX: never visible under both names)."""
        self._check_mutable()
        fid = self.lookup(src)
        if fid is None:
            raise NotFound(src)
        self.name_updates[src] = None
        self.name_updates[dst] = fid

    # ------------------------------------------------------------------ #
    # file state
    # ------------------------------------------------------------------ #
    def _file(self, fid: FileId) -> _TxnFile:
        tf = self._files.get(fid)
        if tf is None:
            probed = self._probed.get(fid)
            if probed is not None:
                ver, meta = probed
            else:
                at = self.read_ts if self.read_only else None
                tier = self._tier()
                ent = tier.meta_get(fid, at) if tier is not None else None
                if ent is not None:
                    ver, meta = ent
                else:
                    try:
                        ver, meta = self.backend.fetch_meta(fid, at)
                    except NotFound:
                        ver, meta = 0, None
                    if tier is not None:
                        tier.meta_put(fid, at, ver, meta)
                    self._note_fids((fid,))
            if meta is None or not meta.exists:
                raise NotFound(f"file {fid}")
            if not self.read_only:
                self.meta_reads.setdefault(fid, ver)
            self.local.lazy_sync_file(fid)
            tf = _TxnFile(
                fid, meta.length, meta.length, ver,
                kind=meta.kind, mtime=meta.mtime_ts, ctime=ver,
            )
            self._files[fid] = tf
        return tf

    def file_info(self, fid: FileId) -> _TxnFile:
        """Validated metadata view of ``fid`` (records an OCC meta read in
        read-write transactions): length, kind, mtime/ctime commit
        timestamps. Raises NotFound for a missing/deleted file."""
        return self._file(fid)

    def probe_meta(self, fid: FileId):
        """Unvalidated meta read: the current FileMeta, or None if the
        file does not exist (at this transaction's snapshot for read-only
        transactions). Records NO OCC meta read — callers must only
        depend on attributes that are immutable per file id (``kind``) or
        that they separately pin with a predicate (``assert_exists``)."""
        tf = self._files.get(fid)
        if tf is not None:
            if fid in self._deleted:
                return None
            from repro_torch.core.blockstore import FileMeta

            return FileMeta(tf.length, True, tf.kind, tf.mtime)
        probed = self._probed.get(fid)
        if probed is None:
            at = self.read_ts if self.read_only else None
            tier = self._tier()
            probed = tier.meta_get(fid, at) if tier is not None else None
            if probed is None:
                try:
                    probed = self.backend.fetch_meta(fid, at)
                except NotFound:
                    probed = (0, None)
                if tier is not None:
                    tier.meta_put(fid, at, probed[0], probed[1])
                self._note_fids((fid,))
            self._probed[fid] = probed
        meta = probed[1]
        return meta if meta is not None and meta.exists else None

    def file_kind(self, fid: FileId) -> Optional[str]:
        """``"f"`` / ``"d"`` for an existing file id, else None. Kind is
        immutable per id, so this needs no OCC validation."""
        meta = self.probe_meta(fid)
        return None if meta is None else meta.kind

    def assert_exists(self, fid: FileId) -> None:
        """Pin "``fid`` exists at commit time" with a length predicate
        (length >= 0 fails iff the meta tombstone applies first). Unlike
        a meta read this does NOT conflict with concurrent metadata
        bumps — it is how two creators in one directory both commit while
        either still loses to a concurrent rmdir."""
        self._check_open()
        if fid in self._deleted:
            raise NotFound(f"file {fid}")
        if fid in self._created:
            return  # created by this txn: validation precedes our apply
        self.predicates.append(LengthPredicate(fid, PredicateKind.GE, 0))

    def touch_dir(self, fid: FileId) -> None:
        """Bump a directory's namespace generation at commit: ships a
        meta set for the dir, so anything that recorded the dir's meta
        version (readdir / stat / rmdir) conflicts with this link or
        unlink — the phantom protection real directories buy us."""
        self._check_open()
        tf = self._files.get(fid)
        if tf is not None and (tf.dirty_meta or fid in self._deleted):
            return  # created or deleted in this txn: already shipping meta
        self._dir_touches.add(fid)

    def lock_file(self, fid: FileId, exclusive: bool = True) -> None:
        """Advisory lock record (paper §3.1 optimistic lock elision): the
        lock word is a reserved block. Shared lockers read it; an
        exclusive locker also writes it. Acquisition always succeeds
        locally — commit validation delivers the serialization the lock
        would have: exclusive-vs-any conflicts, shared-vs-shared does
        not. Locks release at commit/abort (function boundary).

        An exclusive lock is a write: read-only transactions refuse it
        (TxnStateError) — a snapshot transaction records no validated
        reads, so its lock word would commit blind and serialize
        nothing. (This also lets the runtime's read-only inference
        transparently demote a function that starts taking exclusive
        locks.) Shared locks are fine read-only: the snapshot already
        serializes them at its read timestamp."""
        if exclusive:
            self._check_mutable()
        else:
            self._check_open()
        key = (fid, LOCK_BLOCK_INDEX)
        self._read_block(key)
        if exclusive:
            w = self.writes.setdefault(key, WriteRecord(key))
            w.add(0, b"L")

    def length(self, fid: FileId) -> int:
        tf = self._file(fid)
        if not tf.dirty_meta:
            # stat pins the exact length (EQ predicate)
            self.predicates.append(
                LengthPredicate(fid, PredicateKind.EQ, tf.base_length)
            )
        return tf.length

    # ------------------------------------------------------------------ #
    # byte-level read/write (the POSIX layer calls these)
    # ------------------------------------------------------------------ #
    def _read_block(self, key: BlockKey) -> bytes:
        at = self.read_ts if self.read_only else None
        ver, data = self.local.cached_read(key, at)
        if not self.read_only:
            self.reads.setdefault(key, ver)
        w = self.writes.get(key)
        if w is not None:
            data = w.apply_to(data, self.block_size)
        return data

    def _readahead_keys(
        self, tf: _TxnFile, b1: int
    ) -> Tuple[BlockKey, ...]:
        """Contiguous blocks after ``b1`` (within the file) to speculate
        on in the same batched fetch."""
        ra = self.local.readahead_blocks
        if self.read_only or ra <= 0 or tf.length == 0:
            return ()
        last_blk = (tf.length - 1) // self.block_size
        return tuple(
            (tf.fid, bj) for bj in range(b1 + 1, min(b1 + ra, last_blk) + 1)
        )

    def read(self, fid: FileId, offset: int, size: int) -> bytes:
        self._check_open()
        tf = self._file(fid)
        if offset >= tf.length:
            # read beyond EOF: returns empty, asserts filelength <= offset
            if not tf.dirty_meta:
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.GE, 0)
                )
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.LE, offset)
                )
            return b""
        end = min(offset + size, tf.length)
        truncated = end < offset + size
        if not tf.dirty_meta:
            if truncated:
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.EQ, tf.base_length)
                )
            else:
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.GE, end)
                )
        out = bytearray()
        b0, b1 = offset // self.block_size, (end - 1) // self.block_size
        # the whole span (misses AND read-ahead) is ONE fetch_blocks
        # round trip; cache hits are served locally as before
        at = self.read_ts if self.read_only else None
        keys = [(fid, bi) for bi in range(b0, b1 + 1)]
        blocks = self.local.read_blocks(keys, at, self._readahead_keys(tf, b1))
        for bi in range(b0, b1 + 1):
            ver, data = blocks[(fid, bi)]
            if not self.read_only:
                self.reads.setdefault((fid, bi), ver)
            w = self.writes.get((fid, bi))
            if w is not None:
                data = w.apply_to(data, self.block_size)
            lo = offset - bi * self.block_size if bi == b0 else 0
            hi = end - bi * self.block_size if bi == b1 else self.block_size
            out += data[lo:hi]
        return bytes(out)

    def read_into(self, fid: FileId, offset: int, size: int, out) -> int:
        """``read`` that scatters into a caller-owned writable buffer.

        Same predicate/versioning semantics as ``read``; returns the
        logical byte count (reads clamp at EOF like ``read``). ``out``
        must be a writable memoryview of at least ``size`` bytes; give
        it block-aligned capacity (``BlockArena.alloc(n, round_to=
        block_size)``) and a block-aligned ``offset`` and every block in
        the span becomes a full-size sink destination — payloads then
        land in ``out`` straight off the wire with zero per-block
        copies (counted in ``bytes_sunk``; anything that needed a local
        copy — cache hits, overlay writes, ragged edges — lands in
        ``bytes_copied_into``). Bytes in ``out`` beyond the logical
        count but within block-aligned capacity are scratch the fill
        may clobber."""
        self._check_open()
        tf = self._file(fid)
        if offset >= tf.length:
            if not tf.dirty_meta:
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.GE, 0)
                )
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.LE, offset)
                )
            return 0
        end = min(offset + size, tf.length)
        truncated = end < offset + size
        if not tf.dirty_meta:
            if truncated:
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.EQ, tf.base_length)
                )
            else:
                self.predicates.append(
                    LengthPredicate(fid, PredicateKind.GE, end)
                )
        bs = self.block_size
        b0, b1 = offset // bs, (end - 1) // bs
        out = memoryview(out)
        cap = len(out)
        at = self.read_ts if self.read_only else None
        dests: Dict[BlockKey, memoryview] = {}
        partial: List[int] = []
        for bi in range(b0, b1 + 1):
            lo = offset - bi * bs if bi == b0 else 0
            out_off = bi * bs - offset
            if lo == 0 and out_off + bs <= cap \
                    and (fid, bi) not in self.writes:
                dests[(fid, bi)] = out[out_off:out_off + bs]
            else:
                # ragged edge / overlay write: served via the bytes path
                partial.append(bi)
        stats = [0, 0]
        if dests:
            vers = self.local.read_blocks_into(list(dests), at, dests, stats)
            if not self.read_only:
                for key, ver in vers.items():
                    self.reads.setdefault(key, ver)
        if partial:
            keys = [(fid, bi) for bi in partial]
            blocks = self.local.read_blocks(keys, at)
            for bi in partial:
                ver, data = blocks[(fid, bi)]
                if not self.read_only:
                    self.reads.setdefault((fid, bi), ver)
                w = self.writes.get((fid, bi))
                if w is not None:
                    data = w.apply_to(data, bs)
                lo = offset - bi * bs if bi == b0 else 0
                hi = end - bi * bs if bi == b1 else bs
                dst_off = bi * bs - offset + lo
                out[dst_off:dst_off + (hi - lo)] = data[lo:hi]
                stats[1] += hi - lo
        self.bytes_sunk += stats[0]
        self.bytes_copied_into += stats[1]
        return end - offset

    def write(self, fid: FileId, offset: int, data: bytes) -> int:
        self._check_open()
        if self.read_only:
            raise TxnStateError("write in read-only transaction")
        tf = self._file(fid)
        if not data:
            # POSIX: a zero-length write is a no-op — it must not extend
            # the file, record writes, or touch mtime
            return 0
        end = offset + len(data)
        b0, b1 = offset // self.block_size, max(offset, end - 1) // self.block_size
        pos = 0
        for bi in range(b0, b1 + 1):
            lo = offset - bi * self.block_size if bi == b0 else 0
            hi = min(end - bi * self.block_size, self.block_size)
            n = hi - lo
            w = self.writes.setdefault((fid, bi), WriteRecord((fid, bi)))
            w.add(lo, data[pos : pos + n])
            pos += n
        if end > tf.length:
            tf.length = end
            tf.dirty_meta = True
        return len(data)

    def truncate(self, fid: FileId, length: int) -> None:
        self._check_mutable()
        tf = self._file(fid)
        if length < tf.length:
            # POSIX: bytes past the new length must read as zeros if the
            # file later regrows — zero the boundary block's tail AND every
            # later block that held data (property tests caught the
            # boundary-only version leaking stale bytes).
            bi = length // self.block_size
            lo = length - bi * self.block_size
            w = self.writes.setdefault((fid, bi), WriteRecord((fid, bi)))
            w.add(lo, b"\0" * (self.block_size - lo))
            last_old = (tf.length - 1) // self.block_size
            for bj in range(bi + 1, last_old + 1):
                w = self.writes.setdefault((fid, bj), WriteRecord((fid, bj)))
                w.add(0, b"\0" * self.block_size)
        tf.length = length
        tf.dirty_meta = True

    # ------------------------------------------------------------------ #
    # commit / abort
    # ------------------------------------------------------------------ #
    def payload(self) -> TxnPayload:
        deleted = self._deleted
        meta_updates: Dict[FileId, object] = {}
        for fid, tf in self._files.items():
            if fid in deleted:
                meta_updates[fid] = None
            elif tf.dirty_meta:
                meta_updates[fid] = meta_set(tf.length, tf.kind)
        for fid in self._dir_touches:
            # namespace-generation bump for parents of linked/unlinked
            # entries; an explicit meta set (or delete) supersedes it
            meta_updates.setdefault(fid, meta_set(0, KIND_DIR))
        for key in self.writes:
            # in-place data writes carry an mtime-only touch so stat stays
            # honest; lock-word writes are not data modifications
            fid = key[0]
            if key[1] != LOCK_BLOCK_INDEX and fid not in meta_updates:
                meta_updates[fid] = META_TOUCH
        return TxnPayload(
            read_ts=self.read_ts,
            reads=[ReadRecord(k, v) for k, v in self.reads.items()],
            writes=list(self.writes.values()),
            predicates=self.predicates,
            meta_updates=meta_updates,
            name_updates=self.name_updates,
            name_reads={} if self.read_only else self.name_reads,
            meta_reads={} if self.read_only else self.meta_reads,
            read_only=self.read_only,
        )

    def commit(self) -> SyncTimestamp:
        self._check_open()
        self.done = True
        if self.lease_view:
            # view-served read-only txn: it serialized at its (past)
            # snapshot timestamp the moment it began, has no effects to
            # apply and no reads to validate — the commit RPC would be a
            # server no-op, and view txns must stay zero-round-trip
            self.committed_payload = self.payload()
            return self.read_ts
        payload = self.committed_payload = self.payload()
        try:
            reply = self.backend.commit(payload)
        except Conflict:
            # drop local cache entries for conflicting keys so the retry
            # re-fetches fresh state
            for w in payload.writes:
                self.local.cache.pop(w.key, None)
            for r in payload.reads:
                self.local.cache.pop(r.key, None)
            raise
        tier = self.local.lease_tier
        if tier is not None:
            # own commit: the shared view predates it — end it now so the
            # container reads its own writes (read-your-own-writes does
            # not wait for the server's push to loop back)
            tier.on_local_commit(payload)
        # Write-through committed blocks we can reconstruct exactly: if the
        # txn READ the block, our cached base is the validated base the
        # backend patched, so patch-apply is exact. Blind writes (base never
        # observed) are invalidated instead — the backend may have patched a
        # different base. The per-block committed version comes from the
        # CommitReply (shard-local under the sharded backend).
        with self.local._lock:
            for w in payload.writes:
                wts = reply.block_versions.get(w.key)
                if wts is None:
                    self.local.cache.pop(w.key, None)
                    continue
                ent = self.local.cache.get(w.key)
                if w.key in self.reads and ent is not None and ent.version == self.reads[w.key]:
                    self.local._put(w.key, wts, w.apply_to(ent.data, self.block_size))
                else:
                    fully_covered = w.apply_to(b"", self.block_size)
                    # covered byte count as a union of [off, end) intervals:
                    # O(patches log patches), where a per-byte mark costs
                    # O(block_size) Python steps for every blind-written block
                    n = 0
                    reach = 0
                    for lo, hi in sorted(
                        (off, min(off + len(data), self.block_size))
                        for off, data in w.patches
                    ):
                        lo = max(lo, reach)
                        if hi > lo:
                            n += hi - lo
                            reach = hi
                    if n == self.block_size:
                        self.local._put(w.key, wts, fully_covered)
                    else:
                        self.local.cache.pop(w.key, None)
            # NOTE: last_sync_ts must NOT advance here — other clients may
            # have committed between our begin and our commit, and we have
            # not seen their cache updates (snapshot reads rely on this).
        return reply.ts

    def abort(self) -> None:
        self.done = True

    def _check_open(self) -> None:
        if self.done:
            raise TxnStateError("transaction already finished")
