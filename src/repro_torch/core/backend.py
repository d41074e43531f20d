"""The FaaSFS Backend Service (paper §4.1-4.2).

In-memory, transactional — one *shard* of state. Used standalone it
matches the paper's prototype scope ("a prototype backend implemented as
a monolithic server that maintains state in memory"); composed by
``repro.core.sharded.ShardedBackend`` it is one hash partition of a
horizontally sharded backend. It provides:

  * a Sequencer issuing commit timestamps,
  * OCC validation (Kung-Robinson backward validation over block versions
    and file-length predicates),
  * atomic application of write sets with version-chain (undo log) retention,
  * the transaction log that drives block-granular cache updates
    (eager / lazy / invalidate / stale / frequency-heuristic policies),
  * multiversion snapshot block fetches at a historical T_R,
  * optional group-commit batching: commits arriving within a short
    window are validated and applied under ONE commit-lock acquisition
    (and one durable-log write), amortizing the per-commit critical
    section,
  * optional real durability: attach a ``repro.core.wal.WriteAheadLog``
    (``self.wal``) and every commit's effects are appended and fsync'd
    before the commit is acknowledged — ``commit_service_s`` then stays 0
    and the *simulated* log cost is replaced by the real one. Group
    commit amortizes the fsync exactly as it amortized the simulation.

The commit path is decomposed into ``validate_locked`` / ``next_ts_locked``
/ ``apply_locked`` / ``undo_locked`` / ``log_commit_locked`` so a
cross-shard two-phase-commit coordinator can drive the same machinery
while holding several shards' commit locks (see core/sharded.py).

Validation detail: the paper validates ``T_W^B <= T_R`` for each read,
which is sound when caches are synchronized at transaction begin (its
eager/lazy protocols guarantee this). Because we also allow the 'stale'
policy (backend does nothing at begin; paper §4.2 explicitly permits this),
we validate against the *observed* version timestamp instead — equivalent
under begin-sync, and still strictly serializable without it.

Transport note: simulated network latency is no longer injected here;
wrap the backend in ``repro.core.api.LatencyInjector`` instead.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import obs
from repro_torch.core.api import BackendAPI, CommitReply
from repro_torch.core.blockstore import BlockStore, FileMeta
from repro_torch.core.types import (
    BLOCK_SIZE_DEFAULT,
    BlockKey,
    CachePolicy,
    Conflict,
    FileId,
    LengthPredicate,
    NotFound,
    ReadRecord,
    Timestamp,
    WriteRecord,
    normalize_meta_update,
)

# Abort-cause counters, pre-bound at import time (obs contract: label
# resolution never happens on the commit hot path).
_ABORT_CAUSE = {
    tag: obs.REGISTRY.counter(
        "faasfs_aborts_total", labels=("cause",),
        help="OCC validation failures by conflicting item kind",
    ).labels(tag)
    for tag in ("block", "name", "meta", "predicate")
}
_GROUP_BATCH = obs.REGISTRY.histogram(
    "faasfs_wal_group_batch", buckets=obs.SIZE_BUCKETS, unit="txns",
    help="payloads per group-commit batch (one fsync each)",
).labels()
_COMMITS = obs.REGISTRY.counter(
    "faasfs_commits_total", help="committed transactions",
).labels()


@dataclass
class CommitRecord:
    ts: Timestamp
    blocks: List[BlockKey]
    meta_files: List[FileId]
    names: List[str]


@dataclass
class TxnPayload:
    """What a client ships at commit time."""

    read_ts: Timestamp
    reads: List[ReadRecord] = field(default_factory=list)
    writes: List[WriteRecord] = field(default_factory=list)
    predicates: List[LengthPredicate] = field(default_factory=list)
    # metadata mutations: fid -> None (delete) | ("s", length, kind) |
    # ("t",) mtime-only touch | legacy int == ("s", int, "f"); see
    # repro.core.types.normalize_meta_update
    meta_updates: Dict[FileId, object] = field(default_factory=dict)
    # namespace mutations: path -> fid (None => unbind)
    name_updates: Dict[str, Optional[FileId]] = field(default_factory=dict)
    # names whose resolution the txn depends on: path -> observed version
    name_reads: Dict[str, Timestamp] = field(default_factory=dict)
    # metadata observed versions: fid -> version ts
    meta_reads: Dict[FileId, Timestamp] = field(default_factory=dict)
    read_only: bool = False

    def has_effects(self) -> bool:
        return bool(self.writes or self.meta_updates or self.name_updates)


@dataclass
class BeginReply:
    read_ts: Timestamp
    # block-granular cache updates (the paper's key mechanism):
    updates: Dict[BlockKey, Tuple[Timestamp, bytes]]
    invalidations: List[BlockKey]
    file_invalidations: List[FileId]


@dataclass
class BackendStats:
    commits: int = 0
    aborts: int = 0
    begins: int = 0
    blocks_pushed: int = 0
    blocks_invalidated: int = 0
    block_fetches: int = 0
    bytes_pushed: int = 0
    validation_checks: int = 0
    group_batches: int = 0       # group-commit lock acquisitions
    group_committed: int = 0     # payloads committed through batches


#: touched-state summary returned by apply_locked, consumed by
#: log_commit_locked / undo_locked
Touched = Tuple[List[BlockKey], List[FileId], List[str]]


@dataclass
class _Pending:
    """One payload queued for a group-commit batch."""

    payload: TxnPayload
    done: threading.Event = field(default_factory=threading.Event)
    reply: Optional[CommitReply] = None
    error: Optional[BaseException] = None


class _GroupCommitter:
    """Accumulate commit payloads for a short window; the first arrival
    becomes the batch leader, sleeps out the window, then validates and
    applies the whole batch under ONE commit-lock acquisition (and one
    simulated durable-log write). Later payloads in a batch validate
    against the state left by earlier ones — exactly the serial order
    their commit timestamps record."""

    def __init__(self, backend: "BackendService", window_s: float):
        self.backend = backend
        self.window_s = window_s
        self._mu = threading.Lock()
        self._queue: List[_Pending] = []
        self._leader_active = False

    def submit(self, payload: TxnPayload) -> CommitReply:
        p = _Pending(payload)
        with self._mu:
            self._queue.append(p)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            clean_exit = False
            try:
                time.sleep(self.window_s)
                while True:
                    with self._mu:
                        batch = self._queue
                        self._queue = []
                        if not batch:
                            # leadership must be released under the SAME
                            # lock hold as the emptiness check, so a
                            # payload enqueued right after sees
                            # _leader_active False and leads itself
                            self._leader_active = False
                            clean_exit = True
                            break
                    self._run_batch(batch)
            finally:
                # Exceptional exit only (e.g. KeyboardInterrupt during
                # the window sleep): never leave the committer wedged —
                # hand leadership back and fail genuinely stranded
                # waiters rather than letting them block forever.
                if not clean_exit:
                    with self._mu:
                        self._leader_active = False
                        stranded, self._queue = self._queue, []
                    for q in stranded:
                        if not q.done.is_set():
                            q.error = RuntimeError(
                                "group-commit leader died before this batch"
                            )
                            q.done.set()
        p.done.wait()
        if p.error is not None:
            raise p.error
        assert p.reply is not None
        return p.reply

    def _run_batch(self, batch: List[_Pending]) -> None:
        be = self.backend
        try:
            with be.commit_lock:
                be.stats.group_batches += 1
                _GROUP_BATCH.observe(len(batch))
                committed: List[_Pending] = []
                for p in batch:
                    try:
                        p.reply = be._commit_locked(p.payload, durable=False)
                        be.stats.group_committed += 1
                        committed.append(p)
                    except Conflict as e:
                        p.error = e
                        p.done.set()  # aborts need no durability barrier
                # ONE durable-log write (real WAL fsync or simulated cost)
                # for the whole batch, then acknowledge every commit in it.
                try:
                    be._durable_barrier()
                except BaseException as e:
                    # fsync failure (WalFailed): the batch applied in
                    # memory but is NOT durable — every waiter gets the
                    # typed error instead of an ack, and registration is
                    # withheld (the commits never become visible to
                    # begin's sync vector)
                    for p in committed:
                        p.error = e
                        p.done.set()
                    raise
                # Sync-vector registration (on_commit_applied) happens only
                # AFTER the batch is durable: registering before the fsync
                # would let a racing begin observe a commit a crash could
                # still lose (the "group-commit visibility window" that
                # docs/transport.md used to list as a known limitation).
                for p in committed:
                    if be.on_commit_applied is not None:
                        be.on_commit_applied(p.reply.ts)
                    p.done.set()
        finally:
            for p in batch:  # a non-Conflict failure must not strand waiters
                if not p.done.is_set():
                    p.error = RuntimeError("group-commit batch failed")
                    p.done.set()


class BackendService(BackendAPI):
    def __init__(
        self,
        block_size: int = BLOCK_SIZE_DEFAULT,
        versions_kept: int = 16,
        policy: CachePolicy = CachePolicy.INVALIDATE,
        hot_threshold: int = 3,
        log_horizon: int = 4096,
        group_commit_window_s: float = 0.0,
        commit_service_s: float = 0.0,
        wal=None,
    ):
        self.store = BlockStore(block_size, versions_kept)
        self.policy = policy
        self.hot_threshold = hot_threshold
        self.log_horizon = log_horizon
        # simulated backend-side durable-apply time (e.g. log fsync),
        # paid once per commit-lock acquisition — what group commit
        # amortizes. 0 in tests. Superseded by a real WAL when attached.
        self.commit_service_s = commit_service_s
        # optional repro.core.wal.WriteAheadLog; when set, commits append
        # their effects and fsync before acking (see _durable_barrier)
        self.wal = wal
        self.shard_id = 0  # position within a ShardedBackend (WAL records)
        self.commit_lock = threading.Lock()
        self._ts = 0  # sequencer
        self._log: List[CommitRecord] = []
        self._fetch_counts: Dict[BlockKey, int] = defaultdict(int)
        self.stats = BackendStats()
        # invoked under commit_lock after a commit fully applies; the
        # sharded coordinator hooks this to advance its sync vector
        self.on_commit_applied: Optional[Callable[[Timestamp], None]] = None
        # invoked OUTSIDE the commit lock, after the commit is durable
        # and its reply is in hand — a freshness-only signal carrying
        # the full payload, hooked by the lease broker (core/leases.py)
        # to revoke in-process cache-tier views. Never on the
        # correctness path: a missed notification costs staleness
        # within the tier's declared bound, not serializability.
        self.on_commit_effects: Optional[
            Callable[[Timestamp, TxnPayload], None]
        ] = None
        self._group = (
            _GroupCommitter(self, group_commit_window_s)
            if group_commit_window_s > 0
            else None
        )

    @property
    def block_size(self) -> int:
        return self.store.block_size

    def _service(self) -> None:
        if self.commit_service_s:
            time.sleep(self.commit_service_s)

    def _wal_append(self, payload: TxnPayload, ts: Timestamp):
        """Buffered append of this commit's effects; returns the LSN for
        the durability barrier (None when no WAL is attached)."""
        if self.wal is None:
            return None
        from repro_torch.core import wal as _wal

        return self.wal.append(
            ("c", self.shard_id, ts, _wal.effects_from_payload(payload))
        )

    def _durable_barrier(self, lsn=None) -> None:
        """Make everything appended so far durable before acking: real
        WAL fsync when attached, else the simulated service time. An
        explicitly configured service time ALSO applies on top of a real
        WAL — benchmarks use it to model slower durable media than the
        local disk while still exercising the real log path."""
        if self.wal is not None:
            self.wal.sync(lsn)
            self._service()
        else:
            self._service()

    # ------------------------------------------------------------------ #
    # sequencer
    # ------------------------------------------------------------------ #
    @property
    def latest_ts(self) -> Timestamp:
        return self._ts

    def next_ts_locked(self) -> Timestamp:
        self._ts += 1
        return self._ts

    # ------------------------------------------------------------------ #
    # begin: hand out T_R + cache-update message per policy
    # ------------------------------------------------------------------ #
    def begin(
        self,
        last_sync_ts: Timestamp,
        cached_keys: Optional[Set[BlockKey]] = None,
        policy: Optional[CachePolicy] = None,
    ) -> BeginReply:
        policy = policy or self.policy
        self.stats.begins += 1
        with self.commit_lock:
            read_ts = self._ts
            changed: Dict[BlockKey, bool] = {}
            changed_files: Set[FileId] = set()
            for rec in reversed(self._log):
                if rec.ts <= last_sync_ts:
                    break
                for k in rec.blocks:
                    changed[k] = True
                changed_files.update(rec.meta_files)

        updates: Dict[BlockKey, Tuple[Timestamp, bytes]] = {}
        invals: List[BlockKey] = []
        file_invals: List[FileId] = []
        if policy == CachePolicy.STALE:
            pass
        elif policy == CachePolicy.LAZY:
            # client defers to per-file sync on first open
            file_invals = sorted(changed_files)
        else:
            relevant = [
                k for k in changed
                if cached_keys is None or k in cached_keys
            ]
            for k in relevant:
                push = policy == CachePolicy.EAGER or (
                    policy == CachePolicy.FREQUENT
                    and self._fetch_counts[k] >= self.hot_threshold
                )
                if push:
                    ts, data = self.store.block(k)
                    updates[k] = (ts, data)
                    self.stats.blocks_pushed += 1
                    self.stats.bytes_pushed += len(data)
                else:
                    invals.append(k)
                    self.stats.blocks_invalidated += 1
        return BeginReply(read_ts, updates, invals, file_invals)

    def sync_file(
        self, fid: FileId, known_versions: Dict[BlockKey, Timestamp]
    ) -> Dict[BlockKey, Tuple[Timestamp, bytes]]:
        """Lazy policy: bring one file's cached blocks current."""
        out: Dict[BlockKey, Tuple[Timestamp, bytes]] = {}
        for key in self.store.blocks_of(fid):
            cur = self.store.block_version(key)
            if known_versions.get(key, -1) != cur:
                ts, data = self.store.block(key)
                out[key] = (ts, data)
                self.stats.blocks_pushed += 1
                self.stats.bytes_pushed += len(data)
        return out

    def sync_files(
        self, reqs: Dict[FileId, Dict[BlockKey, Timestamp]]
    ) -> Dict[FileId, Dict[BlockKey, Tuple[Timestamp, bytes]]]:
        return {fid: self.sync_file(fid, known) for fid, known in reqs.items()}

    # ------------------------------------------------------------------ #
    # reads (cache miss path) — multiversion via the undo log
    # ------------------------------------------------------------------ #
    def fetch_blocks(
        self, keys: List[BlockKey], at_ts: Optional[Timestamp] = None
    ) -> List[Tuple[Timestamp, bytes]]:
        out = []
        for key in keys:
            self.stats.block_fetches += 1
            self._fetch_counts[key] += 1
            out.append(self.store.block(key, at_ts))
        return out

    def fetch_metas(
        self, fids: List[FileId], at_ts: Optional[Timestamp] = None
    ) -> List[Optional[Tuple[Timestamp, FileMeta]]]:
        out: List[Optional[Tuple[Timestamp, FileMeta]]] = []
        for fid in fids:
            try:
                out.append(self.store.meta(fid, at_ts))
            except NotFound:
                out.append(None)
        return out

    def lookup_many(
        self, paths: List[str], at_ts: Optional[Timestamp] = None
    ) -> List[Tuple[Timestamp, Optional[FileId]]]:
        return [self.store.lookup_versioned(p, at_ts) for p in paths]

    def listdir(
        self, prefix: str, at_ts: Optional[Timestamp] = None
    ) -> List[Tuple[str, Timestamp, Optional[FileId]]]:
        return self.store.dir_entries(prefix, at_ts)

    # ------------------------------------------------------------------ #
    # commit: OCC validation + atomic apply
    # ------------------------------------------------------------------ #
    def commit(self, payload: TxnPayload) -> CommitReply:
        """Validate and apply. Raises Conflict on validation failure."""
        if payload.read_only and not payload.has_effects():
            # snapshot-read transaction: serializes at its T_R; no validation
            self.stats.commits += 1
            return CommitReply(payload.read_ts)
        if self._group is not None:
            reply = self._group.submit(payload)
        else:
            with self.commit_lock:
                reply = self._commit_locked(payload)
        if self.on_commit_effects is not None:
            self.on_commit_effects(reply.ts, payload)
        return reply

    def _commit_locked(
        self, payload: TxnPayload, durable: bool = True
    ) -> CommitReply:
        """Full commit under an already-held commit lock.

        ``durable=False`` defers the durability barrier to the caller
        (the group committer / 2PC coordinator pays it once per batch)."""
        self.validate_locked(payload)
        ts = self.next_ts_locked()
        touched = self.apply_locked(payload, ts)
        self.log_commit_locked(ts, touched)
        lsn = self._wal_append(payload, ts)
        if durable:
            self._durable_barrier(lsn)
        self.stats.commits += 1
        _COMMITS.inc()
        # Registration is visibility: it must not precede durability. The
        # non-durable path (group committer / 2PC coordinator) registers
        # itself after ITS barrier, while still holding the commit lock.
        if durable and self.on_commit_applied is not None:
            self.on_commit_applied(ts)
        return CommitReply(ts, {k: ts for k in touched[0]})

    def validate_locked(
        self, payload: TxnPayload, record_abort: bool = True
    ) -> None:
        """OCC backward validation; caller holds the commit lock.
        Raises Conflict (counting the abort unless the caller — e.g. the
        2PC coordinator, which counts one abort per transaction, not per
        failing shard — opts out)."""
        bad: List = []
        detail: List[Dict] = []

        def _explain(tag, key, winner):
            # conflict explainability: which shard rejected the item and
            # which commit ts won the race (obs.py / docs/observability.md)
            detail.append({"tag": tag, "key": key,
                           "shard": self.shard_id, "winner": winner})

        # 1. block read validation (observed version still current)
        for r in payload.reads:
            self.stats.validation_checks += 1
            cur = self.store.block_version(r.key)
            if cur != r.version:
                bad.append(("block", r.key))
                _explain("block", r.key, cur)
        # 2. name resolution validation
        for path, ver in payload.name_reads.items():
            cur = self.store.name_version(path)
            if cur != ver:
                bad.append(("name", path))
                _explain("name", path, cur)
        # 3. metadata (length) version validation
        for fid, ver in payload.meta_reads.items():
            try:
                cur_ver, _ = self.store.meta(fid)
            except Exception:
                cur_ver = -1
            if cur_ver != ver:
                bad.append(("meta", fid))
                _explain("meta", fid, cur_ver)
        # 4. length predicates (paper §4.2: reads assert file length)
        for pred in payload.predicates:
            try:
                mver, meta = self.store.meta(pred.file_id)
                length = meta.length if meta.exists else -1
            except Exception:
                mver, length = -1, -1
            if not pred.holds(length):
                bad.append(("predicate", pred))
                _explain("predicate", pred.file_id, mver)
        if bad:
            if record_abort:
                self.stats.aborts += 1
            for tag, _ in bad:
                _ABORT_CAUSE[tag].inc()
            raise Conflict(f"validation failed on {len(bad)} item(s)", bad,
                           detail=detail)

    def apply_locked(self, payload: TxnPayload, ts: Timestamp) -> Touched:
        """Apply the write set at ``ts``; caller holds the commit lock.
        All-or-nothing: an exception mid-apply rolls back this shard's
        partial work before propagating, so a 2PC coordinator only ever
        has to undo *fully applied* participants."""
        touched_blocks: List[BlockKey] = []
        touched_files: List[FileId] = []
        touched_names: List[str] = []
        try:
            for w in payload.writes:
                _, base = self.store.block(w.key)
                self.store.put_block(
                    w.key, w.apply_to(base, self.store.block_size), ts
                )
                touched_blocks.append(w.key)
            for fid, upd in payload.meta_updates.items():
                upd = normalize_meta_update(upd)
                if upd is None:
                    self.store.put_meta(fid, FileMeta(0, exists=False), ts)
                elif upd[0] == "t":
                    # mtime-only touch (in-place data write): mutates the
                    # current version in place — no version burned, no
                    # undo needed, invisible to the commit log
                    self.store.touch_meta(fid, ts)
                    continue
                else:
                    _, new_len, kind = upd
                    self.store.put_meta(
                        fid, FileMeta(new_len, exists=True, kind=kind,
                                      mtime_ts=ts), ts
                    )
                touched_files.append(fid)
            for path, fid in payload.name_updates.items():
                self.store.bind_name(path, fid, ts)
                touched_names.append(path)
        except BaseException:
            self.undo_locked((touched_blocks, touched_files, touched_names), ts)
            raise
        return touched_blocks, touched_files, touched_names

    def undo_locked(self, touched: Touched, ts: Timestamp) -> None:
        """Roll back an apply_locked(ts) (2PC abort after partial apply)."""
        blocks, files, names = touched
        for k in blocks:
            self.store.pop_block(k, ts)
        for fid in files:
            self.store.pop_meta(fid, ts)
        for path in names:
            self.store.pop_name(path, ts)

    def log_commit_locked(self, ts: Timestamp, touched: Touched) -> None:
        blocks, files, names = touched
        self._log.append(CommitRecord(ts, blocks, files, names))
        if len(self._log) > self.log_horizon:
            del self._log[: len(self._log) - self.log_horizon]

    # convenience for tests / benchmarks
    def alloc_file_id(self) -> FileId:
        return self.store.alloc_file_id()

    def bump_fid_floor(self, floor: FileId) -> None:
        """Never allocate a file id below ``floor`` (crash recovery: ids
        covered by durably-logged leases must not be re-issued)."""
        self.store.ensure_fid_floor(floor)

    def set_wal(self, wal) -> None:
        """Attach a durable log; subsequent commits fsync before acking."""
        self.wal = wal

    # ------------------------------------------------------------------ #
    # checkpointing: consistent snapshot export/import
    # ------------------------------------------------------------------ #
    @contextmanager
    def freeze(self):
        """Hold the commit lock so ``export_snapshot`` sees a consistent
        committed-and-durable state (every commit path holds this lock
        from apply through its durability barrier) and so a WAL rotation
        inside the freeze exactly brackets the snapshot."""
        with self.commit_lock:
            yield

    #: delta checkpoints: ``export_snapshot(since=...)`` emits only
    #: chains dirtied after that floor, and ``import_snapshot`` applies
    #: snapshots as per-chain overlays — so base+delta imports, in
    #: order, rebuild exactly the full state.
    supports_delta_export = True

    def export_snapshot(self, since: Optional[Timestamp] = None) -> Dict:
        """Wire-packable snapshot of the full shard state — current
        block/meta/namespace entries, the commit-log tail (cache
        invalidation scans survive a restart), and the sequencer. Caller
        holds the commit lock (``freeze``); only references are copied
        here, serialization happens outside the lock.

        With ``since`` (a prior snapshot's ``ts``), only chains dirtied
        after that commit timestamp are exported — the snapshot is a
        DELTA that must be imported on top of the state it was cut
        against. The returned ``ts`` is the floor for the next delta."""
        blocks, metas, names, next_fid = self.store.export_chains(since)
        return {
            "kind": "mono",
            "ts": self._ts,
            "next_fid": next_fid,
            "blocks": blocks,
            "metas": metas,
            "names": names,
            "log": [
                (r.ts, list(r.blocks), list(r.meta_files), list(r.names))
                for r in self._log
            ],
        }

    def import_snapshot(self, snap: Dict) -> None:
        """Rebuild this backend from an ``export_snapshot`` tree (crash
        recovery, before the WAL tail replays on top)."""
        if snap.get("kind") != "mono":
            raise ValueError(
                f"snapshot kind {snap.get('kind')!r} does not match this "
                "monolithic backend"
            )
        with self.commit_lock:
            self.store.import_chains(
                snap["blocks"], snap["metas"], snap["names"], snap["next_fid"]
            )
            if snap["ts"] > self._ts:
                self._ts = snap["ts"]
            self._log = [
                CommitRecord(
                    ts, [tuple(k) for k in blks], list(fids), list(nms)
                )
                for ts, blks, fids, nms in snap["log"]
            ]

    # ------------------------------------------------------------------ #
    # WAL crash recovery
    # ------------------------------------------------------------------ #
    def replay_commit(
        self, ts: Timestamp, effects, notify: bool = True
    ) -> None:
        """Re-apply one logged commit at its original timestamp. Rebuilds
        the exact version chains and resumes the sequencer; ``notify``
        suppresses ``on_commit_applied`` when a sharded coordinator
        registers the replay itself (2PC records)."""
        from repro_torch.core import wal as _wal

        payload = _wal.payload_from_effects(effects)
        with self.commit_lock:
            touched = self.apply_locked(payload, ts)
            self.log_commit_locked(ts, touched)
            if ts > self._ts:
                self._ts = ts
            if notify and self.on_commit_applied is not None:
                self.on_commit_applied(ts)

    def replay_record(self, rec) -> None:
        kind = rec[0]
        if kind != "c":
            raise ValueError(
                f"monolithic backend cannot replay record kind {kind!r}"
            )
        _, _, ts, effects = rec
        self.replay_commit(ts, effects)
