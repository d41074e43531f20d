"""Horizontally sharded transactional backend (λFS/Cloudburst-style).

``ShardedBackend`` hash-partitions state across N independent
``BackendService`` shards, each with its own sequencer, commit lock,
transaction log and undo chains:

  * **blocks + file metadata** partition by file id (a file's blocks are
    colocated with its metadata so file-local operations — sync_file,
    length predicates, RMW on one file — stay single-shard). File ids are
    allocated round-robin by the coordinator, so files spread uniformly.
  * **namespace entries** partition by a hash of the path.

**Global ordering** is tracked by a *sync vector* — one commit timestamp
per shard. Clients exchange vectors through the ``BackendAPI`` timestamp
algebra and never interpret them; block versions stay shard-local scalars
(a block lives entirely on one shard, and OCC validation only ever
compares a block's observed version for equality on its home shard).

**Snapshot consistency.** ``begin`` hands out the last *registered*
vector — updated only after a commit has fully applied, and, for a
cross-shard commit, updated for all participants atomically while the
coordinator still holds every participant's commit lock. Hence any
vector a client ever observes is a consistent cut: it either includes a
cross-shard transaction on all shards or on none. The vector is read
*before* the per-shard cache-update scans, so each component is ≤ the
point the client's cache is synced through — the invariant snapshot
cache hits rely on.

**Cross-shard commits** run two-phase commit. The coordinator splits the
payload per shard, acquires participant commit locks in shard order (no
deadlocks), and validates every shard's part. A transaction with no
effects anywhere (a multi-shard read transaction not marked read-only:
pure validation) finishes right there — it serializes at the validation
point, burns no timestamps, and releases immediately. Effectful
transactions get each effectful shard's next local timestamp and apply
**in parallel** (one thread per shard — overlapping the per-shard
durable-apply cost), the commit is logged as ONE atomic WAL record when
a log is attached, the sync vector registers all participants
atomically, and every lock releases. A Conflict on any shard aborts the
whole transaction before anything applies; an unexpected apply failure
rolls already-applied shards back through their undo chains.
Single-shard transactions — the common case by construction — take the
existing monolithic fast path untouched, including that shard's
group-commit batching.

**Why read-only participants do NOT release their locks early.** It is
tempting (λFS-style) to release a pure-reader shard's commit lock right
after its part validates. That is sound for write visibility (nothing
will be applied there) but UNSOUND for the consistent-cut guarantee:
with T1 = {read f1 on shard A, write f2 on shard B}, releasing A before
T1 registers lets T2 = {write f1 on A} validate, commit, and register
while T1 is still applying on B. A snapshot reader that begins in that
window gets a vector containing T2 but not T1 — yet T1's validated read
of f1 pins T1 *before* T2 in the serial order, so the cut observes a
later transaction while missing an earlier one. Anti-dependencies flow
through read shards; the read lock held through registration is exactly
what keeps every registered vector a prefix of the serial order.
"""
from __future__ import annotations

import threading
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import obs
from repro_torch.core.api import BackendAPI, CommitReply
from repro_torch.core.backend import (
    BackendService,
    BackendStats,
    BeginReply,
    Touched,
    TxnPayload,
)
from repro_torch.core.wire import StaleShardMap
from repro_torch.core.types import (
    BLOCK_SIZE_DEFAULT,
    BlockKey,
    CachePolicy,
    Conflict,
    FileId,
    Timestamp,
)

SyncVector = Tuple[Timestamp, ...]

# 2PC coordinator metrics, pre-bound at import time (see core/obs.py)
_2PC_FANOUT = obs.REGISTRY.histogram(
    "faasfs_2pc_fanout", buckets=obs.SIZE_BUCKETS, unit="shards",
    help="participant shards per cross-shard commit",
).labels()
_2PC_LOCK_WAIT = obs.REGISTRY.histogram(
    "faasfs_2pc_lock_wait_us", unit="us",
    help="time to acquire all participant commit locks",
).labels()
_2PC_ABORTS = obs.REGISTRY.counter(
    "faasfs_aborts_total", labels=("cause",),
    help="OCC validation failures by conflicting item kind",
).labels("2pc")


@dataclass
class CoordinatorStats:
    fast_commits: int = 0        # single-shard fast-path commits
    cross_commits: int = 0       # 2PC commits
    cross_aborts: int = 0        # 2PC validation aborts
    snapshot_commits: int = 0    # read-only commits


class ShardedBackend(BackendAPI):
    """In one process this is the whole sharded backend (owns every
    slot). As a *cluster participant* (``core/cluster.py``) it hosts a
    subset of a fixed global slot space: ``n_slots`` fixes the sync
    vector's length forever and rebalancing only reassigns which server
    owns which slot. Ops touching a slot not served here (unowned, or
    frozen mid-migration) raise ``StaleShardMap``."""

    def __init__(
        self,
        n_shards: int = 4,
        block_size: int = BLOCK_SIZE_DEFAULT,
        versions_kept: int = 16,
        policy: CachePolicy = CachePolicy.INVALIDATE,
        hot_threshold: int = 3,
        log_horizon: int = 4096,
        group_commit_window_s: float = 0.0,
        commit_service_s: float = 0.0,
        wal=None,
        slots: Optional[List[int]] = None,
        n_slots: Optional[int] = None,
        name_by_parent: bool = False,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if n_slots is None:
            n_slots = n_shards
        if slots is None:
            slots = list(range(n_slots))
        if any(s < 0 or s >= n_slots for s in slots):
            raise ValueError(f"slots {slots} out of range for {n_slots}")
        #: total slots == sync-vector length (NOT the locally owned count)
        self.n_shards = n_slots
        self.n_slots = n_slots
        self.name_by_parent = name_by_parent
        self.policy = policy
        self.wal = wal
        self._block_size = block_size
        self._svc_kw = dict(
            block_size=block_size,
            versions_kept=versions_kept,
            policy=policy,
            hot_threshold=hot_threshold,
            log_horizon=log_horizon,
            group_commit_window_s=group_commit_window_s,
            commit_service_s=commit_service_s,
        )
        self.shards: Dict[int, BackendService] = {}
        self._vec_lock = threading.Lock()
        self._applied: List[Timestamp] = [0] * n_slots
        self._gts = 0  # coordinator-assigned global commit timestamp
        self._fid_lock = threading.Lock()
        self._next_fid = 1
        self.coord_stats = CoordinatorStats()
        # cluster-participant 2PC + migration state
        self._prepared: Dict[Tuple, Dict] = {}      # txid -> held prepare
        self._decided: Dict[Tuple, Dict[int, Timestamp]] = {}
        self._pending_prep: Dict[Tuple, List] = {}  # replay-time in-doubt
        self._frozen: Set[int] = set()              # slots mid-migration
        self._freeze_svcs: Optional[Dict[int, BackendService]] = None
        # post-reply commit-effects hook (lease broker): fired with the
        # UNSPLIT payload after the fast path or 2PC acks — freshness
        # signal only, never on the correctness path (see backend.py)
        self.on_commit_effects = None
        for s in sorted(slots):
            self.shards[s] = self._new_service(s)

    def _new_service(self, slot: int) -> BackendService:
        sh = BackendService(**self._svc_kw)
        sh.on_commit_applied = self._make_register(slot)
        sh.shard_id = slot
        sh.wal = self.wal  # shards share ONE server-level log
        return sh

    # ------------------------------------------------------------------ #
    # partitioning
    # ------------------------------------------------------------------ #
    def shard_of_fid(self, fid: FileId) -> int:
        return fid % self.n_slots

    def shard_of_block(self, key: BlockKey) -> int:
        return self.shard_of_fid(key[0])

    def shard_of_name(self, path: str) -> int:
        key = path
        if self.name_by_parent:
            # colocate a directory's entries on one slot: hash the
            # parent path, so create/unlink/lookup bursts within one
            # directory stay single-shard
            cut = path.rfind("/")
            key = path[:cut] if cut > 0 else "/"
        return zlib.crc32(key.encode()) % self.n_slots

    def _svc(self, slot: int) -> BackendService:
        """The service for ``slot`` — typed refusal when this backend
        does not (or no longer) serve it, so map-routed clients refetch
        the ShardMap and retry instead of reading stale state."""
        sh = self.shards.get(slot)
        if sh is None or slot in self._frozen:
            raise StaleShardMap(f"slot {slot} not served here")
        return sh

    # ------------------------------------------------------------------ #
    # sync-vector registration (the consistent-cut machinery)
    # ------------------------------------------------------------------ #
    def _make_register(self, shard_idx: int):
        def register(ts: Timestamp) -> None:
            # called by the shard under ITS commit lock, after full apply
            with self._vec_lock:
                self._gts += 1
                if ts > self._applied[shard_idx]:
                    self._applied[shard_idx] = ts
        return register

    def _registered_vector(self) -> SyncVector:
        with self._vec_lock:
            return tuple(self._applied)

    # ------------------------------------------------------------------ #
    # BackendAPI: properties + timestamp algebra
    # ------------------------------------------------------------------ #
    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def zero_ts(self) -> SyncVector:
        return (0,) * self.n_slots

    @property
    def latest_ts(self) -> SyncVector:
        return self._registered_vector()

    @property
    def stats(self) -> BackendStats:
        """Aggregate of per-shard stats plus the coordinator's 2PC
        commits/aborts (2PC validation failures are NOT also counted on
        the failing shards, so one logical abort counts once). Note
        ``begins`` counts per-shard log scans — n_shards per client
        begin, since begin fans out to every shard."""
        agg = BackendStats()
        for sh in self.shards.values():
            s = sh.stats
            agg.commits += s.commits
            agg.aborts += s.aborts
            agg.begins += s.begins
            agg.blocks_pushed += s.blocks_pushed
            agg.blocks_invalidated += s.blocks_invalidated
            agg.block_fetches += s.block_fetches
            agg.bytes_pushed += s.bytes_pushed
            agg.validation_checks += s.validation_checks
            agg.group_batches += s.group_batches
            agg.group_committed += s.group_committed
        agg.commits += self.coord_stats.cross_commits
        agg.aborts += self.coord_stats.cross_aborts
        return agg

    def ts_geq(self, a, b) -> bool:
        return all(x >= y for x, y in zip(a, b))

    def snapshot_cache_ok(self, key, version, at_ts, last_sync_ts) -> bool:
        s = self.shard_of_block(key)
        return version <= at_ts[s] and last_sync_ts[s] >= at_ts[s]

    def _local_at(self, at_ts, shard_idx: int) -> Optional[Timestamp]:
        if at_ts is None:
            return None
        return at_ts[shard_idx]

    # ------------------------------------------------------------------ #
    # BackendAPI: RPCs
    # ------------------------------------------------------------------ #
    def begin(
        self,
        last_sync_ts,
        cached_keys: Optional[Set[BlockKey]] = None,
        policy: Optional[CachePolicy] = None,
    ) -> BeginReply:
        # Take the snapshot vector BEFORE the per-shard scans: every
        # component is then ≤ the log point each shard's reply covers,
        # so advancing the client's last_sync_ts to this vector never
        # claims sync coverage the cache doesn't have.
        read_vec = self._registered_vector()
        last = self._as_vector(last_sync_ts)
        keys_by_slot: Dict[int, Set[BlockKey]] = {}
        invals: List[BlockKey] = []
        if cached_keys is not None:
            for k in cached_keys:
                s = self.shard_of_block(k)
                if s in self.shards and s not in self._frozen:
                    keys_by_slot.setdefault(s, set()).add(k)
                else:
                    # not served here (migrated / mid-freeze): the only
                    # safe answer is "drop it" — an invalidation
                    invals.append(k)

        updates: Dict[BlockKey, Tuple[Timestamp, bytes]] = {}
        file_invals: List[FileId] = []
        for s, sh in sorted(self.shards.items()):
            if s in self._frozen:
                continue
            keys = None if cached_keys is None else keys_by_slot.get(s, set())
            r = sh.begin(last[s], keys, policy)
            updates.update(r.updates)
            invals.extend(r.invalidations)
            file_invals.extend(r.file_invalidations)
        return BeginReply(read_vec, updates, invals, file_invals)

    def _as_vector(self, ts) -> SyncVector:
        if isinstance(ts, int):
            return (ts,) * self.n_slots
        return tuple(ts)

    def sync_files(self, reqs):
        # fan out per home shard, merge coordinator-side: ONE logical
        # round trip for the client no matter how many files (or shards)
        out: Dict[FileId, Dict[BlockKey, Tuple[Timestamp, bytes]]] = {}
        by_shard: Dict[int, Dict[FileId, Dict[BlockKey, Timestamp]]] = {}
        for fid, known in reqs.items():
            by_shard.setdefault(self.shard_of_fid(fid), {})[fid] = known
        for s, sub in by_shard.items():
            out.update(self._svc(s).sync_files(sub))
        return out

    def fetch_blocks(self, keys, at_ts=None):
        # group by home shard, fetch each shard's slice as one batch,
        # reassemble in input order (like begin, the fan-out is merged
        # here — server-side over the wire — not paid by the client)
        by_shard: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            by_shard.setdefault(self.shard_of_block(key), []).append(i)
        out: List[Optional[Tuple[Timestamp, bytes]]] = [None] * len(keys)
        for s, idxs in by_shard.items():
            got = self._svc(s).fetch_blocks(
                [keys[i] for i in idxs], self._local_at(at_ts, s)
            )
            for i, entry in zip(idxs, got):
                out[i] = entry
        return out  # type: ignore[return-value]

    def fetch_metas(self, fids, at_ts=None):
        by_shard: Dict[int, List[int]] = {}
        for i, fid in enumerate(fids):
            by_shard.setdefault(self.shard_of_fid(fid), []).append(i)
        out: List[Optional[Tuple[Timestamp, object]]] = [None] * len(fids)
        for s, idxs in by_shard.items():
            got = self._svc(s).fetch_metas(
                [fids[i] for i in idxs], self._local_at(at_ts, s)
            )
            for i, entry in zip(idxs, got):
                out[i] = entry
        return out

    def lookup_many(self, paths, at_ts=None):
        by_shard: Dict[int, List[int]] = {}
        for i, path in enumerate(paths):
            by_shard.setdefault(self.shard_of_name(path), []).append(i)
        out: List[Optional[Tuple[Timestamp, Optional[FileId]]]] = (
            [None] * len(paths)
        )
        for s, idxs in by_shard.items():
            got = self._svc(s).lookup_many(
                [paths[i] for i in idxs], self._local_at(at_ts, s)
            )
            for i, entry in zip(idxs, got):
                out[i] = entry
        return out  # type: ignore[return-value]

    def listdir(self, prefix, at_ts=None):
        if self._frozen:
            # a prefix scan cannot prove the frozen slot holds no
            # matching entries; force the client to retry post-migration
            raise StaleShardMap("slot(s) frozen for migration")
        out: List[Tuple[str, Timestamp, Optional[FileId]]] = []
        for s, sh in sorted(self.shards.items()):
            out.extend(sh.listdir(prefix, self._local_at(at_ts, s)))
        return sorted(out)

    def alloc_file_id(self) -> FileId:
        with self._fid_lock:
            fid = self._next_fid
            self._next_fid += 1
            return fid

    def bump_fid_floor(self, floor: FileId) -> None:
        with self._fid_lock:
            if floor > self._next_fid:
                self._next_fid = floor
        for sh in self.shards.values():
            sh.bump_fid_floor(floor)

    def set_wal(self, wal) -> None:
        """Attach one server-level durable log to the coordinator and all
        shards (fast-path commits log per shard, 2PC logs one atomic
        record)."""
        self.wal = wal
        for sh in self.shards.values():
            sh.wal = wal

    # ------------------------------------------------------------------ #
    # checkpointing: one snapshot covering every shard + the coordinator
    # ------------------------------------------------------------------ #
    @contextmanager
    def freeze(self):
        """Hold EVERY shard's commit lock (in shard order, like 2PC, so
        no deadlock against a concurrent cross-shard commit). With all
        locks held, no commit can apply or register anywhere, so the
        per-shard snapshots plus the sync vector form one consistent
        cut — and a WAL rotation inside the freeze exactly brackets it.

        A prepared-but-undecided distributed txn holds its slots' locks,
        so a freeze (and hence a checkpoint) cannot land between a prep
        marker and its decision — snapshots never contain prepared
        state, and compacting covered prep/dec records is safe.

        The service map is captured up front: a concurrent migration may
        pop (mig_drop) or install (mig_import) slots while we wait on a
        frozen slot's lock, and the freeze must acquire exactly the locks
        it will release. ``export_snapshot`` re-checks ownership at
        export time so a slot dropped mid-freeze never lands in a
        checkpoint (it would resurrect on recovery)."""
        svcs = dict(sorted(self.shards.items()))
        for s in svcs:
            svcs[s].commit_lock.acquire()
        self._freeze_svcs = svcs
        try:
            yield
        finally:
            self._freeze_svcs = None
            for s in reversed(list(svcs)):
                svcs[s].commit_lock.release()

    #: delta checkpoints: ``since`` is a per-slot floor dict; every
    #: owned slot appears in the snapshot (a slot absent from ``since``
    #: — e.g. migrated in after the base — exports in full), so a delta
    #: import's slot-reconciliation still sees the true ownership set.
    supports_delta_export = True

    def export_snapshot(
        self, since: Optional[Dict[int, Timestamp]] = None
    ) -> Dict:
        """Caller holds every shard lock (``freeze``). ``since`` maps
        slot -> that shard's previous snapshot ``ts`` (shard-local
        clocks); each shard exports only chains dirtied past its own
        floor. The next floor is ``{slot: shard_snap["ts"]}``."""
        with self._vec_lock:
            applied = list(self._applied)
            gts = self._gts
        with self._fid_lock:
            next_fid = self._next_fid
        base = self._freeze_svcs if self._freeze_svcs is not None \
            else dict(self.shards)
        # only slots still owned: one dropped mid-freeze must not be
        # checkpointed back into existence
        svcs = {s: sh for s, sh in base.items() if self.shards.get(s) is sh}
        slots = sorted(svcs)
        return {
            "kind": "sharded",
            "n": self.n_slots,
            "slots": slots,
            "shards": [
                svcs[s].export_snapshot(
                    since.get(s) if since is not None else None
                )
                for s in slots
            ],
            "applied": applied,
            "gts": gts,
            "next_fid": next_fid,
        }

    def import_snapshot(self, snap: Dict) -> None:
        if snap.get("kind") != "sharded" or snap.get("n") != self.n_slots:
            raise ValueError(
                f"snapshot kind={snap.get('kind')!r} n={snap.get('n')!r} "
                f"does not match this {self.n_slots}-slot backend"
            )
        # pre-slot snapshots (no "slots" key) cover the full range
        slots = snap.get("slots", list(range(snap["n"])))
        for s, state in zip(slots, snap["shards"]):
            sh = self.shards.get(s)
            if sh is None:
                sh = self._new_service(s)
                self.shards[s] = sh
            sh.import_snapshot(state)
        # ownership matches the snapshot exactly: a slot migrated away
        # before the checkpoint must not resurrect as an empty service
        for s in list(self.shards):
            if s not in set(slots):
                del self.shards[s]
        with self._vec_lock:
            for i, ts in enumerate(snap["applied"]):
                if ts > self._applied[i]:
                    self._applied[i] = ts
            if snap["gts"] > self._gts:
                self._gts = snap["gts"]
        with self._fid_lock:
            if snap["next_fid"] > self._next_fid:
                self._next_fid = snap["next_fid"]

    # ------------------------------------------------------------------ #
    # WAL crash recovery
    # ------------------------------------------------------------------ #
    def replay_record(self, rec) -> None:
        """Re-apply one WAL record: single-shard commits replay through
        the shard (whose register hook rebuilds the sync vector); 2PC
        records replay all participants and register ONE consistent cut.
        Cluster markers (prep/dec, migration) rebuild the participant's
        2PC and slot-ownership state."""
        kind = rec[0]
        if kind == "c":
            _, s, ts, effects = rec
            if s in self.shards:  # a since-dropped slot's record is moot
                self.shards[s].replay_commit(ts, effects)
            return
        if kind == "x":
            _, participants = rec
            for s, ts, effects in participants:
                if s in self.shards:
                    self.shards[s].replay_commit(ts, effects, notify=False)
            with self._vec_lock:
                self._gts += 1
                for s, ts, _ in participants:
                    if ts > self._applied[s]:
                        self._applied[s] = ts
            return
        if kind == "prep":
            _, txid, participants = rec
            self._pending_prep[tuple(txid)] = participants
            return
        if kind == "dec":
            _, txid, verdict = rec
            participants = self._pending_prep.pop(tuple(txid), None)
            if verdict == "c" and participants is not None:
                for s, ts, effects in participants:
                    self.shards[s].replay_commit(ts, effects, notify=False)
                with self._vec_lock:
                    self._gts += 1
                    for s, ts, _ in participants:
                        if ts > self._applied[s]:
                            self._applied[s] = ts
                self._decided[tuple(txid)] = \
                    {s: ts for s, ts, _ in participants}
            else:
                self._decided[tuple(txid)] = {}
            return
        if kind == "mig-in":
            for s, state in rec[1]:
                self._install_slot(s, state)
            return
        if kind == "mig-out":
            for s in rec[1]:
                self.shards.pop(s, None)
                self._frozen.discard(s)
            return
        raise ValueError(f"unknown WAL record kind {kind!r}")

    # ------------------------------------------------------------------ #
    # commit: single-shard fast path or cross-shard 2PC
    # ------------------------------------------------------------------ #
    def commit(self, payload: TxnPayload) -> CommitReply:
        """Commit. The reply's ``ts`` is always a coordinator-global
        scalar (never a shard-local clock or a vector), so consumers that
        store or order commit timestamps see one uniform kind across the
        fast path, 2PC, and read-only commits; per-block shard-local
        versions travel in ``block_versions``."""
        if payload.read_only and not payload.has_effects():
            self.coord_stats.snapshot_commits += 1
            return CommitReply(self._current_gts())
        parts = self._split(payload)
        if len(parts) == 1:
            ((s, part),) = parts.items()
            sh = self._svc(s)
            reply = sh.commit(part)
            # the slot may have been frozen + migrated away while this
            # commit waited on its lock: the export then predates this
            # apply, so acking would lose the write. Refuse instead —
            # the client retries against the new owner (the orphan apply
            # is discarded with the dropped service; replay_record skips
            # its WAL record the same way).
            if self.shards.get(s) is not sh or s in self._frozen:
                raise StaleShardMap(f"slot {s} migrated during commit")
            self.coord_stats.fast_commits += 1
            # the shard registered this commit (bumping _gts) before its
            # commit returned, so the gts read here is >= the one this
            # commit was assigned — a valid monotone commit token
            slot_ts = {s: reply.ts} if part.has_effects() else {}
            out = CommitReply(self._current_gts(), reply.block_versions,
                              slot_ts=slot_ts)
        else:
            out = self._commit_2pc(parts)
        if self.on_commit_effects is not None:
            self.on_commit_effects(out.ts, payload)
        return out

    def _current_gts(self) -> Timestamp:
        with self._vec_lock:
            return self._gts

    def _split(self, payload: TxnPayload) -> Dict[int, TxnPayload]:
        parts: Dict[int, TxnPayload] = {}

        def part(s: int) -> TxnPayload:
            p = parts.get(s)
            if p is None:
                local_read = (
                    payload.read_ts[s]
                    if isinstance(payload.read_ts, tuple)
                    else payload.read_ts
                )
                p = TxnPayload(read_ts=local_read, read_only=payload.read_only)
                parts[s] = p
            return p

        for r in payload.reads:
            part(self.shard_of_block(r.key)).reads.append(r)
        for w in payload.writes:
            part(self.shard_of_block(w.key)).writes.append(w)
        for pred in payload.predicates:
            part(self.shard_of_fid(pred.file_id)).predicates.append(pred)
        for fid, new_len in payload.meta_updates.items():
            part(self.shard_of_fid(fid)).meta_updates[fid] = new_len
        for fid, ver in payload.meta_reads.items():
            part(self.shard_of_fid(fid)).meta_reads[fid] = ver
        for path, fid in payload.name_updates.items():
            part(self.shard_of_name(path)).name_updates[path] = fid
        for path, ver in payload.name_reads.items():
            part(self.shard_of_name(path)).name_reads[path] = ver
        if not parts:  # effect-free non-read-only txn: pure validation
            parts[0] = TxnPayload(
                read_ts=payload.read_ts[0]
                if isinstance(payload.read_ts, tuple)
                else payload.read_ts,
                read_only=payload.read_only,
            )
        return parts

    def _commit_2pc(self, parts: Dict[int, TxnPayload]) -> CommitReply:
        order = sorted(parts)
        svcs = {s: self._svc(s) for s in order}
        _2PC_FANOUT.observe(len(order))
        t_lock = obs.now_us()
        for s in order:
            svcs[s].commit_lock.acquire()
        _2PC_LOCK_WAIT.observe(obs.now_us() - t_lock)
        try:
            for s in order:
                # re-check under the lock (see prepare): a slot that
                # migrated away while we waited must not be committed to
                if self.shards.get(s) is not svcs[s] or s in self._frozen:
                    raise StaleShardMap(f"slot {s} migrated during commit")
            # ---- phase 1: per-shard OCC validation (prepare). In-process
            # validation is pure-Python work the GIL serializes anyway, so
            # shards validate in a plain loop; a networked transport would
            # fan the prepare RPCs out concurrently instead.
            errors: Dict[int, Conflict] = {}
            for s in order:
                try:
                    svcs[s].validate_locked(parts[s], record_abort=False)
                except Conflict as e:
                    errors[s] = e
            if errors:
                self.coord_stats.cross_aborts += 1
                _2PC_ABORTS.inc()
                keys: List = []
                detail: List = []
                for e in errors.values():
                    keys.extend(e.keys)
                    # each shard's validate_locked already stamped its
                    # own shard id on the detail entries
                    detail.extend(e.detail)
                raise Conflict(
                    f"2pc validation failed on {len(errors)} shard(s)", keys,
                    detail=detail,
                )

            eff = [s for s in order if parts[s].has_effects()]
            if not eff:
                # pure validation (multi-shard read txn not marked
                # read-only): serializes at the validation point; no state
                # changes, no timestamps burned, locks release in finally
                self.coord_stats.cross_commits += 1
                return CommitReply(self._current_gts())
            # NOTE: read-only participants' locks stay held until the sync
            # vector registers — releasing them here would let a later
            # conflicting writer register first and hand snapshot readers
            # a non-serializable cut (see the module docstring).

            # ---- phase 2: apply effectful shards in parallel (one thread
            # per shard overlaps their durable-apply service time), undo on
            # unexpected failure ----
            ts_map = {s: svcs[s].next_ts_locked() for s in eff}
            applied: Dict[int, Touched] = {}
            failures: List[BaseException] = []

            def apply_on(s: int) -> None:
                try:
                    svcs[s]._service()
                    applied[s] = svcs[s].apply_locked(
                        parts[s], ts_map[s]
                    )
                except BaseException as e:  # apply_locked rolled itself back
                    failures.append(e)

            if len(eff) == 1:
                apply_on(eff[0])
            else:
                workers = [
                    threading.Thread(target=apply_on, args=(s,)) for s in eff
                ]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join()
            if failures:
                for s in sorted(applied, reverse=True):
                    svcs[s].undo_locked(applied[s], ts_map[s])
                raise failures[0]
            for s in eff:
                svcs[s].log_commit_locked(ts_map[s], applied[s])

            # ---- durability: ONE atomic record for all participants,
            # fsync'd before the commit becomes visible or acked ----
            if self.wal is not None:
                from repro_torch.core import wal as _wal

                lsn = self.wal.append(
                    (
                        "x",
                        [
                            (s, ts_map[s], _wal.effects_from_payload(parts[s]))
                            for s in eff
                        ],
                    )
                )
                self.wal.sync(lsn)

            # ---- register: atomic for all participants (consistent cut) ----
            with self._vec_lock:
                self._gts += 1
                gts = self._gts
                for s in eff:
                    if ts_map[s] > self._applied[s]:
                        self._applied[s] = ts_map[s]
            self.coord_stats.cross_commits += 1

            block_versions = {
                w.key: ts_map[s]
                for s in eff
                for w in parts[s].writes
            }
            return CommitReply(gts, block_versions,
                               slot_ts=dict(ts_map))
        finally:
            for s in reversed(order):
                svcs[s].commit_lock.release()

    # ------------------------------------------------------------------ #
    # cluster participant: distributed 2PC (durable prepare/decide markers)
    # ------------------------------------------------------------------ #
    def prepare(self, txid: Tuple, parts: Dict[int, TxnPayload]
                ) -> Dict[int, Timestamp]:
        """Phase 1 for a cluster coordinator: acquire the touched slots'
        commit locks (slot order), validate, reserve commit timestamps,
        durably log the ``prep`` marker, and vote yes by returning the
        per-slot timestamps. On success the locks STAY HELD until
        ``decide`` — including for read-only slots (see the module
        docstring: anti-dependencies flow through read slots, so an
        early release would break the consistent-cut guarantee). On
        Conflict (vote no) everything is released and nothing is logged
        — the coordinator presumes abort."""
        order = sorted(parts)
        svcs = {s: self._svc(s) for s in order}
        for s in order:
            svcs[s].commit_lock.acquire()
        try:
            for s in order:
                # re-check under the lock: the slot may have migrated
                # away (or frozen) while we waited for it
                if self.shards.get(s) is not svcs[s] or s in self._frozen:
                    raise StaleShardMap(f"slot {s} migrated during prepare")
            errors: Dict[int, Conflict] = {}
            for s in order:
                try:
                    svcs[s].validate_locked(parts[s], record_abort=False)
                except Conflict as e:
                    errors[s] = e
            if errors:
                _2PC_ABORTS.inc()
                keys: List = []
                detail: List = []
                for e in errors.values():
                    keys.extend(e.keys)
                    detail.extend(e.detail)
                raise Conflict(
                    f"prepare failed on {len(errors)} slot(s)", keys,
                    detail=detail,
                )
            eff = [s for s in order if parts[s].has_effects()]
            ts_map = {s: svcs[s].next_ts_locked() for s in eff}
            if self.wal is not None:
                from repro_torch.core import wal as _wal

                lsn = self.wal.append((
                    "prep", tuple(txid),
                    [(s, ts_map[s], _wal.effects_from_payload(parts[s]))
                     for s in eff],
                ))
                self.wal.sync(lsn)
            obs.crash_point("prep-logged")
            self._prepared[tuple(txid)] = {
                "parts": parts, "ts": ts_map, "order": order, "eff": eff,
            }
            return dict(ts_map)
        except BaseException:
            for s in reversed(order):
                svcs[s].commit_lock.release()
            raise

    def decide(self, txid: Tuple, commit: bool) -> Dict[int, Timestamp]:
        """Phase 2: durably log the ``dec`` marker, then apply (or
        discard) the prepared effects and release the slot locks.
        Idempotent — a duplicate decide (coordinator retry, recovery
        push) acks with the recorded outcome."""
        txid = tuple(txid)
        st = self._prepared.pop(txid, None)
        if st is None:
            return dict(self._decided.get(txid) or {})
        try:
            if self.wal is not None:
                lsn = self.wal.append(("dec", txid, "c" if commit else "a"))
                self.wal.sync(lsn)
            obs.crash_point("dec-logged")
            if commit:
                if st["parts"] is not None:
                    applied: Dict[int, Touched] = {}
                    for s in st["eff"]:
                        sh = self.shards[s]
                        sh._service()
                        applied[s] = sh.apply_locked(
                            st["parts"][s], st["ts"][s]
                        )
                    for s in st["eff"]:
                        self.shards[s].log_commit_locked(
                            st["ts"][s], applied[s]
                        )
                else:
                    # recovered (in-doubt) prepare: apply from the WAL
                    # effects — under the locks finish_recovery() holds,
                    # so replay_commit's own locking cannot be used here
                    from repro_torch.core import wal as _wal

                    for s, ts, effects in st["effects"]:
                        sh = self.shards[s]
                        touched = sh.apply_locked(
                            _wal.payload_from_effects(effects), ts
                        )
                        sh.log_commit_locked(ts, touched)
                        if ts > sh._ts:
                            sh._ts = ts
                with self._vec_lock:
                    self._gts += 1
                    for s, ts in st["ts"].items():
                        if ts > self._applied[s]:
                            self._applied[s] = ts
                self.coord_stats.cross_commits += 1
                self._decided[txid] = dict(st["ts"])
            else:
                self._decided[txid] = {}
        finally:
            for s in reversed(st["order"]):
                self.shards[s].commit_lock.release()
        obs.crash_point("dec-applied")
        return dict(self._decided[txid])

    def in_doubt(self) -> List[Tuple]:
        """Txids prepared here whose decision is unknown — recovered
        prepares awaiting resolution AND live prepares still holding
        their slot locks. The latter matter to a RESTARTED coordinator:
        its predecessor may have died between this participant's yes
        vote and the decision, and unless the vote is reported the new
        coordinator can never release the slots (presumed abort needs
        someone to ask)."""
        out = set(self._pending_prep)
        out.update(self._prepared)
        return sorted(out)

    def finish_recovery(self) -> None:
        """Convert replayed-but-undecided prepares into held prepared
        state: acquire their slots' commit locks so no conflicting
        commit (or checkpoint freeze) can slip in before the
        coordinator's decision arrives. Two prepared txns never share a
        slot (prepare holds the lock), so the acquisition order cannot
        deadlock."""
        for txid in sorted(self._pending_prep):
            participants = self._pending_prep[txid]
            order = sorted(s for s, _, _ in participants)
            for s in order:
                self.shards[s].commit_lock.acquire()
            self._prepared[txid] = {
                "parts": None,
                "effects": participants,
                "ts": {s: ts for s, ts, _ in participants},
                "order": order,
                "eff": [s for s, _, _ in participants],
            }
        self._pending_prep.clear()

    # ------------------------------------------------------------------ #
    # cluster participant: status + digests
    # ------------------------------------------------------------------ #
    def shard_status(self, digests: bool = False) -> Dict:
        with self._vec_lock:
            applied = {s: self._applied[s] for s in self.shards}
        st = {
            "slots": sorted(self.shards),
            "frozen": sorted(self._frozen),
            "applied": applied,
            "in_doubt": [list(t) for t in self.in_doubt()],
        }
        if digests:
            st["digests"] = self.slot_digests()
        return st

    def slot_digests(self) -> Dict[int, str]:
        """Content digest per owned slot, for exactly-once proofs across
        crash recovery. Computed under each slot's commit lock (frozen
        slots are immutable and exported lock-free); canonicalized so
        dict insertion order — which differs between live-apply and
        replay — cannot change the digest. Only durable CONTENT is
        hashed (entries + their commit timestamps): the sequencer
        position and the invalidation-log tail legitimately diverge
        between a live process and its replayed twin — an aborted
        prepare bumps the live clock, presumed abort logs nothing —
        while a lost or double-applied commit always shows up in the
        entry versions."""
        import hashlib

        out: Dict[int, str] = {}
        for s in sorted(self.shards):
            sh = self.shards[s]
            if s in self._frozen:
                snap = sh.export_snapshot()
            else:
                with sh.commit_lock:
                    snap = sh.export_snapshot()
            content = {k: snap[k] for k in
                       ("blocks", "metas", "names", "next_fid")}
            out[s] = hashlib.sha256(_canon_bytes(content)).hexdigest()
        return out

    # ------------------------------------------------------------------ #
    # cluster participant: live slot migration
    # ------------------------------------------------------------------ #
    def mig_export(self, slots: List[int]) -> List[Tuple[int, Dict]]:
        """Freeze ``slots`` and export their states. The commit locks
        are acquired here and stay held (the freeze) until ``mig_drop``
        (migration completed) or ``mig_abort`` (rolled back) releases
        them — from whatever worker thread those land on. While frozen,
        every op touching the slot answers ``StaleShardMap``."""
        order = sorted(set(slots))
        svcs = {s: self._svc(s) for s in order}
        for s in order:
            svcs[s].commit_lock.acquire()
        states = []
        with self._vec_lock:
            applied = {s: self._applied[s] for s in order}
        for s in order:
            state = svcs[s].export_snapshot()
            state["applied"] = applied[s]
            states.append((s, state))
        self._frozen.update(order)
        obs.crash_point("mig-exported")
        return states

    def mig_import(self, slot_states: List[Tuple[int, Dict]]) -> None:
        """Install migrated slot states, durably logged FIRST — a crash
        after the ack replays the ``mig-in`` and still owns the slots."""
        if self.wal is not None:
            lsn = self.wal.append(("mig-in", list(slot_states)))
            self.wal.sync(lsn)
        obs.crash_point("mig-imported")
        for s, state in slot_states:
            self._install_slot(s, state)

    def _install_slot(self, slot: int, state: Dict) -> None:
        sh = self._new_service(slot)
        sh.import_snapshot(state)
        self.shards[slot] = sh
        applied = state.get("applied", 0)
        with self._vec_lock:
            if applied > self._applied[slot]:
                self._applied[slot] = applied

    def mig_drop(self, slots: List[int]) -> None:
        """Source-side completion: durably forget the slots, unfreeze,
        release their locks. Idempotent (recovery sweeps re-send it)."""
        owned = [s for s in sorted(set(slots)) if s in self.shards]
        if owned and self.wal is not None:
            lsn = self.wal.append(("mig-out", owned))
            self.wal.sync(lsn)
        for s in owned:
            sh = self.shards.pop(s)
            if s in self._frozen:
                self._frozen.discard(s)
                sh.commit_lock.release()

    def mig_abort(self, slots: List[int]) -> None:
        """Roll back a freeze: unfreeze + release, keep the state.
        Benign for slots not frozen here."""
        for s in sorted(set(slots)):
            if s in self._frozen:
                self._frozen.discard(s)
                sh = self.shards.get(s)
                if sh is not None:
                    sh.commit_lock.release()


def _canon_bytes(tree) -> bytes:
    """wire-pack ``tree`` with every dict's entries sorted by their
    packed key bytes, recursively — a canonical byte form insensitive to
    insertion order."""
    from repro_torch.core import wire as _wire

    def canon(x):
        if isinstance(x, dict):
            items = [(canon(k), canon(v)) for k, v in x.items()]
            items.sort(key=lambda kv: _wire.pack(kv[0]))
            return ("\x00canon-map", items)
        if isinstance(x, (list, tuple)):
            return tuple(canon(v) for v in x)
        return x

    return _wire.pack(canon(tree))
