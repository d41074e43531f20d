"""Elastic shard cluster: a coordinator process in front of N per-shard
server processes, behind one versioned ``ShardMap``.

Topology. The global key space is ``n_slots`` fixed-forever *slots*
(``slot = fid % n_slots``; directory entries hash by path or — with the
``name_by_parent`` map flag — by parent directory, colocating one dir's
entries). Each slot is owned by exactly one **shard server** process
(``repro.core.server`` running a slot-subset ``ShardedBackend`` with its
own event loop, segmented WAL and checkpointing). The **coordinator**
(this module) owns the authoritative ``ShardMap``::

    {"v": version, "n_slots": S, "slots": [addr_idx per slot],
     "addrs": [[host, port], ...], "flags": {"name_by_parent": bool}}

The map rides in the coordinator's hello and its version is advertised
on EVERY reply frame (``FLAG_MAPV`` envelope) — epoch-style, so clients
learn about rebalances passively. A shard server answering an op for a
slot it does not (or no longer) serve raises ``StaleShardMap``; the
client refetches the map and retries, exactly mirroring ``StaleEpoch``
for id leases.

Transactions. ``begin`` and ``commit`` route through the coordinator:

  * **begin** snapshots the *effective vector* — per-slot max applied
    timestamps as reported by acked commits, capped below any prepared-
    but-undecided 2PC timestamp (``_floors``) so no snapshot can claim
    coverage of a commit that is not yet applied everywhere — then fans
    the cache-sync scans out to the shard servers.
  * **single-server commits** (all touched slots on one server) forward
    as one plain ``T_COMMIT``: the server's local ShardedBackend runs
    its fast path or in-process 2PC and logs ONE atomic WAL record; the
    reply's ``slot_ts`` advances the coordinator's reported vector.
  * **cross-server commits** run real presumed-abort 2PC with durable
    markers. Prepares go out sequentially in server order (deadlock
    avoidance); each participant validates under its slot locks, logs a
    ``prep`` marker + fsync, and KEEPS the locks. Any no-vote or error
    aborts the yes-voters (nothing logged: presumed abort). On unanimous
    yes the coordinator installs the floor, durably logs ``("xdec",
    txid, participants)``, then pushes ``T_DECIDE``; participants log a
    ``dec`` marker + fsync before applying at the prepared timestamps.
    In-doubt participants (prep without dec after a crash) re-pin their
    slot locks at recovery and ask ``T_RESOLVE``: "c" if the decision is
    logged, "pending" while the txn is still in flight, else "a". The
    coordinator also pushes unacked decisions itself (startup + a
    background retry), so either side recovering first converges — no
    acked commit is lost, nothing applies twice.

Rebalancing. ``T_REBALANCE`` (admin-gated) moves slots live: log
``mig-start`` → source freezes the slots under their commit locks and
exports (``mig-exported``) → target durably logs ``mig-in`` BEFORE
installing (``mig-imported``) → coordinator logs the bumped ``cmap``
(``mig-mapped``) and flips the map → source durably drops
(``mig-out``). Recovery rolls forward iff the target imported (its WAL
proves it), else rolls back by unfreezing the source; a startup sweep
re-sends drops for slots the map no longer assigns. While frozen, every
op on the slot answers ``StaleShardMap`` — clients stall into a
refetch+retry instead of reading torn state.

Run standalone::

    python -m repro.core.cluster --wal /tmp/coord \\
        --shard 127.0.0.1:7001 --shard 127.0.0.1:7002
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core import obs, wire
from repro_torch.core.api import BackendAPI, CommitReply
from repro_torch.core.backend import BackendStats, BeginReply, TxnPayload
from repro_torch.core.remote import RemoteBackend
from repro_torch.core.server import BackendServer
from repro_torch.core.types import BlockKey, CachePolicy, Conflict, FileId, Timestamp
from repro_torch.core.wire import StaleShardMap

SyncVector = Tuple[Timestamp, ...]

_XDECS = obs.REGISTRY.counter(
    "faasfs_coord_decisions_total", help="durably logged 2PC decisions",
).labels()
_MIGRATIONS = obs.REGISTRY.counter(
    "faasfs_coord_migrations_total", help="completed slot migrations",
).labels()


# --------------------------------------------------------------------------- #
# ShardMap helpers
# --------------------------------------------------------------------------- #
def make_map(addrs: List[Tuple[str, int]], n_slots: int,
             name_by_parent: bool = False) -> Dict[str, Any]:
    return {
        "v": 1,
        "n_slots": n_slots,
        "slots": [i % len(addrs) for i in range(n_slots)],
        "addrs": [[h, p] for h, p in addrs],
        "flags": {"name_by_parent": bool(name_by_parent)},
    }


def slot_of_name(path: str, n_slots: int, by_parent: bool) -> int:
    key = path
    if by_parent:
        cut = path.rfind("/")
        key = path[:cut] if cut > 0 else "/"
    return zlib.crc32(key.encode()) % n_slots


def split_payload(payload: TxnPayload, n_slots: int,
                  by_parent: bool) -> Dict[int, TxnPayload]:
    """Partition one client payload into per-slot payloads (mirrors
    ``ShardedBackend._split`` — the partition function is wire contract)."""
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

    def slot_fid(fid: int) -> int:
        return fid % n_slots

    for r in payload.reads:
        part(slot_fid(r.key[0])).reads.append(r)
    for w in payload.writes:
        part(slot_fid(w.key[0])).writes.append(w)
    for pred in payload.predicates:
        part(slot_fid(pred.file_id)).predicates.append(pred)
    for fid, new_len in payload.meta_updates.items():
        part(slot_fid(fid)).meta_updates[fid] = new_len
    for fid, ver in payload.meta_reads.items():
        part(slot_fid(fid)).meta_reads[fid] = ver
    for path, fid in payload.name_updates.items():
        part(slot_of_name(path, n_slots, by_parent)).name_updates[path] = fid
    for path, ver in payload.name_reads.items():
        part(slot_of_name(path, n_slots, by_parent)).name_reads[path] = ver
    if not parts:  # effect-free non-read-only txn: pure validation
        parts[0] = TxnPayload(
            read_ts=payload.read_ts[0]
            if isinstance(payload.read_ts, tuple)
            else payload.read_ts,
            read_only=payload.read_only,
        )
    return parts


# --------------------------------------------------------------------------- #
# coordinator backend (hosted by CoordinatorServer)
# --------------------------------------------------------------------------- #
class CoordinatorBackend(BackendAPI):
    """The cluster's transaction coordinator and map authority, shaped
    as a ``BackendAPI`` so ``BackendServer`` machinery (event loop,
    worker pools, WAL, checkpointing, id leases) hosts it unchanged.
    Its own durable state is tiny: the map, unacked 2PC decisions, and
    any migration in flight."""

    #: how long a read-your-writes visibility wait may block (a crashed
    #: participant holds its floor until it recovers; commits already
    #: durably decided must not wedge the acking worker forever)
    VISIBILITY_WAIT_S = 5.0

    def __init__(
        self,
        shard_addrs: List[Tuple[str, int]],
        n_slots: Optional[int] = None,
        block_size: int = 4096,
        policy: CachePolicy = CachePolicy.INVALIDATE,
        name_by_parent: bool = False,
        admin_token: Optional[str] = None,
        connect_timeout_s: float = 30.0,
    ):
        if not shard_addrs:
            raise ValueError("a cluster needs at least one shard server")
        n = n_slots if n_slots is not None else len(shard_addrs)
        self._block_size = block_size
        self.policy = policy
        self.admin_token = admin_token
        self.connect_timeout_s = connect_timeout_s
        self.map = make_map(list(shard_addrs), n, name_by_parent)
        self._map_logged = False  # replay of a cmap record sets this
        self.wal = None
        self.txid_epoch = 0       # CoordinatorServer stamps its epoch
        # RLock'd condition: export_snapshot runs inside freeze(), which
        # already holds the lock
        self._mu = threading.Condition(threading.RLock())
        self._reported: List[Timestamp] = [0] * n
        self._floors: Dict[Tuple, Dict[int, Timestamp]] = {}
        self._inflight: Set[Tuple] = set()       # prepared, pre-decision
        self._decisions: Dict[Tuple, Set[int]] = {}  # txid -> unacked idxs
        self._mig_pending: Optional[Tuple] = None    # (slots, src, dst)
        self._mig_block: Set[int] = set()
        self._seq = 0
        self._gts = 0
        self._next_fid = 1
        self._links: Dict[int, RemoteBackend] = {}
        self._stop = threading.Event()
        self._pusher: Optional[threading.Thread] = None
        self.stats_local = {"fast": 0, "cross": 0, "aborts": 0, "ro": 0}

    # -- map-derived partitioning -------------------------------------- #
    @property
    def n_slots(self) -> int:
        return self.map["n_slots"]

    @property
    def n_shards(self) -> int:
        """Sync-vector width for the hello (== n_slots, never the
        process count: rebalancing must not change the wire contract)."""
        return self.n_slots

    @property
    def block_size(self) -> int:
        return self._block_size

    def slot_of_fid(self, fid: FileId) -> int:
        return fid % self.n_slots

    def slot_of_block(self, key: BlockKey) -> int:
        return self.slot_of_fid(key[0])

    def slot_of_name(self, path: str) -> int:
        return slot_of_name(
            path, self.n_slots, self.map["flags"]["name_by_parent"]
        )

    def _owner(self, slot: int) -> int:
        return self.map["slots"][slot]

    def _link(self, idx: int) -> RemoteBackend:
        link = self._links.get(idx)
        if link is None:
            host, port = self.map["addrs"][idx]
            link = RemoteBackend(
                host, port, connect_timeout_s=self.connect_timeout_s,
                admin_token=self.admin_token,
            )
            self._links[idx] = link
        return link

    # -- timestamp algebra (vector over n_slots) ----------------------- #
    @property
    def zero_ts(self) -> SyncVector:
        return (0,) * self.n_slots

    def ts_geq(self, a, b) -> bool:
        return all(x >= y for x, y in zip(a, b))

    def snapshot_cache_ok(self, key, version, at_ts, last_sync_ts) -> bool:
        s = self.slot_of_block(key)
        return version <= at_ts[s] and last_sync_ts[s] >= at_ts[s]

    def _effective_locked(self) -> List[Timestamp]:
        """Reported vector capped below every outstanding prepare: a
        begin must never hand out a snapshot covering a timestamp whose
        commit is not yet applied on its shard."""
        eff = list(self._reported)
        for ts_map in self._floors.values():
            for s, ts in ts_map.items():
                if ts - 1 < eff[s]:
                    eff[s] = ts - 1
        return eff

    @property
    def latest_ts(self) -> SyncVector:
        with self._mu:
            return tuple(self._effective_locked())

    # ------------------------------------------------------------------ #
    # reads: proxied per the map (direct-reading clients bypass this)
    # ------------------------------------------------------------------ #
    def begin(self, last_sync_ts, cached_keys: Optional[Set[BlockKey]] = None,
              policy: Optional[CachePolicy] = None) -> BeginReply:
        # effective vector FIRST: each later per-server scan then covers
        # at least up to every component it claims
        with self._mu:
            read_vec = tuple(self._effective_locked())
            slot_map = list(self.map["slots"])
        last = self._as_vector(last_sync_ts)
        keys_by_srv: Dict[int, Set[BlockKey]] = {}
        if cached_keys is not None:
            for k in cached_keys:
                idx = slot_map[self.slot_of_block(k)]
                keys_by_srv.setdefault(idx, set()).add(k)
        updates: Dict[BlockKey, Tuple[Timestamp, bytes]] = {}
        invals: List[BlockKey] = []
        file_invals: List[FileId] = []
        for idx in sorted(set(slot_map)):
            keys = None if cached_keys is None else keys_by_srv.get(idx, set())
            try:
                r = self._link(idx).begin(tuple(last), keys, policy)
            except StaleShardMap:
                # mid-rebalance: the slots this server lost contribute
                # nothing; their cached keys must be dropped
                if keys:
                    invals.extend(keys)
                continue
            updates.update(r.updates)
            invals.extend(r.invalidations)
            file_invals.extend(r.file_invalidations)
        return BeginReply(read_vec, updates, invals, file_invals)

    def _as_vector(self, ts) -> SyncVector:
        if isinstance(ts, int):
            return (ts,) * self.n_slots
        return tuple(ts)

    def fetch_blocks(self, keys, at_ts=None):
        by_srv: Dict[int, List[int]] = {}
        slot_map = self.map["slots"]
        for i, key in enumerate(keys):
            by_srv.setdefault(slot_map[self.slot_of_block(key)], []).append(i)
        out: List[Optional[Tuple[Timestamp, bytes]]] = [None] * len(keys)
        for idx, idxs in by_srv.items():
            got = self._link(idx).fetch_blocks([keys[i] for i in idxs], at_ts)
            for i, entry in zip(idxs, got):
                out[i] = entry
        return out  # type: ignore[return-value]

    def fetch_metas(self, fids, at_ts=None):
        by_srv: Dict[int, List[int]] = {}
        slot_map = self.map["slots"]
        for i, fid in enumerate(fids):
            by_srv.setdefault(slot_map[self.slot_of_fid(fid)], []).append(i)
        out: List[Optional[Tuple[Timestamp, Any]]] = [None] * len(fids)
        for idx, idxs in by_srv.items():
            got = self._link(idx).fetch_metas([fids[i] for i in idxs], at_ts)
            for i, entry in zip(idxs, got):
                out[i] = entry
        return out

    def lookup_many(self, paths, at_ts=None):
        by_srv: Dict[int, List[int]] = {}
        slot_map = self.map["slots"]
        for i, path in enumerate(paths):
            by_srv.setdefault(slot_map[self.slot_of_name(path)], []).append(i)
        out: List[Optional[Tuple[Timestamp, Optional[FileId]]]] = (
            [None] * len(paths)
        )
        for idx, idxs in by_srv.items():
            got = self._link(idx).lookup_many([paths[i] for i in idxs], at_ts)
            for i, entry in zip(idxs, got):
                out[i] = entry
        return out  # type: ignore[return-value]

    def sync_files(self, reqs):
        out: Dict[FileId, Dict[BlockKey, Tuple[Timestamp, bytes]]] = {}
        by_srv: Dict[int, Dict[FileId, Dict[BlockKey, Timestamp]]] = {}
        slot_map = self.map["slots"]
        for fid, known in reqs.items():
            by_srv.setdefault(
                slot_map[self.slot_of_fid(fid)], {}
            )[fid] = known
        for idx, sub in by_srv.items():
            out.update(self._link(idx).sync_files(sub))
        return out

    def listdir(self, prefix, at_ts=None):
        out: List[Tuple[str, Timestamp, Optional[FileId]]] = []
        for idx in sorted(set(self.map["slots"])):
            out.extend(self._link(idx).listdir(prefix, at_ts))
        return sorted(out)

    def alloc_file_id(self) -> FileId:
        with self._mu:
            fid = self._next_fid
            self._next_fid += 1
            return fid

    def bump_fid_floor(self, floor: FileId) -> None:
        with self._mu:
            if floor > self._next_fid:
                self._next_fid = floor

    def set_wal(self, wal) -> None:
        self.wal = wal

    @property
    def stats(self) -> BackendStats:
        agg = BackendStats()
        for idx in sorted(set(self.map["slots"])):
            try:
                s = self._link(idx).stats
            except OSError:
                continue
            for f in (
                "commits", "aborts", "begins", "blocks_pushed",
                "blocks_invalidated", "block_fetches", "bytes_pushed",
                "validation_checks", "group_batches", "group_committed",
            ):
                setattr(agg, f, getattr(agg, f) + getattr(s, f))
        agg.commits += self.stats_local["cross"]
        agg.aborts += self.stats_local["aborts"]
        return agg

    # ------------------------------------------------------------------ #
    # commit: single-server forward or cross-server 2PC
    # ------------------------------------------------------------------ #
    def commit(self, payload: TxnPayload) -> CommitReply:
        if payload.read_only and not payload.has_effects():
            with self._mu:
                self.stats_local["ro"] += 1
                return CommitReply(self._gts)
        # a migration can flip ownership between routing and prepare; the
        # participant's StaleShardMap then means "re-route", not "fail"
        for _ in range(4):
            try:
                return self._commit_once(payload)
            except StaleShardMap:
                continue
        return self._commit_once(payload)

    def _commit_once(self, payload: TxnPayload) -> CommitReply:
        by_parent = self.map["flags"]["name_by_parent"]
        parts = split_payload(payload, self.n_slots, by_parent)
        with self._mu:
            deadline = time.monotonic() + self.VISIBILITY_WAIT_S
            while self._mig_block & set(parts):
                if not self._mu.wait(timeout=0.1) and \
                        time.monotonic() > deadline:
                    raise StaleShardMap("slots blocked for migration")
            slot_map = list(self.map["slots"])
        by_srv: Dict[int, Dict[int, TxnPayload]] = {}
        for s, p in parts.items():
            by_srv.setdefault(slot_map[s], {})[s] = p
        if len(by_srv) == 1:
            ((idx, _),) = by_srv.items()
            reply = self._link(idx).commit(payload)
            with self._mu:
                self.stats_local["fast"] += 1
                self._gts += 1
                gts = self._gts
                for s, ts in reply.slot_ts.items():
                    if ts > self._reported[s]:
                        self._reported[s] = ts
                self._mu.notify_all()
                self._wait_visible_locked(reply.slot_ts)
            return CommitReply(gts, reply.block_versions,
                               slot_ts=dict(reply.slot_ts))
        return self._commit_2pc(payload, by_srv)

    def _wait_visible_locked(self, slot_ts: Dict[int, Timestamp]) -> None:
        """Read-your-writes: don't ack until the effective vector covers
        this commit on every touched slot (a concurrent 2PC's floor may
        briefly cap a slot below a timestamp that is already applied)."""
        if not slot_ts:
            return
        deadline = time.monotonic() + self.VISIBILITY_WAIT_S
        while True:
            eff = self._effective_locked()
            if all(eff[s] >= ts for s, ts in slot_ts.items()):
                return
            if time.monotonic() > deadline:
                return  # crashed participant: visibility follows recovery
            self._mu.wait(timeout=0.05)

    def _commit_2pc(self, payload: TxnPayload,
                    by_srv: Dict[int, Dict[int, TxnPayload]]) -> CommitReply:
        with self._mu:
            self._seq += 1
            txid = (self.txid_epoch, self._seq)
            self._inflight.add(txid)
        order = sorted(by_srv)
        prepared: List[int] = []
        ts_map: Dict[int, Timestamp] = {}
        try:
            # phase 1: sequential prepares in server order (two
            # coordinato r workers can't deadlock two servers), slot
            # locks held at each yes-voter until the decision
            for idx in order:
                obj = {
                    "txid": list(txid),
                    "parts": {
                        s: wire.payload_to_obj(p)
                        for s, p in by_srv[idx].items()
                    },
                }
                r = self._link(idx)._call(wire.T_PREPARE, obj)
                prepared.append(idx)
                for s, ts in r["ts"].items():
                    ts_map[int(s)] = ts
        except BaseException as e:
            # presumed abort: nothing logged anywhere for an abort — a
            # participant finding no decision later resolves to "a"
            for idx in prepared:
                try:
                    self._link(idx)._call(
                        wire.T_DECIDE, {"txid": list(txid), "c": False}
                    )
                except Exception:
                    pass  # its recovery resolver will learn "a"
            with self._mu:
                self._inflight.discard(txid)
                if isinstance(e, Conflict):
                    self.stats_local["aborts"] += 1
            raise

        # unanimous yes: floor the snapshot vector BEFORE the decision
        # exists, so no begin can run ahead of an applying commit
        with self._mu:
            self._floors[txid] = dict(ts_map)
        obs.crash_point("pre-decide")
        if self.wal is not None:
            lsn = self.wal.append(("xdec", list(txid), order))
            self.wal.sync(lsn)
        _XDECS.inc()
        obs.crash_point("dec-logged")
        with self._mu:
            self._decisions[txid] = set(order)
            self._inflight.discard(txid)

        # phase 2: push the decision; a participant that died after
        # voting applies it at recovery instead (resolver / pusher) —
        # the commit is acked regardless, its outcome is already durable
        for idx in order:
            try:
                self._link(idx)._call(
                    wire.T_DECIDE, {"txid": list(txid), "c": True}
                )
            except Exception:
                continue  # decision stays unacked; the pusher retries
            self._ack_decision(txid, idx, by_srv[idx], ts_map)

        with self._mu:
            if txid not in self._decisions:
                # fully acked: _ack_decision removed the floor atomically
                # with the last ack; a partially-acked txn keeps its floor
                # (all slots) until the pusher lands the stragglers
                self._floors.pop(txid, None)
            self._gts += 1
            gts = self._gts
            self.stats_local["cross"] += 1
            self._mu.notify_all()
            self._wait_visible_locked(
                {s: ts_map[s] for idx in order for s in by_srv[idx]
                 if s in ts_map}
            )
        block_versions = {
            w.key: ts_map[self.slot_of_block(w.key)]
            for w in payload.writes
            if self.slot_of_block(w.key) in ts_map
        }
        return CommitReply(gts, block_versions, slot_ts=dict(ts_map))

    def _ack_decision(self, txid: Tuple, idx: int,
                      parts: Dict[int, TxnPayload],
                      ts_map: Dict[int, Timestamp]) -> None:
        with self._mu:
            for s in parts:
                ts = ts_map.get(s)
                if ts is not None:
                    if ts > self._reported[s]:
                        self._reported[s] = ts
            # the floor must keep capping EVERY slot of this txn until the
            # last participant acks: releasing slots one ack at a time
            # would let a begin observe the commit applied on one server
            # but not the other — a torn (non-serializable) read vector
            unacked = self._decisions.get(txid)
            if unacked is not None:
                unacked.discard(idx)
                if not unacked:
                    self._decisions.pop(txid, None)
                    self._floors.pop(txid, None)
            self._mu.notify_all()

    # ------------------------------------------------------------------ #
    # termination protocol + decision pushing
    # ------------------------------------------------------------------ #
    def resolve(self, txid: Tuple) -> Dict[str, str]:
        """Answer a recovered participant: committed / aborted / still
        deciding. Presumed abort: no logged decision and not in flight
        means no commit was ever decided."""
        txid = tuple(txid)
        with self._mu:
            if txid in self._decisions:
                return {"d": "c"}
            if txid in self._inflight:
                return {"d": "pending"}
        return {"d": "a"}

    def _push_decisions(self) -> None:
        with self._mu:
            work = [(t, sorted(idxs)) for t, idxs in self._decisions.items()]
        for txid, idxs in work:
            for idx in idxs:
                try:
                    r = self._link(idx)._call(
                        wire.T_DECIDE, {"txid": list(txid), "c": True}
                    )
                except Exception:
                    continue
                ts_map = {int(s): ts for s, ts in (r.get("ts") or {}).items()}
                with self._mu:
                    for s, ts in ts_map.items():
                        if ts > self._reported[s]:
                            self._reported[s] = ts
                    # as in _ack_decision: the floor releases all-or-
                    # nothing when the last participant acks
                    unacked = self._decisions.get(txid)
                    if unacked is not None:
                        unacked.discard(idx)
                        if not unacked:
                            self._decisions.pop(txid, None)
                            self._floors.pop(txid, None)
                    self._mu.notify_all()

    def _pusher_loop(self) -> None:
        while not self._stop.wait(0.25):
            try:
                with self._mu:
                    idle = not self._decisions
                if not idle:
                    self._push_decisions()
            except Exception:
                pass

    # ------------------------------------------------------------------ #
    # startup: connect, learn applied vectors, settle in-doubt txns,
    # finish (or roll back) an interrupted migration
    # ------------------------------------------------------------------ #
    def startup(self) -> None:
        deadline = time.monotonic() + self.connect_timeout_s
        statuses: Dict[int, Dict] = {}
        for idx in sorted(set(self.map["slots"])):
            while True:
                try:
                    statuses[idx] = self._link(idx)._call(
                        wire.T_SHARD_STATUS, {"digests": False}
                    )
                    break
                except (OSError, wire.WireError):
                    self._links.pop(idx, None)
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
        with self._mu:
            for st in statuses.values():
                for s, ts in st["applied"].items():
                    s = int(s)
                    if ts > self._reported[s]:
                        self._reported[s] = ts

        # settle reported in-doubt txns: logged decision -> commit will
        # be (re)pushed below; unknown -> presumed abort, push it now
        in_doubt: Set[Tuple] = set()
        for st in statuses.values():
            in_doubt.update(tuple(t) for t in st.get("in_doubt", ()))
        with self._mu:
            aborts = [t for t in in_doubt if t not in self._decisions]
        for txid in aborts:
            for idx in statuses:
                try:
                    self._link(idx)._call(
                        wire.T_DECIDE, {"txid": list(txid), "c": False}
                    )
                except Exception:
                    pass

        self._finish_migration(statuses)

        # drop sweep: a slot the map no longer assigns to a server must
        # not linger there (a crash between cmap and the drop ack); a
        # frozen slot the map STILL assigns there is an interrupted
        # rollback — unfreeze it
        for idx, st in statuses.items():
            held = {int(s) for s in st["slots"]}
            held.update(int(s) for s in st.get("frozen", ()))
            stray = sorted(
                s for s in held if self.map["slots"][s] != idx
            )
            thawable = sorted(
                int(s) for s in st.get("frozen", ())
                if self.map["slots"][int(s)] == idx
            )
            if stray:
                try:
                    self._link(idx)._call(
                        wire.T_MIG_DROP, {"slots": stray}
                    )
                except Exception:
                    pass
            if thawable:
                try:
                    self._link(idx)._call(
                        wire.T_MIG_ABORT, {"slots": thawable}
                    )
                except Exception:
                    pass

        self._push_decisions()
        if not self._map_logged and self.wal is not None:
            lsn = self.wal.append(("cmap", self.map))
            self.wal.sync(lsn)
            self._map_logged = True
        if self._pusher is None:
            t = threading.Thread(
                target=self._pusher_loop, name="faasfs-coord-push",
                daemon=True,
            )
            t.start()
            self._pusher = t

    def _finish_migration(self, statuses: Dict[int, Dict]) -> None:
        """Roll an interrupted rebalance forward iff the target durably
        imported the slots (its WAL has the ``mig-in``), else back."""
        pend = self._mig_pending
        if pend is None:
            return
        slots, src, dst = pend
        slots = [int(s) for s in slots]
        dst_st = statuses.get(dst)
        if dst_st is None:
            try:
                dst_st = self._link(dst)._call(
                    wire.T_SHARD_STATUS, {"digests": False}
                )
            except Exception:
                dst_st = {"slots": []}
        owned = {int(s) for s in dst_st["slots"]}
        if all(s in owned for s in slots):
            # roll forward: the import is durable — publish the map
            new_map = {
                **self.map,
                "v": self.map["v"] + 1,
                "slots": list(self.map["slots"]),
            }
            for s in slots:
                new_map["slots"][s] = dst
            if self.wal is not None:
                lsn = self.wal.append(("cmap", new_map))
                self.wal.sync(lsn)
            with self._mu:
                self.map = new_map
                self._map_logged = True
            try:
                self._link(src)._call(wire.T_MIG_DROP, {"slots": slots})
            except Exception:
                pass  # covered by the next startup's drop sweep
        else:
            # roll back: unfreeze the source, scrub any partial import
            try:
                self._link(src)._call(wire.T_MIG_ABORT, {"slots": slots})
            except Exception:
                pass
            try:
                self._link(dst)._call(wire.T_MIG_DROP, {"slots": slots})
            except Exception:
                pass
        self._mig_pending = None

    # ------------------------------------------------------------------ #
    # live rebalancing
    # ------------------------------------------------------------------ #
    def rebalance(self, slots: List[int], to_idx: int) -> Dict[str, Any]:
        slots = sorted(set(int(s) for s in slots))
        if not 0 <= to_idx < len(self.map["addrs"]):
            raise ValueError(f"no shard server #{to_idx}")
        if any(s < 0 or s >= self.n_slots for s in slots):
            raise ValueError(f"slots {slots} out of range")
        with self._mu:
            srcs: Dict[int, List[int]] = {}
            for s in slots:
                cur = self.map["slots"][s]
                if cur != to_idx:
                    srcs.setdefault(cur, []).append(s)
            if not srcs:
                return {"v": self.map["v"], "map": self.map}
            moving = [s for group in srcs.values() for s in group]
            self._mig_block.update(moving)
        try:
            for src, group in sorted(srcs.items()):
                if self.wal is not None:
                    lsn = self.wal.append(("mig-start", group, src, to_idx))
                    self.wal.sync(lsn)
                self._mig_pending = (group, src, to_idx)
                try:
                    states = self._link(src)._call(
                        wire.T_MIG_EXPORT, {"slots": group}
                    )["states"]
                    self._link(to_idx)._call(
                        wire.T_MIG_IMPORT, {"states": states}
                    )
                except BaseException:
                    # roll back. Order matters: durably CANCEL the
                    # mig-start marker (re-log the unchanged map) BEFORE
                    # unfreezing the source — the target may have durably
                    # imported before dying, and a coordinator restart
                    # must not roll forward onto a copy that went stale
                    # the moment the source resumed taking writes
                    if self.wal is not None:
                        lsn = self.wal.append(("cmap", self.map))
                        self.wal.sync(lsn)
                    self._mig_pending = None
                    try:
                        self._link(src)._call(
                            wire.T_MIG_ABORT, {"slots": group}
                        )
                    except Exception:
                        pass  # the startup sweep also unfreezes
                    try:  # scrub any partial import off the target
                        self._link(to_idx)._call(
                            wire.T_MIG_DROP, {"slots": group}
                        )
                    except Exception:
                        pass  # the startup sweep also drops strays
                    raise
                with self._mu:
                    new_map = {
                        **self.map,
                        "v": self.map["v"] + 1,
                        "slots": list(self.map["slots"]),
                    }
                    for s in group:
                        new_map["slots"][s] = to_idx
                if self.wal is not None:
                    lsn = self.wal.append(("cmap", new_map))
                    self.wal.sync(lsn)
                obs.crash_point("mig-mapped")
                with self._mu:
                    self.map = new_map
                    self._map_logged = True
                    self._mig_pending = None
                    self._mu.notify_all()
                _MIGRATIONS.inc()
                try:
                    self._link(src)._call(
                        wire.T_MIG_DROP, {"slots": group}
                    )
                except Exception:
                    pass  # idempotent; the startup sweep re-sends it
        finally:
            with self._mu:
                self._mig_block.difference_update(slots)
                self._mu.notify_all()
        return {"v": self.map["v"], "map": self.map}

    # ------------------------------------------------------------------ #
    # durability plumbing (WAL replay + checkpoint snapshot)
    # ------------------------------------------------------------------ #
    def replay_record(self, rec) -> None:
        kind = rec[0]
        if kind == "cmap":
            self.map = rec[1]
            self._map_logged = True
            n = self.map["n_slots"]
            if len(self._reported) != n:
                self._reported = [0] * n
            self._mig_pending = None
            return
        if kind == "xdec":
            txid = tuple(rec[1])
            self._decisions[txid] = set(rec[2])
            if txid[0] == self.txid_epoch and txid[1] > self._seq:
                self._seq = txid[1]
            return
        if kind == "mig-start":
            self._mig_pending = (list(rec[1]), rec[2], rec[3])
            return
        raise ValueError(f"unknown WAL record kind {kind!r}")

    @contextmanager
    def freeze(self):
        with self._mu:
            yield

    def export_snapshot(self) -> Dict:
        with self._mu:
            return {
                "kind": "coordinator",
                "n": self.n_slots,
                "map": self.map,
                "decisions": [
                    [list(t), sorted(idxs)]
                    for t, idxs in sorted(self._decisions.items())
                ],
                "seq": self._seq,
                "next_fid": self._next_fid,
            }

    def import_snapshot(self, snap: Dict) -> None:
        if snap.get("kind") != "coordinator":
            raise ValueError(f"snapshot kind={snap.get('kind')!r} is not "
                             "a coordinator checkpoint")
        with self._mu:
            self.map = snap["map"]
            self._map_logged = True
            n = self.map["n_slots"]
            if len(self._reported) != n:
                self._reported = [0] * n
            for t, idxs in snap["decisions"]:
                self._decisions[tuple(t)] = set(idxs)
            if snap["seq"] > self._seq:
                self._seq = snap["seq"]
            if snap["next_fid"] > self._next_fid:
                self._next_fid = snap["next_fid"]

    def close(self) -> None:
        self._stop.set()
        for link in self._links.values():
            try:
                link.close()
            except Exception:
                pass
        self._links.clear()


# --------------------------------------------------------------------------- #
# coordinator server process
# --------------------------------------------------------------------------- #
class CoordinatorServer(BackendServer):
    """``BackendServer`` hosting a ``CoordinatorBackend``: same event
    loop, worker pools, segmented WAL, checkpoint trigger and id leases —
    plus the map in the hello, the map version on every reply frame, and
    the cluster-control verbs."""

    def __init__(self, backend: CoordinatorBackend, **kw):
        kw.setdefault("admin_token", backend.admin_token)
        super().__init__(backend, **kw)
        backend.txid_epoch = self.epoch

    def start(self) -> "CoordinatorServer":
        # connect + settle BEFORE serving: a client must never observe a
        # coordinator whose in-doubt txns and map are still unsettled
        self.backend.startup()
        super().start()
        return self

    def shutdown(self, drain: bool = False,
                 drain_timeout_s: float = 10.0) -> None:
        super().shutdown(drain=drain, drain_timeout_s=drain_timeout_s)
        self.backend.close()

    def _hello(self) -> Dict[str, Any]:
        h = super()._hello()
        h["map"] = self.backend.map
        return h

    def reply_mapv(self) -> Optional[int]:
        return self.backend.map["v"]

    def _dispatch(self, msg_type: int, obj: Any) -> Any:
        be = self.backend
        if msg_type == wire.T_SHARDMAP:
            return {"map": be.map}
        if msg_type == wire.T_RESOLVE:
            return be.resolve(tuple(obj["txid"]))
        if msg_type == wire.T_REBALANCE:
            return be.rebalance(
                [int(s) for s in obj["slots"]], int(obj["to"])
            )
        return super()._dispatch(msg_type, obj)


# --------------------------------------------------------------------------- #
# cluster-aware client: coordinator for txns, direct shard links for reads
# --------------------------------------------------------------------------- #
class ClusterBackend(BackendAPI):
    """Client transport for a shard cluster. Transactions (begin /
    commit / leases) go through the coordinator; reads route DIRECTLY to
    the owning shard server per the cached ``ShardMap``. A read landing
    on a server that no longer owns the slot gets ``StaleShardMap``: the
    client refetches the map from the coordinator and retries — the
    rebalance is invisible to callers. The map version advertised on
    coordinator reply frames triggers the same refresh passively."""

    MAX_RETRIES = 6

    def __init__(self, host: str, port: int, lease_size: int = 64,
                 admin_token: Optional[str] = None,
                 connect_timeout_s: float = 10.0):
        self.coord = RemoteBackend(
            host, port, lease_size=lease_size,
            connect_timeout_s=connect_timeout_s,
            admin_token=admin_token,
        )
        self._admin_token = admin_token
        self._connect_timeout_s = connect_timeout_s
        self._mu = threading.Lock()
        self._links: Dict[Tuple[str, int], RemoteBackend] = {}
        m = (self.coord._hello or {}).get("map")
        if m is None:
            m = self.coord._call(wire.T_SHARDMAP, None)["map"]
        self._map: Dict[str, Any] = m
        self.map_refreshes = 0

    # -- map handling --------------------------------------------------- #
    @property
    def shard_map(self) -> Dict[str, Any]:
        return self._map

    def _refresh_map(self) -> None:
        self._map = self.coord._call(wire.T_SHARDMAP, None)["map"]
        self.map_refreshes += 1

    def _maybe_refresh(self) -> None:
        v = self.coord.mapv_seen()
        if v is not None and v > self._map["v"]:
            self._refresh_map()

    def _link_for_slot(self, slot: int) -> RemoteBackend:
        host, port = self._map["addrs"][self._map["slots"][slot]]
        return self._link((host, port))

    def _link(self, addr: Tuple[str, int]) -> RemoteBackend:
        with self._mu:
            link = self._links.get(addr)
            if link is None:
                link = RemoteBackend(
                    addr[0], addr[1],
                    connect_timeout_s=self._connect_timeout_s,
                    admin_token=self._admin_token,
                )
                self._links[addr] = link
            return link

    def _retry(self, fn):
        """Run ``fn`` (which routes via the current map), refreshing the
        map and retrying on ``StaleShardMap`` — and on a dead shard link
        (its slots may have moved, taking the address out of the map)."""
        self._maybe_refresh()
        last: Optional[BaseException] = None
        for attempt in range(self.MAX_RETRIES):
            try:
                return fn()
            except StaleShardMap as e:
                last = e
            except wire.ConnectionClosed as e:
                last = e
            time.sleep(0 if attempt == 0 else 0.05 * attempt)
            self._refresh_map()
        raise last  # type: ignore[misc]

    # -- partitioning (mirrors the map, including the name flag) -------- #
    def slot_of_fid(self, fid: FileId) -> int:
        return fid % self._map["n_slots"]

    def slot_of_block(self, key: BlockKey) -> int:
        return self.slot_of_fid(key[0])

    def slot_of_name(self, path: str) -> int:
        return slot_of_name(
            path, self._map["n_slots"],
            self._map["flags"]["name_by_parent"],
        )

    # -- handshake-derived + algebra (delegate to the coordinator) ------ #
    @property
    def block_size(self) -> int:
        return self.coord.block_size

    @property
    def policy(self) -> CachePolicy:
        return self.coord.policy

    @property
    def n_shards(self) -> int:
        return self.coord.n_shards

    @property
    def zero_ts(self):
        return self.coord.zero_ts

    def ts_geq(self, a, b) -> bool:
        return self.coord.ts_geq(a, b)

    def snapshot_cache_ok(self, key, version, at_ts, last_sync_ts) -> bool:
        return self.coord.snapshot_cache_ok(key, version, at_ts, last_sync_ts)

    # -- coordinator-routed ops ----------------------------------------- #
    def begin(self, last_sync_ts, cached_keys=None, policy=None):
        return self.coord.begin(last_sync_ts, cached_keys, policy)

    def commit(self, payload) -> CommitReply:
        return self.coord.commit(payload)

    def alloc_file_id(self) -> FileId:
        return self.coord.alloc_file_id()

    @property
    def stats(self):
        return self.coord.stats

    @property
    def latest_ts(self):
        return self.coord.latest_ts

    def ping(self) -> None:
        self.coord.ping()

    def checkpoint(self) -> Dict[str, int]:
        return self.coord.checkpoint()

    def rebalance(self, slots: List[int], to_idx: int) -> Dict[str, Any]:
        out = self.coord._call(
            wire.T_REBALANCE, {"slots": list(slots), "to": to_idx}
        )
        self._map = out["map"]
        return out

    # -- direct-to-shard reads ------------------------------------------ #
    def fetch_blocks(self, keys, at_ts=None):
        def run():
            by_link: Dict[RemoteBackend, List[int]] = {}
            for i, key in enumerate(keys):
                by_link.setdefault(
                    self._link_for_slot(self.slot_of_block(key)), []
                ).append(i)
            out = [None] * len(keys)
            for link, idxs in by_link.items():
                got = link.fetch_blocks([keys[i] for i in idxs], at_ts)
                for i, entry in zip(idxs, got):
                    out[i] = entry
            return out
        return self._retry(run)

    def fetch_metas(self, fids, at_ts=None):
        def run():
            by_link: Dict[RemoteBackend, List[int]] = {}
            for i, fid in enumerate(fids):
                by_link.setdefault(
                    self._link_for_slot(self.slot_of_fid(fid)), []
                ).append(i)
            out = [None] * len(fids)
            for link, idxs in by_link.items():
                got = link.fetch_metas([fids[i] for i in idxs], at_ts)
                for i, entry in zip(idxs, got):
                    out[i] = entry
            return out
        return self._retry(run)

    def lookup_many(self, paths, at_ts=None):
        def run():
            by_link: Dict[RemoteBackend, List[int]] = {}
            for i, path in enumerate(paths):
                by_link.setdefault(
                    self._link_for_slot(self.slot_of_name(path)), []
                ).append(i)
            out = [None] * len(paths)
            for link, idxs in by_link.items():
                got = link.lookup_many([paths[i] for i in idxs], at_ts)
                for i, entry in zip(idxs, got):
                    out[i] = entry
            return out
        return self._retry(run)

    def sync_files(self, reqs):
        def run():
            out: Dict[FileId, Dict] = {}
            by_link: Dict[RemoteBackend, Dict] = {}
            for fid, known in reqs.items():
                by_link.setdefault(
                    self._link_for_slot(self.slot_of_fid(fid)), {}
                )[fid] = known
            for link, sub in by_link.items():
                out.update(link.sync_files(sub))
            return out
        return self._retry(run)

    def listdir(self, prefix, at_ts=None):
        def run():
            out: List = []
            for addr_idx in sorted(set(self._map["slots"])):
                host, port = self._map["addrs"][addr_idx]
                out.extend(self._link((host, port)).listdir(prefix, at_ts))
            return sorted(out)
        return self._retry(run)

    def close(self) -> None:
        with self._mu:
            links, self._links = list(self._links.values()), {}
        for link in links:
            try:
                link.close()
            except Exception:
                pass
        self.coord.close()


# --------------------------------------------------------------------------- #
# subprocess harness (tests + benchmarks)
# --------------------------------------------------------------------------- #
class ClusterHarness:
    """Spawn a real cluster — N shard server processes + a coordinator
    process, each with its own WAL directory — and hand out cluster
    clients. Restart methods reuse each process's port so the ShardMap
    stays valid across crash/recovery tests."""

    def __init__(
        self,
        root: str,
        n_servers: int = 2,
        n_slots: Optional[int] = None,
        block_size: int = 4096,
        policy: str = "invalidate",
        admin_token: Optional[str] = "cluster-secret",
        name_by_parent: bool = False,
        commit_service_s: float = 0.0,
        checkpoint_records: Optional[int] = None,
        startup_timeout_s: float = 30.0,
    ):
        self.root = root
        self.n_servers = n_servers
        self.n_slots = n_slots if n_slots is not None else n_servers
        self.block_size = block_size
        self.policy = policy
        self.admin_token = admin_token
        self.name_by_parent = name_by_parent
        self.commit_service_s = commit_service_s
        self.checkpoint_records = checkpoint_records
        self.startup_timeout_s = startup_timeout_s
        self.shard_procs: List[Optional[subprocess.Popen]] = []
        self.shard_ports: List[int] = []
        self.coord_proc: Optional[subprocess.Popen] = None
        self.coord_port: int = 0
        self._env = dict(os.environ)
        src = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))), "src"
        )
        self._env["PYTHONPATH"] = src + os.pathsep + \
            self._env.get("PYTHONPATH", "")

    # -- process plumbing ----------------------------------------------- #
    def _launch(self, argv: List[str]) -> subprocess.Popen:
        return subprocess.Popen(
            [sys.executable, "-u", "-m"] + argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            env=self._env,
            text=True,
        )

    @staticmethod
    def _await_port(proc: subprocess.Popen) -> int:
        line = proc.stdout.readline()
        if not line.startswith("LISTENING"):
            proc.kill()
            raise RuntimeError(f"server failed to start: {line!r}")
        return int(line.split()[1])

    def _spawn(self, argv: List[str]) -> Tuple[subprocess.Popen, int]:
        proc = self._launch(argv)
        return proc, self._await_port(proc)

    def _slots_of(self, i: int) -> str:
        return ",".join(
            str(s) for s in range(self.n_slots) if s % self.n_servers == i
        )

    def _shard_argv(self, i: int, port: int,
                    crash_at: Optional[str] = None) -> List[str]:
        argv = [
            "repro_torch.core.server",
            "--port", str(port),
            "--wal", os.path.join(self.root, f"shard-{i}"),
            "--slots", self._slots_of(i),
            "--n-slots", str(self.n_slots),
            "--block-size", str(self.block_size),
            "--policy", self.policy,
            "--log-level", "off",
        ]
        if self.admin_token:
            argv += ["--admin-token", self.admin_token]
        if self.name_by_parent:
            argv += ["--name-by-parent"]
        if self.commit_service_s:
            argv += ["--commit-service", str(self.commit_service_s)]
        if self.checkpoint_records is not None:
            argv += ["--checkpoint-records", str(self.checkpoint_records)]
        if self.coord_port:
            argv += ["--coordinator", f"127.0.0.1:{self.coord_port}"]
        if crash_at:
            argv += ["--crash-at", crash_at]
        return argv

    def _coord_argv(self, port: int,
                    crash_at: Optional[str] = None) -> List[str]:
        argv = [
            "repro_torch.core.cluster",
            "--port", str(port),
            "--wal", os.path.join(self.root, "coord"),
            "--n-slots", str(self.n_slots),
            "--block-size", str(self.block_size),
            "--policy", self.policy,
            "--log-level", "off",
        ]
        for p in self.shard_ports:
            argv += ["--shard", f"127.0.0.1:{p}"]
        if self.admin_token:
            argv += ["--admin-token", self.admin_token]
        if self.name_by_parent:
            argv += ["--name-by-parent"]
        if crash_at:
            argv += ["--crash-at", crash_at]
        return argv

    # -- lifecycle ------------------------------------------------------- #
    def start(self) -> "ClusterHarness":
        # launch every shard process first, THEN collect their ports:
        # interpreter startup overlaps instead of serializing
        self.shard_procs = [
            self._launch(self._shard_argv(i, 0))
            for i in range(self.n_servers)
        ]
        self.shard_ports = [self._await_port(p) for p in self.shard_procs]
        self.coord_proc, self.coord_port = self._spawn(self._coord_argv(0))
        return self

    def client(self, admin: bool = True) -> ClusterBackend:
        return ClusterBackend(
            "127.0.0.1", self.coord_port,
            admin_token=self.admin_token if admin else None,
        )

    def kill_shard(self, i: int) -> None:
        proc = self.shard_procs[i]
        if proc is not None and proc.poll() is None:
            proc.kill()
        if proc is not None:
            proc.wait(timeout=10)
        self.shard_procs[i] = None

    def restart_shard(self, i: int,
                      crash_at: Optional[str] = None) -> None:
        self.kill_shard(i)
        proc, port = self._spawn(
            self._shard_argv(i, self.shard_ports[i], crash_at=crash_at)
        )
        self.shard_procs[i] = proc
        assert port == self.shard_ports[i]

    def wait_shard_dead(self, i: int, timeout_s: float = 15.0) -> None:
        proc = self.shard_procs[i]
        if proc is not None:
            proc.wait(timeout=timeout_s)

    def kill_coordinator(self) -> None:
        if self.coord_proc is not None and self.coord_proc.poll() is None:
            self.coord_proc.kill()
        if self.coord_proc is not None:
            self.coord_proc.wait(timeout=10)
        self.coord_proc = None

    def restart_coordinator(self, crash_at: Optional[str] = None) -> None:
        self.kill_coordinator()
        proc, port = self._spawn(
            self._coord_argv(self.coord_port, crash_at=crash_at)
        )
        self.coord_proc = proc
        assert port == self.coord_port

    def wait_coordinator_dead(self, timeout_s: float = 15.0) -> None:
        if self.coord_proc is not None:
            self.coord_proc.wait(timeout=timeout_s)

    def stop(self) -> None:
        procs = [p for p in self.shard_procs if p is not None]
        if self.coord_proc is not None:
            procs.append(self.coord_proc)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 10
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        self.shard_procs = []
        self.coord_proc = None


# --------------------------------------------------------------------------- #
# standalone entry point
# --------------------------------------------------------------------------- #
def main(argv=None) -> None:
    from repro_torch.core import wal as walmod

    p = argparse.ArgumentParser(description="FaaSFS cluster coordinator")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--wal", default=None,
                   help="coordinator durable log directory")
    p.add_argument("--sync-mode", default="fsync", choices=walmod.SYNC_MODES)
    p.add_argument("--shard", action="append", default=[],
                   metavar="HOST:PORT",
                   help="shard server address (repeat per server)")
    p.add_argument("--n-slots", type=int, default=None,
                   help="total slots (default: number of --shard servers)")
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--policy", default="invalidate")
    p.add_argument("--admin-token", default=None)
    p.add_argument("--name-by-parent", action="store_true")
    p.add_argument("--checkpoint-bytes", type=int, default=None)
    p.add_argument("--checkpoint-records", type=int, default=None)
    p.add_argument("--checkpoint-interval", type=float, default=0.25)
    p.add_argument("--max-inflight", type=int, default=64)
    p.add_argument("--log-level", default="info",
                   choices=("debug", "info", "warn", "error", "off"))
    p.add_argument("--crash-at", default=None)
    args = p.parse_args(argv)

    obs.LOG.set_level(args.log_level)
    if args.crash_at:
        obs.CRASH_POINTS.add(args.crash_at)
    addrs = []
    for spec in args.shard:
        host, _, port = spec.rpartition(":")
        addrs.append((host, int(port)))
    backend = CoordinatorBackend(
        addrs,
        n_slots=args.n_slots,
        block_size=args.block_size,
        policy=CachePolicy(args.policy),
        name_by_parent=args.name_by_parent,
        admin_token=args.admin_token,
    )
    server = CoordinatorServer(
        backend, host=args.host, port=args.port,
        wal_path=args.wal, sync_mode=args.sync_mode,
        max_inflight_per_conn=args.max_inflight,
        checkpoint_bytes=args.checkpoint_bytes,
        checkpoint_records=args.checkpoint_records,
        checkpoint_interval_s=args.checkpoint_interval,
    )

    def _graceful(signum, frame):  # noqa: ARG001 - signal handler shape
        server._stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    server.start()
    recovered = (server.recovery or {}).get("commits", 0)
    print(f"LISTENING {server.port} epoch={server.epoch} "
          f"recovered={recovered} mapv={backend.map['v']}", flush=True)
    server._stop.wait()
    server.shutdown(drain=True)
    print("SHUTDOWN clean", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
