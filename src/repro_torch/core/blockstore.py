"""Multiversioned block store + undo log (the backend's storage engine).

Each block carries a bounded version chain ``[(commit_ts, bytes), ...]``
(newest last). The newest entry is the current state; older entries are the
undo log that serves snapshot reads at a historical read timestamp — the
paper's mechanism for letting intermittently-connected clients with stale
caches keep making progress (FaaSFS §4.2: "uses the Undo Log to retrieve an
older version of the block").

File metadata (length, existence) is versioned the same way, because POSIX
makes every read implicitly a predicate on the file length.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.types import BlockKey, FileId, NotFound, Timestamp


class SnapshotTooOld(Exception):
    """The requested version was garbage-collected from the undo log."""


@dataclass
class Versioned:
    """A bounded version chain; newest last."""

    versions: List[Tuple[Timestamp, object]] = field(default_factory=list)
    truncated: bool = False  # True once GC dropped old entries

    def current(self) -> Tuple[Timestamp, object]:
        return self.versions[-1]

    def at(self, ts: Timestamp) -> Optional[Tuple[Timestamp, object]]:
        """Latest version with commit_ts <= ts (snapshot read).

        Raises SnapshotTooOld when the needed undo entry was GC'd — never
        silently serves wrong data. A chain whose oldest entry postdates
        ``ts`` WITHOUT truncation simply didn't exist at the snapshot
        (returns None).
        """
        for cts, val in reversed(self.versions):
            if cts <= ts:
                return cts, val
        if self.versions and self.truncated:
            raise SnapshotTooOld(
                f"oldest retained version {self.versions[0][0]} > snapshot {ts}"
            )
        return None

    def put(self, ts: Timestamp, value: object, keep: int) -> None:
        self.versions.append((ts, value))
        if len(self.versions) > keep:
            del self.versions[: len(self.versions) - keep]
            self.truncated = True

    def pop(self, ts: Timestamp) -> None:
        """Undo: drop the newest entry iff it carries ``ts`` (2PC rollback).

        Entries GC'd by ``put`` are not restored; the chain stays marked
        truncated, so affected snapshots raise SnapshotTooOld rather than
        serving wrong data.
        """
        if self.versions and self.versions[-1][0] == ts:
            self.versions.pop()


@dataclass
class FileMeta:
    """Versioned inode: length + existence drive OCC validation; ``kind``
    and ``mtime_ts`` make stat honest.

    ``kind`` is ``"f"`` (regular file) or ``"d"`` (directory) and is
    immutable per file id (recreation allocates a new id), so it may be
    read without recording an OCC meta read. ``mtime_ts`` is the commit
    timestamp of the last data modification; in-place block writes
    advance it *without* creating a new meta version (``touch_meta``), so
    they conflict with nobody — the meta version timestamp itself serves
    as the POSIX ctime (last inode change)."""

    length: int
    exists: bool = True
    kind: str = "f"
    mtime_ts: Timestamp = 0


class BlockStore:
    """In-memory versioned store: blocks + file metadata + namespace.

    Thread-safe for concurrent readers; writers (commit apply) must hold the
    backend's commit lock — this class only guards its own maps.
    """

    def __init__(self, block_size: int, versions_kept: int = 16):
        self.block_size = block_size
        self.versions_kept = versions_kept
        self._blocks: Dict[BlockKey, Versioned] = {}
        self._meta: Dict[FileId, Versioned] = {}
        self._names: Dict[str, Versioned] = {}  # path -> file_id (or None)
        self._lock = threading.RLock()
        self._next_file_id = 1

    # ------------------------------------------------------------------ #
    # namespace
    # ------------------------------------------------------------------ #
    def alloc_file_id(self) -> FileId:
        with self._lock:
            fid = self._next_file_id
            self._next_file_id += 1
            return fid

    def ensure_fid_floor(self, floor: FileId) -> None:
        """Raise the allocator so no id below ``floor`` is ever issued
        (crash recovery replays may have materialized such ids)."""
        with self._lock:
            if floor > self._next_file_id:
                self._next_file_id = floor

    def bind_name(self, path: str, fid: Optional[FileId], ts: Timestamp) -> None:
        with self._lock:
            v = self._names.setdefault(path, Versioned())
            v.put(ts, fid, self.versions_kept)

    def lookup(self, path: str, ts: Optional[Timestamp] = None) -> Optional[FileId]:
        with self._lock:
            v = self._names.get(path)
            if v is None or not v.versions:
                return None
            ent = v.at(ts) if ts is not None else v.current()
            return None if ent is None else ent[1]  # type: ignore[return-value]

    def name_version(self, path: str) -> Timestamp:
        with self._lock:
            v = self._names.get(path)
            return v.current()[0] if v and v.versions else 0

    def lookup_versioned(
        self, path: str, ts: Optional[Timestamp] = None
    ) -> Tuple[Timestamp, Optional[FileId]]:
        """(name_version, file_id) read atomically under one lock hold, so
        OCC name validation can't race a concurrent bind between the fid
        read and the version read."""
        with self._lock:
            v = self._names.get(path)
            if v is None or not v.versions:
                return 0, None
            if ts is not None:
                ent = v.at(ts)
                return (0, None) if ent is None else (ent[0], ent[1])  # type: ignore
            cts, fid = v.current()
            return cts, fid  # type: ignore[return-value]

    def dir_entries(
        self, prefix: str, ts: Optional[Timestamp] = None
    ) -> List[Tuple[str, Timestamp, Optional[FileId]]]:
        """Direct children of ``prefix`` as (full_path, name_version, fid).

        Unbound entries (fid None — unlink tombstones) are included so a
        transaction can record their observed versions: a later re-bind of
        an observed-absent name then fails validation.
        """
        if not prefix.endswith("/"):
            prefix += "/"
        with self._lock:
            out: List[Tuple[str, Timestamp, Optional[FileId]]] = []
            for path, v in self._names.items():
                if not path.startswith(prefix) or not v.versions:
                    continue
                rest = path[len(prefix):]
                if not rest or "/" in rest:
                    continue
                ent = v.at(ts) if ts is not None else v.current()
                if ent is not None:
                    out.append((path, ent[0], ent[1]))  # type: ignore[arg-type]
            return sorted(out)

    def listdir(self, prefix: str, ts: Optional[Timestamp] = None) -> List[str]:
        if not prefix.endswith("/"):
            prefix += "/"
        with self._lock:
            out = []
            for path, v in self._names.items():
                if not path.startswith(prefix):
                    continue
                ent = v.at(ts) if ts is not None else (v.current() if v.versions else None)
                if ent is not None and ent[1] is not None:
                    rest = path[len(prefix):]
                    if rest and "/" not in rest:
                        out.append(rest)
            return sorted(out)

    # ------------------------------------------------------------------ #
    # metadata
    # ------------------------------------------------------------------ #
    def put_meta(self, fid: FileId, meta: FileMeta, ts: Timestamp) -> None:
        with self._lock:
            v = self._meta.setdefault(fid, Versioned())
            v.put(ts, meta, self.versions_kept)

    def touch_meta(self, fid: FileId, ts: Timestamp) -> None:
        """Advance the current meta's mtime in place — no new version, no
        version-timestamp change, so concurrent meta readers stay valid
        and snapshot GC pressure is zero. Writers hold the commit lock;
        a fresh FileMeta object is swapped in so previously returned
        references never mutate under a reader."""
        with self._lock:
            v = self._meta.get(fid)
            if v is None or not v.versions:
                return
            cts, meta = v.versions[-1]
            if meta.exists and ts > meta.mtime_ts:
                v.versions[-1] = (
                    cts,
                    FileMeta(meta.length, meta.exists, meta.kind, ts),
                )

    def meta(self, fid: FileId, ts: Optional[Timestamp] = None) -> Tuple[Timestamp, FileMeta]:
        with self._lock:
            v = self._meta.get(fid)
            if v is None or not v.versions:
                raise NotFound(f"file {fid}")
            ent = v.at(ts) if ts is not None else v.current()
            if ent is None:
                raise NotFound(f"file {fid} @ {ts}")
            return ent  # type: ignore[return-value]

    # ------------------------------------------------------------------ #
    # blocks
    # ------------------------------------------------------------------ #
    def put_block(self, key: BlockKey, data: bytes, ts: Timestamp) -> None:
        with self._lock:
            v = self._blocks.setdefault(key, Versioned())
            v.put(ts, data, self.versions_kept)

    def block(
        self, key: BlockKey, ts: Optional[Timestamp] = None
    ) -> Tuple[Timestamp, bytes]:
        """(version_ts, bytes) — zero block if never written."""
        with self._lock:
            v = self._blocks.get(key)
            if v is None or not v.versions:
                return 0, b"\0" * self.block_size
            ent = v.at(ts) if ts is not None else v.current()
            if ent is None:
                return 0, b"\0" * self.block_size
            return ent  # type: ignore[return-value]

    def block_version(self, key: BlockKey) -> Timestamp:
        with self._lock:
            v = self._blocks.get(key)
            return v.current()[0] if v and v.versions else 0

    def blocks_of(self, fid: FileId) -> Iterable[BlockKey]:
        with self._lock:
            return [k for k in self._blocks if k[0] == fid]

    # ------------------------------------------------------------------ #
    # checkpoint export/import: current entries only (chains truncated to
    # the latest durable version — the undo history is recovery-time
    # garbage; snapshots older than the checkpoint correctly raise
    # SnapshotTooOld afterwards via the truncated flag)
    # ------------------------------------------------------------------ #
    def export_chains(self, since_ts: Optional[Timestamp] = None):
        """Wire-packable snapshot of every chain's newest entry. The
        caller must hold the backend commit lock, so 'newest' is a
        consistent committed state; values are immutable (bytes /
        FileMeta-by-value / fid) so only references are copied here —
        serialization happens outside the lock.

        With ``since_ts``, only chains dirtied AFTER that commit
        timestamp are exported — the delta-checkpoint version floor.
        Meta chains filter on ``max(version_ts, mtime_ts)``: ``touch``
        advances ``mtime_ts`` in place on the newest version WITHOUT
        minting a new version timestamp, so an mtime-only touch would
        otherwise be invisible to the floor and silently lost by a
        base+delta recovery. ``import_chains`` applies entries as a
        per-chain overlay, so a delta layers exactly onto the base
        snapshot it was cut against."""
        with self._lock:
            blocks = [
                (k, v.versions[-1][0], v.versions[-1][1],
                 v.truncated or len(v.versions) > 1)
                for k, v in self._blocks.items()
                if v.versions
                and (since_ts is None or v.versions[-1][0] > since_ts)
            ]
            metas = []
            for fid, v in self._meta.items():
                if not v.versions:
                    continue
                ts, m = v.versions[-1]
                if since_ts is not None and max(ts, m.mtime_ts) <= since_ts:
                    continue
                metas.append((fid, ts, m.length, m.exists, m.kind,
                              m.mtime_ts, v.truncated or len(v.versions) > 1))
            names = [
                (path, v.versions[-1][0], v.versions[-1][1],
                 v.truncated or len(v.versions) > 1)
                for path, v in self._names.items()
                if v.versions
                and (since_ts is None or v.versions[-1][0] > since_ts)
            ]
            return blocks, metas, names, self._next_file_id

    def import_chains(self, blocks, metas, names, next_fid) -> None:
        """Rebuild the store from an ``export_chains`` snapshot: every
        chain restarts as a single-entry version chain at its original
        commit timestamp, marked truncated when history was dropped."""
        with self._lock:
            for k, ts, data, trunc in blocks:
                self._blocks[tuple(k)] = Versioned([(ts, data)], bool(trunc))
            for fid, ts, length, exists, kind, mtime_ts, trunc in metas:
                self._meta[fid] = Versioned(
                    [(ts, FileMeta(length, exists, kind, mtime_ts))],
                    bool(trunc),
                )
            for path, ts, fid, trunc in names:
                self._names[path] = Versioned([(ts, fid)], bool(trunc))
            if next_fid > self._next_file_id:
                self._next_file_id = next_fid

    # ------------------------------------------------------------------ #
    # undo (2PC rollback of a partially applied cross-shard commit)
    # ------------------------------------------------------------------ #
    def pop_block(self, key: BlockKey, ts: Timestamp) -> None:
        with self._lock:
            v = self._blocks.get(key)
            if v is not None:
                v.pop(ts)

    def pop_meta(self, fid: FileId, ts: Timestamp) -> None:
        with self._lock:
            v = self._meta.get(fid)
            if v is not None:
                v.pop(ts)

    def pop_name(self, path: str, ts: Timestamp) -> None:
        with self._lock:
            v = self._names.get(path)
            if v is not None:
                v.pop(ts)
