"""Durable write-ahead commit log + checkpointing + crash recovery.

Until now the backend only *modeled* durability: ``commit_service_s``
charged a simulated log-fsync per commit-lock acquisition, and group
commit amortized that simulated cost per batch. This module makes the
real path real: on validate-success the commit's effects are appended to
an on-disk log and fsync'd **before the client's commit is acknowledged**,
so an acked commit survives a server crash. Group commit keeps its role
unchanged — many appends, one fsync.

Three layers live here:

  * ``WriteAheadLog`` — one append-only CRC-framed file. On an fsync (or
    write) failure the log is *poisoned*: every subsequent ``append`` /
    ``sync`` raises ``WalFailed`` and the fsync is never retried — after
    a failed fsync the kernel may have dropped the dirty pages, so a
    later "successful" fsync would silently lie about durability
    (fsyncgate). In-flight commits fail typed instead of acking.
  * ``SegmentedWal`` — a log *directory* of numbered segments
    (``wal.000001``, ``wal.000002``, …) with rotation, plus installed
    checkpoints (``ckpt.NNNNNN``). This is what bounds recovery: replay
    is O(tail since the last checkpoint), not O(history).
  * checkpoint writer/loader + ``recover_dir`` — a checkpoint serializes
    a consistent backend snapshot (current block / meta / namespace
    entries, commit-log tail, sequencers, sync vector, epoch, fid floor)
    through the ``wire`` codec into a CRC-framed file, written to a
    ``.tmp`` name, fsync'd, atomically renamed into place, directory
    fsync'd — then every WAL segment the checkpoint covers is deleted.
    Recovery loads the newest *valid* checkpoint (falling back to the
    previous one if the newest is torn), replays only the segments after
    it, and truncates the final segment's torn tail.

**Record framing.** The log is a flat sequence of records::

    [ body_len : u32 BE ][ crc32(body) : u32 BE ][ body : body_len bytes ]

``body`` is a ``repro.core.wire``-packed value tree. Recovery scans from
the start; the first record whose header is short, whose body is missing
bytes, or whose CRC mismatches marks the torn tail left by a crash
mid-append — everything from there on is discarded (those commits were
never acked, because the ack waits for the fsync that would have
completed the record).

**Record kinds** (first element of the packed tuple):

  ``("epoch", n)``            — server start / recovery; fences file-id
                                leases granted by earlier incarnations.
  ``("lease", epoch, start, count)``
                              — a file-id range lease granted to a client;
                                logged durably *before* the grant is sent,
                                so a restarted server never re-grants an
                                overlapping range.
  ``("c", shard, ts, effects)``
                              — a single-shard commit applied at
                                shard-local timestamp ``ts``.
  ``("x", [(shard, ts, effects), ...])``
                              — a cross-shard (2PC) commit; one atomic
                                record for all participants, so recovery
                                replays it on all shards or none.

Cluster records (distributed 2PC + live rebalancing, ``core/cluster.py``):

  ``("prep", txid, [(slot, ts, effects), ...])``
                              — participant prepare marker: the slots
                                voted yes and reserved ``ts``; fsync'd
                                BEFORE the vote leaves the process.
  ``("dec", txid, "c"|"a")``  — participant decision marker: commit
                                applies the matching prep's effects on
                                replay, abort discards them. A prep with
                                no dec is *in-doubt* and resolves against
                                the coordinator's decision log.
  ``("xdec", txid)``          — coordinator decision record: the txn is
                                committed (fsync'd before any participant
                                is told to commit; absence = presumed
                                abort).
  ``("cmap", map_obj)``       — coordinator ShardMap change (version
                                bump), durable before clients see it.
  ``("mig-start", slots, from_addr, to_addr)``
                              — coordinator migration intent; a
                                mig-start without a following cmap rolls
                                forward iff the target imported.
  ``("mig-in", [(slot, state), ...])``
                              — participant imported these slot states
                                (it owns them from here on).
  ``("mig-out", [slot, ...])``
                              — participant dropped these slots after a
                                completed migration.

``effects`` is the durable projection of a ``TxnPayload`` — writes
(block key + patch list), metadata updates, and namespace updates;
reads/predicates are validation-time-only and are not logged. Replaying
all records in order onto an empty backend rebuilds the exact block /
meta / namespace version chains and resumes every sequencer (patches are
deterministic: base-relative byte splices).

**Group fsync.** ``append`` is cheap (one buffered-to-OS write under a
lock) and returns the log offset after the record. ``sync(lsn)`` returns
immediately if a past fsync already covered ``lsn``; otherwise one caller
fsyncs while concurrent appends pile up behind it and are absorbed by
the next fsync — the classic group-commit log, independent of (and
composing with) the in-memory batch committer.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import obs, wire

# WAL metrics, pre-bound at import time (see core/obs.py)
_FSYNC_US = obs.REGISTRY.histogram(
    "faasfs_wal_fsync_us", unit="us",
    help="durability-barrier fsync latency",
).labels()
_CKPT_US = obs.REGISTRY.histogram(
    "faasfs_wal_ckpt_us", unit="us",
    help="checkpoint cycle duration (capture+serialize+install+compact)",
).labels()
_CKPT_BYTES = obs.REGISTRY.counter(
    "faasfs_wal_ckpt_bytes_total", unit="bytes",
    help="checkpoint bytes written",
).labels()
_SEG_BYTES = obs.REGISTRY.counter(
    "faasfs_wal_segment_bytes_total", unit="bytes",
    help="log bytes appended",
).labels()

_REC_HDR = struct.Struct(">II")

#: fsync modes — "fsync" is the durable default; "none" leaves the data in
#: the OS page cache (benchmark baseline: survives process death, not a
#: machine crash).
SYNC_MODES = ("fsync", "none")


class WalFailed(Exception):
    """The durable log hit an unrecoverable I/O failure (failed write or
    fsync). The log object is poisoned: every subsequent ``append`` /
    ``sync`` raises this, and the fsync is never retried — a failed fsync
    may have dropped the dirty pages from the kernel cache, so retrying
    could report durability for data that is gone (fsyncgate)."""


class RecoveryError(Exception):
    """The log directory cannot prove it covers every acked commit —
    a coverage hole (no valid checkpoint but segments start past 1, a
    gap in the segment numbering) or corruption in a non-final segment.
    Refusing to start is the only honest move: silently rebuilding from
    a hole would serve a state missing acked data."""


class WriteAheadLog:
    def __init__(self, path: str, sync_mode: str = "fsync"):
        if sync_mode not in SYNC_MODES:
            raise ValueError(f"sync_mode must be one of {SYNC_MODES}")
        self.path = path
        self.sync_mode = sync_mode
        # unbuffered append-only: a write() lands in the page cache
        # immediately, so sync() only needs the fsync
        self._f = open(path, "ab", buffering=0)
        self._mu = threading.Lock()          # serializes appends
        self._sync_mu = threading.Lock()     # serializes fsyncs
        self._end = self._f.seek(0, os.SEEK_END)
        self._synced = self._end
        self.appends = 0
        self.fsyncs = 0
        self._fsync = os.fsync  # injectable: tests poison the log this way
        self._failed: Optional[BaseException] = None

    def _check_poisoned(self) -> None:
        if self._failed is not None:
            raise WalFailed(
                f"log {self.path} poisoned by earlier I/O failure: "
                f"{self._failed}"
            )

    # ------------------------------------------------------------------ #
    def append(self, record: Any) -> int:
        """Append one record (buffered); returns the log end offset to
        pass to ``sync`` for the durability barrier."""
        body = wire.pack(record)
        frame = _REC_HDR.pack(len(body), zlib.crc32(body)) + body
        with self._mu:
            self._check_poisoned()
            try:
                self._f.write(frame)
            except OSError as e:
                self._failed = e
                raise WalFailed(f"log {self.path} write failed: {e}") from e
            self._end += len(frame)
            self.appends += 1
            _SEG_BYTES.inc(len(frame))
            return self._end

    def sync(self, lsn: Optional[int] = None) -> None:
        """Durability barrier: block until the log through ``lsn`` (or the
        current end) is on stable storage. Concurrent callers are absorbed
        by a single fsync (group commit). Raises ``WalFailed`` — and
        poisons the log — if the fsync fails; the caller must NOT ack the
        commit it was barriering for."""
        if lsn is None:
            with self._mu:
                self._check_poisoned()
                lsn = self._end
        if self.sync_mode == "none":
            self._check_poisoned()
            return
        self._check_poisoned()
        if self._synced >= lsn:
            return
        with self._sync_mu:
            self._check_poisoned()
            if self._synced >= lsn:
                return
            with self._mu:
                end = self._end
            try:
                t0 = obs.now_us()
                with obs.span("wal.fsync", "wal"):
                    self._fsync(self._f.fileno())
                _FSYNC_US.observe(obs.now_us() - t0)
            except OSError as e:
                # Poison BEFORE releasing _sync_mu: concurrent syncers
                # queued behind this fsync must not retry it against a
                # page cache the kernel may already have dropped.
                self._failed = e
                raise WalFailed(f"log {self.path} fsync failed: {e}") from e
            self.fsyncs += 1
            if end > self._synced:
                self._synced = end

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


# --------------------------------------------------------------------------- #
# scan / recovery
# --------------------------------------------------------------------------- #
def scan(path: str) -> Tuple[List[Any], int]:
    """Parse ``path``; returns ``(records, good_end)`` where ``good_end``
    is the offset just past the last intact record. A torn or corrupt
    tail (short header, short body, CRC mismatch, undecodable body) ends
    the scan — it is the not-yet-acked residue of a crash."""
    records: List[Any] = []
    good_end = 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return records, 0
    off, n = 0, len(data)
    while off + _REC_HDR.size <= n:
        body_len, crc = _REC_HDR.unpack_from(data, off)
        body_off = off + _REC_HDR.size
        if body_off + body_len > n:
            break                       # torn tail: body incomplete
        body = data[body_off : body_off + body_len]
        if zlib.crc32(body) != crc:
            break                       # torn/corrupt record
        try:
            records.append(wire.unpack(body))
        except wire.WireError:
            break
        off = body_off + body_len
        good_end = off
    return records, good_end


def truncate_to(path: str, good_end: int) -> None:
    """Drop a torn tail so post-recovery appends start on a record
    boundary."""
    try:
        size = os.path.getsize(path)
    except FileNotFoundError:
        return
    if size > good_end:
        with open(path, "r+b") as f:
            f.truncate(good_end)
            f.flush()
            os.fsync(f.fileno())


# --------------------------------------------------------------------------- #
# effects: the durable projection of a TxnPayload
# --------------------------------------------------------------------------- #
def effects_from_payload(payload) -> Tuple[Any, Any, Any]:
    return (
        [(w.key, [tuple(p) for p in w.patches]) for w in payload.writes],
        dict(payload.meta_updates),
        dict(payload.name_updates),
    )


def payload_from_effects(effects):
    from repro_torch.core.backend import TxnPayload
    from repro_torch.core.types import WriteRecord

    writes, meta_updates, name_updates = effects
    return TxnPayload(
        read_ts=0,
        writes=[
            WriteRecord(tuple(k), [tuple(p) for p in pts])
            for k, pts in writes
        ],
        meta_updates=dict(meta_updates),
        name_updates=dict(name_updates),
    )


def replay(backend, records) -> Dict[str, int]:
    """Replay scanned records into a freshly constructed backend and
    return a summary: commits replayed, last epoch seen, and the file-id
    floor implied by durable leases (the allocator must resume above it).
    """
    commits = 0
    epoch = 0
    fid_floor = 1
    for rec in records:
        kind = rec[0]
        if kind == "epoch":
            epoch = max(epoch, rec[1])
        elif kind == "lease":
            _, _, start, count = rec
            fid_floor = max(fid_floor, start + count)
        elif kind in ("c", "x"):
            backend.replay_record(rec)
            commits += 1
        elif kind in ("prep", "dec", "xdec", "cmap", "mig-start",
                      "mig-in", "mig-out"):
            # cluster markers (distributed 2PC, migration): the backend
            # owns their semantics; only decided prepares count as
            # replayed commits
            backend.replay_record(rec)
            if kind == "dec" and rec[2] == "c":
                commits += 1
        else:
            raise ValueError(f"unknown WAL record kind {kind!r}")
    if hasattr(backend, "bump_fid_floor"):
        backend.bump_fid_floor(fid_floor)
    return {"commits": commits, "epoch": epoch, "fid_floor": fid_floor}


def recover(backend, path: str) -> Dict[str, int]:
    """Single-file crash recovery (legacy layout): scan, truncate the
    torn tail, replay into ``backend``. Returns the replay summary (see
    ``replay``). The segmented layout recovers via ``recover_dir``."""
    records, good_end = scan(path)
    truncate_to(path, good_end)
    return replay(backend, records)


# --------------------------------------------------------------------------- #
# segmented log directory
# --------------------------------------------------------------------------- #
_SEG_PREFIX = "wal."
_CKPT_PREFIX = "ckpt."
_TMP_SUFFIX = ".tmp"
#: v2 adds a ``base_seg`` chain link to the header: 0 = self-contained
#: full snapshot, else the covered-segment index of the checkpoint this
#: DELTA must be layered onto. v1 files (5-tuple header) still load as
#: fulls — an existing directory upgrades in place.
CKPT_VERSION = 2


def _seg_name(idx: int) -> str:
    return f"{_SEG_PREFIX}{idx:06d}"


def _ckpt_name(idx: int) -> str:
    return f"{_CKPT_PREFIX}{idx:06d}"


def _parse_numbered(name: str, prefix: str) -> Optional[int]:
    if not name.startswith(prefix) or name.endswith(_TMP_SUFFIX):
        return None
    try:
        return int(name[len(prefix):])
    except ValueError:
        return None


def list_segments(dirpath: str) -> List[Tuple[int, str]]:
    """Sorted ``(index, path)`` of live WAL segments in ``dirpath``."""
    out = []
    for name in os.listdir(dirpath):
        idx = _parse_numbered(name, _SEG_PREFIX)
        if idx is not None:
            out.append((idx, os.path.join(dirpath, name)))
    return sorted(out)


def list_checkpoints(dirpath: str) -> List[Tuple[int, str]]:
    """Sorted ``(covered_segment, path)`` of installed checkpoints."""
    out = []
    for name in os.listdir(dirpath):
        idx = _parse_numbered(name, _CKPT_PREFIX)
        if idx is not None:
            out.append((idx, os.path.join(dirpath, name)))
    return sorted(out)


def _fsync_dir(dirpath: str) -> None:
    """Make directory-entry mutations (create/rename/unlink) durable."""
    fd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SegmentedWal:
    """A write-ahead log split across numbered segment files in one
    directory. Presents the same ``append`` / ``sync`` / counters surface
    as ``WriteAheadLog`` (backends attach it unchanged via ``set_wal``),
    plus ``rotate`` / ``drop_through`` for the checkpointer.

    LSNs are ``(segment_index, offset)`` pairs. ``rotate`` fully fsyncs
    the outgoing segment before opening the next one, so any LSN in a
    segment older than the current one is durable by construction —
    ``sync`` only ever fsyncs the current segment.
    """

    def __init__(self, dirpath: str, sync_mode: str = "fsync"):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.sync_mode = sync_mode
        self._mu = threading.Lock()  # guards the current-segment swap
        segs = list_segments(dirpath)
        self._cur_idx = segs[-1][0] if segs else 1
        self._cur = WriteAheadLog(
            os.path.join(dirpath, _seg_name(self._cur_idx)), sync_mode
        )
        if not segs:
            _fsync_dir(dirpath)
        # counters survive rotation (benchmarks read them continuously)
        self._appends_done = 0
        self._fsyncs_done = 0

    # -- WriteAheadLog-compatible surface ------------------------------ #
    @property
    def appends(self) -> int:
        return self._appends_done + self._cur.appends

    @property
    def fsyncs(self) -> int:
        return self._fsyncs_done + self._cur.fsyncs

    def append(self, record: Any) -> Tuple[int, int]:
        # _mu is held ACROSS the inner append: an append racing rotate()
        # must not land in (or hit the closed fd of) a just-retired
        # segment — the record would sit in a compaction-covered file the
        # checkpoint never saw. sync() deliberately does NOT take _mu
        # around the fsync (group commit must absorb concurrent
        # appenders); a racer that snapshots the old segment returns
        # early off its _synced watermark, which rotation leaves at the
        # segment end.
        with self._mu:
            return (self._cur_idx, self._cur.append(record))

    def sync(self, lsn: Optional[Tuple[int, int]] = None) -> None:
        with self._mu:
            cur, idx = self._cur, self._cur_idx
        if lsn is None:
            cur.sync(None)
            return
        seg, off = lsn
        if seg < idx:
            return  # rotation fsync'd that whole segment already
        cur.sync(off)

    def close(self) -> None:
        with self._mu:
            self._cur.close()

    # -- segmentation --------------------------------------------------- #
    def rotate(self) -> int:
        """Fsync + retire the current segment, open the next one; returns
        the retired segment's index (the checkpoint coverage bound). The
        caller must quiesce appenders (the checkpointer holds the commit
        locks and the allocator lock), so no record can straddle the
        boundary."""
        with self._mu:
            old, old_idx = self._cur, self._cur_idx
            old.sync()  # everything in the old segment is durable
            new_idx = old_idx + 1
            new = WriteAheadLog(
                os.path.join(self.dir, _seg_name(new_idx)), self.sync_mode
            )
            self._appends_done += old.appends
            self._fsyncs_done += old.fsyncs
            self._cur, self._cur_idx = new, new_idx
            old.close()
        _fsync_dir(self.dir)
        return old_idx

    def drop_through(self, covered_idx: int) -> int:
        """Delete every segment with index <= ``covered_idx`` (they are
        fully represented by an installed checkpoint). Returns how many
        were removed."""
        removed = 0
        for idx, path in list_segments(self.dir):
            if idx <= covered_idx and idx != self._cur_idx:
                try:
                    os.unlink(path)
                    removed += 1
                except FileNotFoundError:
                    pass
        if removed:
            _fsync_dir(self.dir)
        return removed

    def live_bytes(self) -> int:
        """Total on-disk size of all live segments (the compaction
        trigger's size signal — shrinks when drop_through runs)."""
        total = 0
        for _, path in list_segments(self.dir):
            try:
                total += os.path.getsize(path)
            except FileNotFoundError:
                pass
        return total

    @property
    def current_segment(self) -> int:
        return self._cur_idx


# --------------------------------------------------------------------------- #
# checkpoints: consistent snapshot files covering a WAL prefix
# --------------------------------------------------------------------------- #
def _append_framed(f, record: Any) -> None:
    body = wire.pack(record)
    f.write(_REC_HDR.pack(len(body), zlib.crc32(body)) + body)


def write_checkpoint(
    dirpath: str,
    covered_seg: int,
    epoch: int,
    next_fid: int,
    state: Any,
    base_seg: int = 0,
) -> str:
    """Serialize one backend snapshot into ``ckpt.<covered_seg>``.

    The file is a CRC-framed record sequence — ``("ckpt-hdr", version,
    covered_seg, epoch, next_fid, base_seg)``, ``("state", tree)``,
    ``("ckpt-end", 2)`` — written to a ``.tmp`` name, fsync'd, atomically
    renamed into place, then the directory entry is fsync'd. A crash at
    ANY point before the rename leaves only ignorable ``.tmp`` garbage; a
    torn installed file (storage corruption) is rejected by the
    CRC/end-marker check at load time and recovery falls back to the
    previous checkpoint, whose covered segments are only deleted after a
    *successful* install.

    ``base_seg != 0`` marks ``state`` as a DELTA export: recovery must
    first import ``ckpt.<base_seg>`` (itself possibly a delta — the
    links form a chain ending in a full) and overlay this one on top.
    """
    final = os.path.join(dirpath, _ckpt_name(covered_seg))
    tmp = final + _TMP_SUFFIX
    with open(tmp, "wb") as f:
        _append_framed(f, ("ckpt-hdr", CKPT_VERSION, covered_seg, epoch,
                           next_fid, base_seg))
        _append_framed(f, ("state", state))
        _append_framed(f, ("ckpt-end", 2))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    _fsync_dir(dirpath)
    return final


def _parse_ckpt_hdr(hdr: Any) -> Optional[Tuple[int, int, int, int]]:
    """Validate a ``("ckpt-hdr", ...)`` record; returns ``(covered_seg,
    epoch, next_fid, base_seg)`` or ``None``. v1 headers (5-tuple) are
    full checkpoints (``base_seg = 0``); v2 (6-tuple) carries the chain
    link explicitly."""
    if not (isinstance(hdr, tuple) and len(hdr) >= 2
            and hdr[0] == "ckpt-hdr"):
        return None
    if len(hdr) == 5 and hdr[1] == 1:
        return hdr[2], hdr[3], hdr[4], 0
    if len(hdr) == 6 and hdr[1] == CKPT_VERSION:
        return hdr[2], hdr[3], hdr[4], hdr[5]
    return None


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """Parse + validate one checkpoint file; ``None`` if torn/invalid
    (bad CRC, missing end marker, wrong record shape, unknown version)."""
    records, _ = scan(path)
    if len(records) != 3:
        return None
    hdr, state_rec, end = records
    parsed = _parse_ckpt_hdr(hdr)
    if parsed is None:
        return None
    if not (isinstance(state_rec, tuple) and len(state_rec) == 2
            and state_rec[0] == "state"):
        return None
    if end != ("ckpt-end", 2):
        return None
    return {
        "seg": parsed[0],
        "epoch": parsed[1],
        "next_fid": parsed[2],
        "base_seg": parsed[3],
        "state": state_rec[1],
    }


def _ckpt_header(path: str) -> Optional[Dict[str, int]]:
    """Read + validate ONLY the first framed record of a checkpoint —
    enough to walk ``base_seg`` chain links without deserializing the
    state tree (compaction walks the live chain on every cycle)."""
    try:
        with open(path, "rb") as f:
            raw = f.read(_REC_HDR.size)
            if len(raw) < _REC_HDR.size:
                return None
            body_len, crc = _REC_HDR.unpack(raw)
            body = f.read(body_len)
    except OSError:
        return None
    if len(body) != body_len or zlib.crc32(body) != crc:
        return None
    try:
        rec = wire.unpack(body)
    except wire.WireError:
        return None
    parsed = _parse_ckpt_hdr(rec)
    if parsed is None:
        return None
    return {"seg": parsed[0], "epoch": parsed[1], "next_fid": parsed[2],
            "base_seg": parsed[3]}


def _live_chain(dirpath: str, head_idx: int) -> set:
    """Checkpoint indices reachable from ``head_idx`` via ``base_seg``
    links, head included. Stops at a full checkpoint, a missing or
    unreadable link, or a non-decreasing link (cycle guard). Recovery
    re-validates the whole chain; this only scopes compaction — an
    over-approximation merely keeps a file longer."""
    keep = {head_idx}
    idx = head_idx
    while True:
        h = _ckpt_header(os.path.join(dirpath, _ckpt_name(idx)))
        if h is None or h["base_seg"] == 0 or h["base_seg"] >= idx:
            return keep
        idx = h["base_seg"]
        keep.add(idx)


def _snapshot_floor(state: Any) -> Any:
    """The version floor a FUTURE delta export should filter against,
    read off a just-exported snapshot: the monolithic backend's commit
    timestamp, or the per-slot shard timestamps for a sharded one."""
    if isinstance(state, dict) and state.get("kind") == "sharded":
        return {s: sh["ts"] for s, sh in zip(state["slots"], state["shards"])}
    if isinstance(state, dict) and "ts" in state:
        return state["ts"]
    return None


def checkpoint_backend(
    wal: SegmentedWal, backend, epoch: int, next_fid_fn=None, base=None
) -> Dict[str, Any]:
    """One checkpoint + compaction cycle against ``backend``.

    ``base`` is the PREVIOUS cycle's return value (or ``None``). When
    the backend advertises ``supports_delta_export`` and ``base`` names
    a still-installed checkpoint with a version floor, this cycle
    exports only chains dirtied past that floor and installs the result
    as a delta linked to ``base["seg"]`` — checkpoint cost scales with
    the write rate since the last cycle, not the state size. Otherwise
    (first cycle after a restart, floor-less backends, base file gone)
    it falls back to a self-contained full. Compaction then deletes
    every checkpoint BELOW the new head that is not on its live chain,
    so a delta's ancestors survive exactly as long as something links
    to them.

    Under the backend's ``freeze()`` (all commit locks — the capture is
    an O(state) reference walk, NOT the serialization): rotate the log so
    the segment boundary exactly brackets the snapshot, then export the
    snapshot tree and read the file-id allocator position. Outside the
    locks: serialize + fsync + rename-install the checkpoint, then
    delete every covered segment. Commits proceed concurrently with the
    expensive part (pack/write/fsync).

    ``next_fid_fn`` (the server passes its allocator's ``peek_next``) is
    called strictly AFTER the rotation: a lease grant bumps the counter
    before appending its record, so any lease whose record landed in a
    now-covered segment is visible to this read — covered segments can
    be deleted without ever shrinking the recoverable fid floor. A grant
    racing past the rotation lands its record in the new (kept) segment.
    """
    t0 = obs.now_us()
    delta_capable = getattr(backend, "supports_delta_export", False)
    want_delta = (
        delta_capable
        and base is not None
        and base.get("floor") is not None
        and base.get("seg", 0) > 0
        and os.path.exists(os.path.join(wal.dir, _ckpt_name(base["seg"])))
    )
    with backend.freeze():
        covered = wal.rotate()
        if want_delta:
            state = backend.export_snapshot(base["floor"])
        else:
            state = backend.export_snapshot()
        next_fid = next_fid_fn() if next_fid_fn is not None else 1
    base_seg = base["seg"] if want_delta else 0
    path = write_checkpoint(wal.dir, covered, epoch, next_fid, state,
                            base_seg=base_seg)
    removed = wal.drop_through(covered)
    # compact: every checkpoint below the new head is redundant UNLESS
    # the head's delta chain still links to it (its fallback value as a
    # standalone restore point is gone anyway — the segments after it
    # were just deleted — but as a chain base it carries the state the
    # deltas above it omit)
    keep = _live_chain(wal.dir, covered)
    for idx, old in list_checkpoints(wal.dir):
        if idx < covered and idx not in keep:
            try:
                os.unlink(old)
            except FileNotFoundError:
                pass
    ckpt_bytes = os.path.getsize(path)
    _CKPT_BYTES.inc(ckpt_bytes)
    _CKPT_US.observe(obs.now_us() - t0)
    return {
        "seg": covered,
        "bytes": ckpt_bytes,
        "segments_removed": removed,
        "base_seg": base_seg,
        "floor": _snapshot_floor(state) if delta_capable else None,
        "chain_len": len(keep),
    }


def recover_dir(backend, dirpath: str) -> Dict[str, int]:
    """Bounded crash recovery over a segmented log directory.

    Order: resolve the newest *usable* checkpoint — valid itself AND,
    if it is a delta, with every ``base_seg`` link down to a full
    checkpoint valid too (torn files and broken-chain heads are skipped
    — fall back toward older checkpoints). Import the chain base-first
    (each delta overlays the state below it), then replay only the WAL
    segments strictly after the head's covered segment, truncating the
    final segment's torn tail. Leftover ``.tmp`` files, unusable
    checkpoints, and segments already covered by the head are deleted (a
    crash between checkpoint install and segment deletion re-runs the
    deletion here).

    Raises ``RecoveryError`` — refusing to start — when the directory
    cannot prove full coverage of acked commits: no valid checkpoint but
    the segments do not start at 1 (the only checkpoint rotted after its
    covered segments were deleted), a gap in the segment numbering, or a
    torn record inside a NON-final segment (segments are fully fsync'd
    before rotation, so a mid-log tear is storage corruption, not a
    crash artifact — replaying past the hole would violate commit
    order, replaying up to it would silently drop acked data). Falling
    back past a broken delta chain hits the same proof: the broken
    head's covered segments were compacted away, so the older candidate
    cannot cover them and recovery REFUSES rather than silently serving
    state that drops acked commits.

    Returns ``{"commits": tail_commits_replayed, "epoch", "fid_floor",
    "ckpt_seg", "ckpt_loaded"}`` — ``commits`` counts ONLY the tail, the
    number that bounds restart cost.
    """
    os.makedirs(dirpath, exist_ok=True)
    ckpts: Dict[int, str] = dict(list_checkpoints(dirpath))
    loaded: Dict[int, Optional[Dict[str, Any]]] = {}

    def _load(idx: int) -> Optional[Dict[str, Any]]:
        if idx not in loaded:
            path = ckpts.get(idx)
            loaded[idx] = None if path is None else load_checkpoint(path)
        return loaded[idx]

    # newest-first: a candidate is usable iff it loads AND its base_seg
    # chain resolves all the way to a full checkpoint (delta files whose
    # base is gone or torn are as useless as torn files themselves)
    chain: List[Dict[str, Any]] = []  # head first, full last
    invalid: List[str] = []
    for idx in sorted(ckpts, reverse=True):
        c = _load(idx)
        if c is None:
            invalid.append(ckpts[idx])
            continue
        cand = [c]
        seen = {idx}
        cur = c
        while cur["base_seg"] != 0:
            b = cur["base_seg"]
            if b in seen or b >= cur["seg"]:
                cand = []  # malformed link / cycle: head unusable
                break
            nxt = _load(b)
            if nxt is None:
                cand = []  # missing or torn base
                break
            seen.add(b)
            cand.append(nxt)
            cur = nxt
        if cand:
            chain = cand
            break
        invalid.append(ckpts[idx])
    chosen = chain[0] if chain else None

    epoch = 0
    fid_floor = 1
    base_seg = 0 if chosen is None else chosen["seg"]

    # Coverage proof BEFORE mutating anything: rotation numbers segments
    # contiguously and compaction only ever deletes a prefix covered by
    # an installed checkpoint, so the live tail must run base_seg+1,
    # base_seg+2, … without gaps. A hole means acked commits are
    # unrecoverable — refuse rather than silently serve a partial state
    # (e.g. the ONLY checkpoint rotted after its covered segments were
    # deleted: chosen is None but the segments start far past 1).
    tail_idx = [i for i, _ in list_segments(dirpath) if i > base_seg]
    expected = list(range(base_seg + 1, base_seg + 1 + len(tail_idx)))
    if tail_idx != expected:
        covered = ("no valid checkpoint" if chosen is None
                   else f"checkpoint covers <= {base_seg}")
        raise RecoveryError(
            f"WAL coverage hole in {dirpath}: {covered} but live "
            f"segments are {tail_idx} (expected {expected}); acked "
            "commits may be missing — refusing to recover"
        )

    if chain:
        # base-first: the full snapshot, then each delta overlaid in
        # commit order — import_snapshot applies per-chain overlays, so
        # the stack reconstructs exactly the head's covered state
        for c in reversed(chain):
            backend.import_snapshot(c["state"])
        epoch = chosen["epoch"]
        fid_floor = max(fid_floor, *(c["next_fid"] for c in chain))

    commits = 0
    segs = [e for e in list_segments(dirpath) if e[0] > base_seg]
    for pos, (idx, path) in enumerate(segs):
        records, good_end = scan(path)
        last = pos == len(segs) - 1
        if last:
            truncate_to(path, good_end)  # torn tail of the crash
        elif good_end < os.path.getsize(path):
            raise RecoveryError(
                f"torn record inside non-final WAL segment {path} "
                f"(intact through byte {good_end}): storage corruption — "
                "acked commits past the hole are unrecoverable, refusing"
            )
        # one record-dispatch loop for both layouts: per-segment replay()
        # folds monotonically (bump_fid_floor per segment is safe)
        seg_summary = replay(backend, records)
        commits += seg_summary["commits"]
        epoch = max(epoch, seg_summary["epoch"])
        fid_floor = max(fid_floor, seg_summary["fid_floor"])

    # cleanup: covered segments, invalid checkpoints, orphaned tmp files,
    # checkpoints older than the one we loaded
    for idx, path in list_segments(dirpath):
        if idx <= base_seg:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
    for path in invalid:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
    chain_segs = {c["seg"] for c in chain}
    for idx, path in list_checkpoints(dirpath):
        if chosen is not None and idx < base_seg and idx not in chain_segs:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
    for name in os.listdir(dirpath):
        if name.endswith(_TMP_SUFFIX):
            try:
                os.unlink(os.path.join(dirpath, name))
            except FileNotFoundError:
                pass

    if hasattr(backend, "bump_fid_floor"):
        backend.bump_fid_floor(fid_floor)
    return {
        "commits": commits,
        "epoch": epoch,
        "fid_floor": fid_floor,
        "ckpt_seg": base_seg,
        "ckpt_loaded": chosen is not None,
        "ckpt_chain": len(chain),
    }
