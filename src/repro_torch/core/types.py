"""Core types for the FaaSFS transactional block store."""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

BLOCK_SIZE_DEFAULT = 4096           # POSIX byte-file layer
TENSOR_BLOCK_BYTES = 4 * 2**20      # tensor-state layer (4 MiB slabs)

Timestamp = int                     # shard-local commit timestamp
FileId = int
BlockKey = Tuple[int, int]          # (file_id, block_index)

# Reserved block index holding a file's advisory-lock word (optimistic
# lock elision, paper §3.1). Far beyond any data block a real file can
# reach at 4 KiB blocks; writes to it never count as data modifications
# (no mtime touch).
LOCK_BLOCK_INDEX = 1 << 30

# File kinds carried in FileMeta ("f" regular file, "d" directory). A
# file id never changes kind: unlink + recreate allocates a fresh id, so
# kind may be read without OCC validation.
KIND_FILE = "f"
KIND_DIR = "d"


# --------------------------------------------------------------------------- #
# Meta-update encoding (TxnPayload.meta_updates values).
#
# Three forms, all wire/WAL-serializable as plain value trees:
#   None             -> delete the file (unlink / rmdir / rename-over)
#   ("s", length, kind) -> set length+kind; bumps the meta version, so
#                       concurrent meta readers (stat / length checks)
#                       fail OCC validation. Also the directory
#                       "namespace generation" bump: every link/unlink
#                       under a real directory ships ("s", 0, "d") for
#                       the parent, which is what makes rmdir-vs-create
#                       and readdir-vs-create conflicts detectable.
#   ("t",)           -> mtime-only touch: an in-place data write. Applied
#                       WITHOUT creating a meta version, so it conflicts
#                       with nobody (preserves writer/stat concurrency).
#   int (legacy)     -> ("s", int, "f"); accepted for old WAL records.
# --------------------------------------------------------------------------- #
def meta_set(length: int, kind: str = KIND_FILE) -> Tuple[str, int, str]:
    return ("s", length, kind)


META_TOUCH: Tuple[str, ...] = ("t",)


def normalize_meta_update(value):
    """Canonical (op, ...) tuple for any accepted meta_updates value."""
    if value is None:
        return None
    if isinstance(value, int):
        return ("s", value, KIND_FILE)
    return tuple(value)

# A client's global sync position. The monolithic backend uses a plain
# Timestamp; the sharded backend uses a vector of per-shard timestamps
# (one component per shard, compared componentwise). Client code never
# inspects it directly — it round-trips through the BackendAPI, which
# supplies ``zero_ts`` / ``ts_geq`` / ``snapshot_cache_ok`` helpers.
SyncTimestamp = object  # Timestamp | Tuple[Timestamp, ...]


class Conflict(Exception):
    """Raised when OCC validation fails at commit; the function must retry.

    ``keys`` is the legacy ``(tag, item)`` list. ``detail`` is the
    explainability enrichment (PR 7): one dict per conflicting item —
    ``{"tag", "key", "shard", "winner"}`` — naming the shard that
    rejected the item and the commit timestamp of the write that won
    the race. Both round-trip over the wire."""

    def __init__(self, reason: str, keys: Optional[List] = None,
                 detail: Optional[List[Dict]] = None):
        super().__init__(reason)
        self.reason = reason
        self.keys = keys or []
        self.detail = detail or []


class NotFound(Exception):
    pass


class Exists(Exception):
    pass


class TxnStateError(Exception):
    pass


class PredicateKind(Enum):
    GE = "ge"   # filelength >= n  (read fully within file)
    LE = "le"   # filelength <= n  (read started beyond EOF)
    EQ = "eq"   # filelength == n  (read truncated by EOF / explicit stat)


@dataclass(frozen=True)
class LengthPredicate:
    file_id: FileId
    kind: PredicateKind
    value: int

    def holds(self, length: int) -> bool:
        if self.kind == PredicateKind.GE:
            return length >= self.value
        if self.kind == PredicateKind.LE:
            return length <= self.value
        return length == self.value


@dataclass
class ReadRecord:
    """A block read: the version timestamp actually observed.

    The paper records (blocknum, T_R) and relies on begin-time cache sync;
    recording the observed version validates identically under the eager /
    lazy policies and stays correct under the 'leave stale' policy (see
    core/backend.py docstring).
    """

    key: BlockKey
    version: Timestamp


@dataclass
class WriteRecord:
    """Partial block update: list of (offset, bytes) patches within a block."""

    key: BlockKey
    patches: List[Tuple[int, bytes]] = field(default_factory=list)

    def apply_to(self, base: bytes, block_size: int) -> bytes:
        buf = bytearray(base.ljust(block_size, b"\0"))
        for off, data in self.patches:
            buf[off : off + len(data)] = data
        return bytes(buf)

    def add(self, offset: int, data: bytes) -> None:
        self.patches.append((offset, data))


class CachePolicy(Enum):
    EAGER = "eager"        # push data for all changed blocks at txn begin
    LAZY = "lazy"          # file-level sync on first access within the txn
    INVALIDATE = "invalidate"  # block-level invalidations only, fetch on miss
    STALE = "stale"        # do nothing; commit validation catches misreads
    FREQUENT = "frequent"  # push hot blocks (fetch-frequency heuristic), invalidate rest
