"""Wire protocol for the networked FaaSFS transport.

Two layers, both self-contained (no third-party dependency):

**Codec** — a msgpack-shaped binary encoding (`pack` / `unpack`) for the
value trees the RPCs exchange: None, bool, signed 64-bit ints, float64,
bytes, str, list, dict, and tuple. The format follows the real msgpack
tag layout (fixint / fixstr / fixarray / fixmap, bin8/16/32, str8/16/32,
array16/32, map16/32, int/uint families, ext) so the bytes are readable
by any msgpack decoder that understands ext type 1 = tuple. Tuples need
their own ext tag because the protocol round-trips dict keys like
``BlockKey = (file_id, block_index)`` — decoding arrays as lists would
make them unhashable.

**Frames** — every message on the socket is ``header || body`` (wire v2):

    header = MAGIC(1) | VERSION(1) | MSG_TYPE(1) | FLAGS(1)
           | REQUEST_ID(4, BE) | BODY_LEN(4, BE)

The FLAGS byte (the v2 pad byte, always 0 until now, so untraced
traffic is byte-identical) carries ``FLAG_TRACE``: when set, a 16-byte
trace envelope ``TRACE_ID(8, BE) | SPAN_ID(8, BE)`` sits between the
header and the body (``BODY_LEN`` still counts only the codec body).
That is how a client propagates its sampling decision and trace
context to the server — the flag IS the sampled bit — so server-side
spans (queue wait, worker exec, WAL fsync) land in the same Perfetto
timeline as the client RPC that caused them. See ``core/obs.py``.

A peer that sees a wrong magic or an unsupported version drops the
connection instead of guessing. The message-type byte selects the RPC
(requests) or the outcome (``T_OK`` / ``T_ERR`` responses); bodies are
codec-packed value trees. The request id (new in v2) correlates replies
with requests, so MANY requests can be in flight on one connection and
the server may answer them out of order as handlers finish — the client
multiplexes futures by id instead of holding a pool of one-at-a-time
connections (v1's model). Id 0 is reserved for unsolicited server
frames (the hello).

This module also pins down the *object conversions* between the typed
dataclasses (``TxnPayload`` / ``BeginReply`` / ``CommitReply`` /
``BackendStats``) and plain value trees, and the exception mapping that
lets ``Conflict`` (with its keys, including ``LengthPredicate``),
``NotFound``, ``SnapshotTooOld`` etc. propagate across the socket.
"""
from __future__ import annotations

import dataclasses
import struct
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.types import (
    Conflict,
    Exists,
    LengthPredicate,
    NotFound,
    PredicateKind,
    ReadRecord,
    TxnStateError,
    WriteRecord,
)

# --------------------------------------------------------------------------- #
# protocol constants
# --------------------------------------------------------------------------- #
MAGIC = 0xF5
VERSION = 3  # v3: fetch_meta(s) replies carry (ver, length, exists, kind, mtime_ts)
_HEADER = struct.Struct(">BBBBII")
HEADER_LEN = _HEADER.size

#: header FLAGS bit: a 16-byte (trace_id, span_id) envelope follows the
#: header; the frame is part of a sampled trace
FLAG_TRACE = 0x01
_TRACE = struct.Struct(">QQ")
TRACE_LEN = _TRACE.size

#: header FLAGS bit: a 4-byte BE shard-map version envelope follows the
#: header (after the trace envelope when both are set). Cluster
#: coordinators stamp it on every reply, epoch-style, so a client
#: learns its routing map went stale without an extra round trip.
FLAG_MAPV = 0x02
_MAPV = struct.Struct(">I")
MAPV_LEN = _MAPV.size

# responses
T_HELLO = 0x01
T_OK = 0x02
T_ERR = 0x03
# requests (scalar, v1 heritage)
T_BEGIN = 0x10
T_SYNC_FILE = 0x11
T_FETCH_BLOCK = 0x12
T_FETCH_META = 0x13
T_LOOKUP = 0x14
T_LISTDIR = 0x15
T_COMMIT = 0x16
T_ALLOC_RANGE = 0x17
T_STATS = 0x18
T_LATEST_TS = 0x19
T_PING = 0x1A
# requests (batch, new in v2 — one frame, one reply, many items)
T_FETCH_BLOCKS = 0x20
T_FETCH_METAS = 0x21
T_LOOKUP_MANY = 0x22
T_SYNC_FILES = 0x23
# admin (v3): force a WAL checkpoint + compaction cycle; replies with the
# summary {seg, bytes, segments_removed}
T_CHECKPOINT = 0x24
# admin: dump the server's span ring buffer + slow-op log
# ({"spans": [...], "slow": [...]}); body {"clear": bool}
T_TRACE_DUMP = 0x25
# cluster (v3 shard scale-out) -------------------------------------------
# authenticate the connection for admin ops; body {"token": str}
T_AUTH = 0x26
# fetch the coordinator's current versioned ShardMap; body {}
T_SHARDMAP = 0x27
# 2PC participant ops (coordinator -> shard server)
T_PREPARE = 0x28
T_DECIDE = 0x29
# in-doubt resolution (shard server -> coordinator); body {"txid": [e, n]}
T_RESOLVE = 0x2A
# live rebalancing (coordinator -> shard server)
T_MIG_EXPORT = 0x2B
T_MIG_IMPORT = 0x2C
T_MIG_DROP = 0x2D
T_MIG_ABORT = 0x2E
# admin: trigger a slot migration on the coordinator
T_REBALANCE = 0x2F
# shard status probe: owned slots, applied ts, in-doubt txids, digests
T_SHARD_STATUS = 0x30
# lease tier (v3 cache coherence) ----------------------------------------
# acquire read leases; body {"f": [fid, ...], "m": "inv"|"push"} ->
# {"e": server_epoch, "ttl": ttl_s, "g": [fid, ...]} (granted subset)
T_LEASE = 0x31
# drop leases early; body {"f": [fid, ...]} -> {"r": n_released}
T_LEASE_RELEASE = 0x32
# server -> client push (request id 0): a commit touched leased files;
# body {"e": epoch, "f": [fid, ...], "n": [path, ...], "t": commit_ts,
# "us": server monotonic micros at send}
T_INVALIDATE = 0x33
# server -> client push (request id 0): T_INVALIDATE plus the committed
# block contents for the holder's leased files; body
# {"e": epoch, "f": [fid, ...], "n": [path, ...],
#  "b": {(fid, blk_idx): [ver, bytes]}, "t": commit_ts, "us": micros}
T_PUSH_VERSION = 0x34

#: human-readable op names for metrics/span labels (obs.py consumers
#: pre-bind label children from this table at import time)
MSG_NAMES = {
    T_HELLO: "hello", T_OK: "ok", T_ERR: "err",
    T_BEGIN: "begin", T_SYNC_FILE: "sync_file",
    T_FETCH_BLOCK: "fetch_block", T_FETCH_META: "fetch_meta",
    T_LOOKUP: "lookup", T_LISTDIR: "listdir", T_COMMIT: "commit",
    T_ALLOC_RANGE: "alloc_range", T_STATS: "stats",
    T_LATEST_TS: "latest_ts", T_PING: "ping",
    T_FETCH_BLOCKS: "fetch_blocks", T_FETCH_METAS: "fetch_metas",
    T_LOOKUP_MANY: "lookup_many", T_SYNC_FILES: "sync_files",
    T_CHECKPOINT: "checkpoint", T_TRACE_DUMP: "trace_dump",
    T_AUTH: "auth", T_SHARDMAP: "shardmap",
    T_PREPARE: "prepare", T_DECIDE: "decide", T_RESOLVE: "resolve",
    T_MIG_EXPORT: "mig_export", T_MIG_IMPORT: "mig_import",
    T_MIG_DROP: "mig_drop", T_MIG_ABORT: "mig_abort",
    T_REBALANCE: "rebalance", T_SHARD_STATUS: "shard_status",
    T_LEASE: "lease", T_LEASE_RELEASE: "lease_release",
    T_INVALIDATE: "invalidate", T_PUSH_VERSION: "push_version",
}

#: max body we will accept from a peer (a frame claiming more is corrupt)
MAX_BODY = 256 * 1024 * 1024

_EXT_TUPLE = 1

#: bytes payloads at least this large ride as their own scatter-gather
#: segment in a SendQueue instead of being copied into the frame buffer
SPILL_MIN = 2048


class WireError(Exception):
    """Malformed frame / codec bytes, or a protocol violation."""


class ConnectionClosed(WireError):
    """Peer closed the socket mid-conversation."""


class StaleEpoch(Exception):
    """A fenced request carried an epoch older than the server's current
    one (the server restarted since the client's lease was granted)."""


class StaleShardMap(Exception):
    """The request was routed with an out-of-date ShardMap: the target
    no longer owns the key range (slot migrated or frozen). The client
    must refetch the map from the coordinator and retry — the cluster
    analogue of ``StaleEpoch``."""


class PermissionDenied(Exception):
    """An admin-gated op (checkpoint, trace dump, rebalance, 2PC
    participant ops) was attempted on a connection that has not
    authenticated with the server's ``--admin-token``."""


class RemoteError(Exception):
    """Server-side exception of a type the client does not know."""


# --------------------------------------------------------------------------- #
# codec: pack
# --------------------------------------------------------------------------- #
def _pack_into(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_bin_header(len(b), out)
        out += b
    elif isinstance(obj, tuple):
        # ext type 1: payload is the packed element array
        inner = bytearray()
        _pack_array(obj, inner)
        n = len(inner)
        if n <= 0xFF:
            out += bytes((0xC7, n, _EXT_TUPLE))
        elif n <= 0xFFFF:
            out.append(0xC8)
            out += struct.pack(">H", n)
            out.append(_EXT_TUPLE)
        else:
            out.append(0xC9)
            out += struct.pack(">I", n)
            out.append(_EXT_TUPLE)
        out += inner
    elif isinstance(obj, list):
        _pack_array(obj, out)
    elif isinstance(obj, dict):
        _pack_map_header(len(obj), out)
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise WireError(f"unpackable type {type(obj).__name__}")


def _pack_bin_header(n: int, out: bytearray) -> None:
    if n <= 0xFF:
        out += bytes((0xC4, n))
    elif n <= 0xFFFF:
        out.append(0xC5)
        out += struct.pack(">H", n)
    else:
        out.append(0xC6)
        out += struct.pack(">I", n)


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 < v:
        if v <= 0xFF:
            out += bytes((0xCC, v))
        elif v <= 0xFFFF:
            out.append(0xCD)
            out += struct.pack(">H", v)
        elif v <= 0xFFFFFFFF:
            out.append(0xCE)
            out += struct.pack(">I", v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(0xCF)
            out += struct.pack(">Q", v)
        else:
            raise WireError(f"int too large for wire: {v}")
    else:
        if v >= -0x80:
            out.append(0xD0)
            out += struct.pack(">b", v)
        elif v >= -0x8000:
            out.append(0xD1)
            out += struct.pack(">h", v)
        elif v >= -0x80000000:
            out.append(0xD2)
            out += struct.pack(">i", v)
        elif v >= -0x8000000000000000:
            out.append(0xD3)
            out += struct.pack(">q", v)
        else:
            raise WireError(f"int too small for wire: {v}")


def _pack_array_header(n: int, out: bytearray) -> None:
    if n <= 15:
        out.append(0x90 | n)
    elif n <= 0xFFFF:
        out.append(0xDC)
        out += struct.pack(">H", n)
    else:
        out.append(0xDD)
        out += struct.pack(">I", n)


def _pack_map_header(n: int, out: bytearray) -> None:
    if n <= 15:
        out.append(0x80 | n)
    elif n <= 0xFFFF:
        out.append(0xDE)
        out += struct.pack(">H", n)
    else:
        out.append(0xDF)
        out += struct.pack(">I", n)


def _pack_array(seq, out: bytearray) -> None:
    _pack_array_header(len(seq), out)
    for item in seq:
        _pack_into(item, out)


def pack(obj: Any) -> bytes:
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


# --------------------------------------------------------------------------- #
# codec: unpack
# --------------------------------------------------------------------------- #
def _need(buf, off: int, n: int) -> None:
    if off + n > len(buf):
        raise WireError("truncated codec bytes")


def _unpack_from(buf, off: int, stats=None, sink=None) -> Tuple[Any, int]:
    _need(buf, off, 1)
    tag = buf[off]
    off += 1
    if tag <= 0x7F:                      # positive fixint
        return tag, off
    if tag >= 0xE0:                      # negative fixint
        return tag - 0x100, off
    if 0x80 <= tag <= 0x8F:              # fixmap
        return _unpack_map(buf, off, tag & 0x0F, stats, sink)
    if 0x90 <= tag <= 0x9F:              # fixarray
        return _unpack_list(buf, off, tag & 0x0F, stats, sink)
    if 0xA0 <= tag <= 0xBF:              # fixstr
        n = tag & 0x1F
        _need(buf, off, n)
        return bytes(buf[off : off + n]).decode("utf-8"), off + n
    if tag == 0xC0:
        return None, off
    if tag == 0xC2:
        return False, off
    if tag == 0xC3:
        return True, off
    if tag in (0xC4, 0xC5, 0xC6):        # bin
        n, off = _unpack_len(buf, off, tag - 0xC4)
        _need(buf, off, n)
        if sink is not None:
            dst = sink(n)
            if dst is not None:
                dst[:] = buf[off : off + n]
                if stats is not None and len(stats) > 1:
                    stats[1] += n
                return dst, off + n
        if stats is not None:
            stats[0] += n
        return bytes(buf[off : off + n]), off + n
    if tag in (0xC7, 0xC8, 0xC9):        # ext
        n, off = _unpack_len(buf, off, tag - 0xC7)
        _need(buf, off, 1)
        ext_type = buf[off]
        off += 1
        _need(buf, off, n)
        if ext_type != _EXT_TUPLE:
            raise WireError(f"unknown ext type {ext_type}")
        inner, ioff = _unpack_from(buf, off, stats, sink)
        if ioff != off + n or not isinstance(inner, list):
            raise WireError("malformed tuple ext payload")
        return tuple(inner), off + n
    if tag == 0xCB:
        _need(buf, off, 8)
        return struct.unpack_from(">d", buf, off)[0], off + 8
    if tag == 0xCC:
        _need(buf, off, 1)
        return buf[off], off + 1
    if tag == 0xCD:
        _need(buf, off, 2)
        return struct.unpack_from(">H", buf, off)[0], off + 2
    if tag == 0xCE:
        _need(buf, off, 4)
        return struct.unpack_from(">I", buf, off)[0], off + 4
    if tag == 0xCF:
        _need(buf, off, 8)
        return struct.unpack_from(">Q", buf, off)[0], off + 8
    if tag == 0xD0:
        _need(buf, off, 1)
        return struct.unpack_from(">b", buf, off)[0], off + 1
    if tag == 0xD1:
        _need(buf, off, 2)
        return struct.unpack_from(">h", buf, off)[0], off + 2
    if tag == 0xD2:
        _need(buf, off, 4)
        return struct.unpack_from(">i", buf, off)[0], off + 4
    if tag == 0xD3:
        _need(buf, off, 8)
        return struct.unpack_from(">q", buf, off)[0], off + 8
    if tag in (0xD9, 0xDA, 0xDB):        # str8/16/32
        n, off = _unpack_len(buf, off, tag - 0xD9)
        _need(buf, off, n)
        return bytes(buf[off : off + n]).decode("utf-8"), off + n
    if tag == 0xDC:
        _need(buf, off, 2)
        n = struct.unpack_from(">H", buf, off)[0]
        return _unpack_list(buf, off + 2, n, stats, sink)
    if tag == 0xDD:
        _need(buf, off, 4)
        n = struct.unpack_from(">I", buf, off)[0]
        return _unpack_list(buf, off + 4, n, stats, sink)
    if tag == 0xDE:
        _need(buf, off, 2)
        n = struct.unpack_from(">H", buf, off)[0]
        return _unpack_map(buf, off + 2, n, stats, sink)
    if tag == 0xDF:
        _need(buf, off, 4)
        n = struct.unpack_from(">I", buf, off)[0]
        return _unpack_map(buf, off + 4, n, stats, sink)
    raise WireError(f"unknown codec tag 0x{tag:02x}")


def _unpack_len(buf, off: int, width_idx: int) -> Tuple[int, int]:
    if width_idx == 0:
        _need(buf, off, 1)
        return buf[off], off + 1
    if width_idx == 1:
        _need(buf, off, 2)
        return struct.unpack_from(">H", buf, off)[0], off + 2
    _need(buf, off, 4)
    return struct.unpack_from(">I", buf, off)[0], off + 4


def _unpack_list(buf, off: int, n: int, stats=None, sink=None) -> Tuple[List[Any], int]:
    out = []
    for _ in range(n):
        v, off = _unpack_from(buf, off, stats, sink)
        out.append(v)
    return out, off


def _unpack_map(buf, off: int, n: int, stats=None, sink=None) -> Tuple[Dict[Any, Any], int]:
    out: Dict[Any, Any] = {}
    for _ in range(n):
        k, off = _unpack_from(buf, off, stats, sink)
        v, off = _unpack_from(buf, off, stats, sink)
        out[k] = v
    return out, off


def unpack(data: bytes) -> Any:
    obj, off = _unpack_from(memoryview(data), 0)
    if off != len(data):
        raise WireError(f"{len(data) - off} trailing byte(s) after value")
    return obj


# --------------------------------------------------------------------------- #
# frames
# --------------------------------------------------------------------------- #
_HDR_PAD = bytes(HEADER_LEN)


def encode_frame_into(out: bytearray, msg_type: int, obj: Any,
                      req_id: int = 0,
                      trace: Optional[Tuple[int, int]] = None) -> int:
    """Append one frame to ``out`` without intermediate allocations:
    reserve the header, pack the body in place, then patch the header
    with the measured body length. ``trace`` attaches a sampled
    ``(trace_id, span_id)`` envelope. Returns the frame length."""
    hdr_at = len(out)
    out += _HDR_PAD
    flags = 0
    if trace is not None:
        out += _TRACE.pack(trace[0], trace[1])
        flags = FLAG_TRACE
    body_at = len(out)
    _pack_into(obj, out)
    body_len = len(out) - body_at
    _HEADER.pack_into(out, hdr_at, MAGIC, VERSION, msg_type, flags,
                      req_id, body_len)
    return len(out) - hdr_at


def encode_frame(msg_type: int, obj: Any, req_id: int = 0,
                 trace: Optional[Tuple[int, int]] = None) -> bytes:
    out = bytearray()
    encode_frame_into(out, msg_type, obj, req_id, trace)
    return bytes(out)


def decode_header_ex(hdr, off: int = 0) -> Tuple[int, int, int, int]:
    """(msg_type, req_id, body_len, flags); raises WireError on bad
    magic/version. Accepts bytes or a memoryview, with an optional
    offset, so callers can decode in place without slicing a copy."""
    magic, version, msg_type, flags, req_id, body_len = \
        _HEADER.unpack_from(hdr, off)
    if magic != MAGIC:
        raise WireError(f"bad magic 0x{magic:02x}")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version}")
    if body_len > MAX_BODY:
        raise WireError(f"frame body too large ({body_len} bytes)")
    return msg_type, req_id, body_len, flags


def decode_header(hdr, off: int = 0) -> Tuple[int, int, int]:
    """(msg_type, req_id, body_len) — the v2-shaped view; flags (and
    the trace envelope they announce) are handled by the callers that
    opt in via ``decode_header_ex``."""
    return decode_header_ex(hdr, off)[:3]


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionClosed("socket closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def send_frame(sock, msg_type: int, obj: Any, req_id: int = 0) -> None:
    sock.sendall(encode_frame(msg_type, obj, req_id))


def recv_frame(sock) -> Tuple[int, int, Any]:
    msg_type, req_id, body_len, flags = \
        decode_header_ex(_recv_exact(sock, HEADER_LEN))
    if flags & FLAG_TRACE:
        _recv_exact(sock, TRACE_LEN)
    if flags & FLAG_MAPV:
        _recv_exact(sock, MAPV_LEN)
    body = _recv_exact(sock, body_len) if body_len else b""
    return msg_type, req_id, unpack(body)


class FrameReader:
    """Zero-copy buffered frame parser over a socket.

    Pipelined peers put many small frames on the wire back-to-back; one
    ``recv_into`` here can pull dozens of them into the rolling buffer,
    and the parser then hands them out without another syscall (or
    another GIL hand-off — on a busy multiplexed connection the
    scheduling churn, not the copy, is what batching amortizes).

    Frames are decoded *in place*: the header via ``decode_header`` on a
    memoryview and the body via ``_unpack_from`` straight out of the
    buffer, so the only per-frame copies are the payload ``bytes``
    objects the decoded value tree actually hands out (a block payload
    in a ``fetch_blocks`` reply is materialized exactly once, not
    header-copy + body-copy + bin-copy as the old reader did).
    ``frames`` / ``body_bytes`` / ``bytes_copied`` count that:
    copies-per-frame == bytes_copied / body_bytes <= 1.

    ``fill`` accepts recv flags (e.g. ``MSG_DONTWAIT``) and returns
    ``None`` on would-block, which lets non-blocking event loops and
    opportunistic drains share the same reader. ``pending()`` tells a
    server loop whether more complete frames are already buffered, which
    is the signal for coalescing replies before flushing."""

    __slots__ = ("sock", "_buf", "_head", "_tail", "frames",
                 "body_bytes", "_stats", "_sinks", "last_trace",
                 "last_mapv")

    INIT_BUF = 1 << 16
    SHRINK_ABOVE = 4 << 20

    def __init__(self, sock=None):
        self.sock = sock
        self._buf = bytearray(self.INIT_BUF)
        self._head = 0
        self._tail = 0
        self.frames = 0
        self.body_bytes = 0
        self._stats = [0, 0]
        #: req_id -> sink callable for the NEXT frame carrying that id.
        #: A sink receives each bin payload length and may return a
        #: writable memoryview of exactly that length (payload lands
        #: there, no bytes object is built) or None (normal copy-out).
        self._sinks: Dict[int, Any] = {}
        #: (trace_id, span_id) from the last frame's envelope, or None
        self.last_trace: Optional[Tuple[int, int]] = None
        #: highest shard-map version any frame has advertised, or None
        self.last_mapv: Optional[int] = None

    @property
    def bytes_copied(self) -> int:
        """Payload (bin) bytes materialized out of the buffer."""
        return self._stats[0]

    @property
    def bytes_sunk(self) -> int:
        """Payload (bin) bytes decoded straight into caller-provided
        destinations (arena / tensor memory) instead of fresh ``bytes``
        objects — the zero-copy half of the counter discipline."""
        return self._stats[1]

    def set_sink(self, req_id: int, sink) -> None:
        """Arm ``sink`` for the next frame whose header carries
        ``req_id``. Consumed by that one frame; the caller must re-arm
        per request. Sinks do not survive reader replacement (redial):
        callers fall back to the plain-bytes path automatically."""
        self._sinks[req_id] = sink

    def clear_sink(self, req_id: int) -> None:
        self._sinks.pop(req_id, None)

    def _reclaim(self) -> None:
        buf = self._buf
        avail = self._tail - self._head
        if self._head:
            buf[:avail] = buf[self._head:self._tail]
            self._head, self._tail = 0, avail
        if len(buf) - self._tail < (1 << 16):
            buf += bytes(max(len(buf), 1 << 16))

    def fill(self, flags: int = 0) -> Optional[int]:
        """recv_into the buffer. Returns the byte count (0 == EOF) or
        ``None`` if ``flags`` made the call would-block."""
        if self._head == self._tail:
            self._head = self._tail = 0
            if len(self._buf) > self.SHRINK_ABOVE:
                self._buf = bytearray(self.INIT_BUF)
        if len(self._buf) - self._tail < 4096:
            self._reclaim()
        view = memoryview(self._buf)[self._tail:]
        try:
            n = self.sock.recv_into(view, 0, flags)
        except (BlockingIOError, InterruptedError):
            return None
        finally:
            view.release()
        self._tail += n
        return n

    def next_frame(self) -> Optional[Tuple[int, int, Any]]:
        """Parse one complete frame from the buffer, or ``None`` if a
        full frame has not arrived yet. No syscalls."""
        head = self._head
        avail = self._tail - head
        if avail < HEADER_LEN:
            return None
        mv = memoryview(self._buf)
        try:
            msg_type, req_id, body_len, flags = decode_header_ex(mv, head)
            body_at = head + HEADER_LEN
            env_len = (TRACE_LEN if flags & FLAG_TRACE else 0) \
                + (MAPV_LEN if flags & FLAG_MAPV else 0)
            if avail < HEADER_LEN + env_len:
                return None
            trace = None
            if flags & FLAG_TRACE:
                trace = _TRACE.unpack_from(mv, body_at)
                body_at += TRACE_LEN
            mapv = None
            if flags & FLAG_MAPV:
                mapv = _MAPV.unpack_from(mv, body_at)[0]
                body_at += MAPV_LEN
            end = body_at + body_len
            if self._tail < end:
                return None
            sink = self._sinks.pop(req_id, None) if self._sinks else None
            obj, off = _unpack_from(mv[:end], body_at, self._stats, sink)
            if off != end:
                raise WireError(
                    f"{end - off} trailing byte(s) after frame body"
                )
        finally:
            mv.release()
        self.last_trace = trace
        if mapv is not None and (self.last_mapv is None
                                 or mapv > self.last_mapv):
            self.last_mapv = mapv
        self._head = end
        if self._head == self._tail:
            self._head = self._tail = 0
        self.frames += 1
        self.body_bytes += body_len
        return msg_type, req_id, obj

    def recv_frame(self) -> Tuple[int, int, Any]:
        while True:
            frame = self.next_frame()
            if frame is not None:
                return frame
            if self.fill() == 0:
                raise ConnectionClosed("socket closed")

    def pending(self) -> bool:
        """A complete frame is already buffered (no syscall needed)."""
        avail = self._tail - self._head
        if avail < HEADER_LEN:
            return False
        _, _, body_len, flags = decode_header_ex(self._buf, self._head)
        need = HEADER_LEN + body_len
        if flags & FLAG_TRACE:
            need += TRACE_LEN
        if flags & FLAG_MAPV:
            need += MAPV_LEN
        return avail >= need


class SendQueue:
    """Scatter-gather output queue for one connection.

    Frames are encoded straight into a pooled ``bytearray`` (via the
    same reserve-header / pack-body / patch-header scheme as
    ``encode_frame_into``), except that large ``bytes`` payloads —
    block data in ``fetch_blocks`` / ``begin`` replies — are NOT copied
    into the buffer: the buffer is closed and the payload object itself
    rides as its own segment. ``flush`` hands the segment list to
    ``socket.sendmsg``, so a burst of replies leaves in one syscall
    with zero copies of the block payloads, and partial sends on a
    non-blocking socket resume at ``_off`` into the head segment."""

    __slots__ = ("segs", "size", "_open", "_spare", "_off")

    IOV_CAP = 64

    def __init__(self):
        self.segs: List[Any] = []
        self.size = 0          # unsent bytes across all segments
        self._open = None      # bytearray currently accepting encodes
        self._spare = None     # drained buffer pooled for reuse
        self._off = 0          # sent offset into segs[0]

    def _cur(self) -> bytearray:
        cur = self._open
        if cur is None:
            cur = self._spare if self._spare is not None else bytearray()
            self._spare = None
            self._open = cur
            self.segs.append(cur)
        return cur

    def put_frame(self, msg_type: int, obj: Any, req_id: int = 0,
                  mapv: Optional[int] = None) -> None:
        hdr_buf = self._cur()
        hdr_at = len(hdr_buf)
        hdr_buf += _HDR_PAD
        self.size += HEADER_LEN
        flags = 0
        if mapv is not None:
            hdr_buf += _MAPV.pack(mapv)
            self.size += MAPV_LEN
            flags = FLAG_MAPV
        size0 = self.size
        self._pack(obj)
        _HEADER.pack_into(hdr_buf, hdr_at, MAGIC, VERSION, msg_type, flags,
                          req_id, self.size - size0)

    def _pack(self, obj: Any) -> None:
        if isinstance(obj, (bytes, bytearray, memoryview)) \
                and len(obj) >= SPILL_MIN:
            cur = self._cur()
            n0 = len(cur)
            _pack_bin_header(len(obj), cur)
            payload = obj if type(obj) is bytes else bytes(obj)
            self.size += len(cur) - n0 + len(payload)
            self._open = None
            self.segs.append(payload)
        elif type(obj) is list:
            cur = self._cur()
            n0 = len(cur)
            _pack_array_header(len(obj), cur)
            self.size += len(cur) - n0
            for item in obj:
                self._pack(item)
        elif type(obj) is dict:
            cur = self._cur()
            n0 = len(cur)
            _pack_map_header(len(obj), cur)
            self.size += len(cur) - n0
            for k, v in obj.items():
                self._pack(k)
                self._pack(v)
        else:
            cur = self._cur()
            n0 = len(cur)
            _pack_into(obj, cur)
            self.size += len(cur) - n0

    def flush(self, sock) -> bool:
        """Send as much as the socket accepts without blocking; returns
        True when the queue fully drained."""
        while self.size:
            iov = []
            off = self._off
            for seg in self.segs[:self.IOV_CAP]:
                iov.append(memoryview(seg)[off:] if off else seg)
                off = 0
            try:
                n = sock.sendmsg(iov)
            except (BlockingIOError, InterruptedError):
                return False
            finally:
                for v in iov:
                    if isinstance(v, memoryview):
                        v.release()
            if n <= 0:
                return False
            self.size -= n
            self._advance(n)
        return True

    def _advance(self, n: int) -> None:
        while n:
            seg = self.segs[0]
            rem = len(seg) - self._off
            if n < rem:
                self._off += n
                return
            n -= rem
            self.segs.pop(0)
            self._off = 0
            if seg is self._open:
                self._open = None
                del seg[:]
                self._spare = seg


# --------------------------------------------------------------------------- #
# dataclass <-> value-tree conversions
# --------------------------------------------------------------------------- #
def payload_to_obj(p) -> Dict[str, Any]:
    return {
        "rt": p.read_ts,
        "r": [(r.key, r.version) for r in p.reads],
        "w": [(w.key, [tuple(pt) for pt in w.patches]) for w in p.writes],
        "p": [(pr.file_id, pr.kind.value, pr.value) for pr in p.predicates],
        "mu": dict(p.meta_updates),
        "nu": dict(p.name_updates),
        "nr": dict(p.name_reads),
        "mr": dict(p.meta_reads),
        "ro": p.read_only,
    }


def payload_from_obj(o: Dict[str, Any]):
    from repro_torch.core.backend import TxnPayload  # avoid import cycle at top

    return TxnPayload(
        read_ts=o["rt"],
        reads=[ReadRecord(tuple(k), v) for k, v in o["r"]],
        writes=[
            WriteRecord(tuple(k), [tuple(pt) for pt in pts])
            for k, pts in o["w"]
        ],
        predicates=[
            LengthPredicate(fid, PredicateKind(kind), val)
            for fid, kind, val in o["p"]
        ],
        meta_updates=dict(o["mu"]),
        name_updates=dict(o["nu"]),
        name_reads=dict(o["nr"]),
        meta_reads=dict(o["mr"]),
        read_only=o["ro"],
    )


def begin_reply_to_obj(r) -> Dict[str, Any]:
    # "u" values are lists, not tuples: a SendQueue packs lists
    # incrementally, so a large pushed block rides as its own
    # scatter-gather segment instead of being copied (tuples travel in
    # an ext envelope whose length must be known upfront). The decoder
    # accepts either shape.
    return {
        "rt": r.read_ts,
        "u": {k: [ts, data] for k, (ts, data) in r.updates.items()},
        "i": list(r.invalidations),
        "fi": list(r.file_invalidations),
    }


def begin_reply_from_obj(o: Dict[str, Any]):
    from repro_torch.core.backend import BeginReply

    return BeginReply(
        read_ts=o["rt"],
        updates={tuple(k): (ts, data) for k, (ts, data) in o["u"].items()},
        invalidations=[tuple(k) for k in o["i"]],
        file_invalidations=list(o["fi"]),
    )


def commit_reply_to_obj(r) -> Dict[str, Any]:
    o = {"ts": r.ts, "bv": dict(r.block_versions)}
    slot_ts = getattr(r, "slot_ts", None)
    if slot_ts:
        # per-slot commit timestamps, so a cluster coordinator proxying
        # the commit can advance its applied-vector floor (absent for
        # plain backends — old clients never see the key)
        o["st"] = dict(slot_ts)
    return o


def commit_reply_from_obj(o: Dict[str, Any]):
    from repro_torch.core.api import CommitReply

    return CommitReply(
        ts=o["ts"], block_versions={tuple(k): v for k, v in o["bv"].items()},
        slot_ts={int(k): v for k, v in (o.get("st") or {}).items()},
    )


def metas_to_obj(entries) -> List[Any]:
    """Batch fetch_metas reply: None (never seen) or
    (ver, length, exists, kind, mtime_ts) — kind and the mtime commit
    timestamp travel with the meta so stat is honest over the wire."""
    return [
        None
        if e is None
        else (e[0], e[1].length, e[1].exists, e[1].kind, e[1].mtime_ts)
        for e in entries
    ]


def metas_from_obj(obj) -> List[Any]:
    from repro_torch.core.blockstore import FileMeta  # avoid import cycle at top

    return [
        None if e is None else (e[0], FileMeta(e[1], e[2], e[3], e[4]))
        for e in obj
    ]


def stats_to_obj(stats) -> Dict[str, Any]:
    d = asdict(stats)
    extra = getattr(stats, "extra", None)
    if extra:
        d.update(extra)
    return d


def stats_from_obj(o: Dict[str, Any]):
    """Forward-compatible: keys a newer server sends that this client's
    ``BackendStats`` does not know are kept on ``stats.extra`` (and
    ``stats_to_obj`` merges them back), instead of crashing the scrape.
    That is what lets an old client read a new server's T_STATS reply —
    e.g. the ``metrics`` registry snapshot rides as an extra key."""
    from repro_torch.core.backend import BackendStats

    known = {f.name for f in dataclasses.fields(BackendStats)}
    s = BackendStats(**{k: v for k, v in o.items() if k in known})
    extra = {k: v for k, v in o.items() if k not in known}
    if extra:
        s.extra = extra
    return s


# --------------------------------------------------------------------------- #
# exceptions over the wire
# --------------------------------------------------------------------------- #
def _conflict_keys_to_obj(keys) -> List[Any]:
    out: List[Any] = []
    for item in keys:
        try:
            tag, detail = item
        except (TypeError, ValueError):
            out.append(("opaque", repr(item)))
            continue
        if isinstance(detail, LengthPredicate):
            detail = (detail.file_id, detail.kind.value, detail.value)
            tag = "predicate"
        out.append((tag, detail))
    return out


def _conflict_keys_from_obj(obj) -> List[Any]:
    out: List[Any] = []
    for tag, detail in obj:
        if tag == "predicate":
            fid, kind, val = detail
            detail = LengthPredicate(fid, PredicateKind(kind), val)
        out.append((tag, detail))
    return out


def _conflict_detail_to_obj(detail) -> List[Any]:
    # explainability entries are flat dicts of wire-safe scalars/tuples
    # ({"tag","key","shard","winner"}); pass through with a repr guard
    out: List[Any] = []
    for d in detail:
        try:
            out.append({str(k): v if isinstance(
                v, (int, str, tuple, bytes, type(None))) else repr(v)
                for k, v in d.items()})
        except AttributeError:
            out.append({"tag": "opaque", "key": repr(d)})
    return out


def exception_to_obj(exc: BaseException) -> Dict[str, Any]:
    extra = None
    if isinstance(exc, Conflict):
        extra = _conflict_keys_to_obj(exc.keys)
        detail = getattr(exc, "detail", None)
        if detail:
            extra = {"k": extra, "d": _conflict_detail_to_obj(detail)}
    return {"t": type(exc).__name__, "m": str(exc), "x": extra}


def exception_from_obj(o: Dict[str, Any]) -> BaseException:
    from repro_torch.core.blockstore import SnapshotTooOld
    from repro_torch.core.wal import WalFailed

    etype, msg, extra = o["t"], o["m"], o["x"]
    if etype == "Conflict":
        detail = None
        if isinstance(extra, dict):        # enriched envelope (PR 7+)
            detail = [
                {k: tuple(v) if isinstance(v, list) else v
                 for k, v in d.items()}
                for d in extra.get("d") or []
            ]
            extra = extra.get("k")
        return Conflict(msg, _conflict_keys_from_obj(extra or []),
                        detail=detail)
    table = {
        "NotFound": NotFound,
        "Exists": Exists,
        "TxnStateError": TxnStateError,
        "SnapshotTooOld": SnapshotTooOld,
        "StaleEpoch": StaleEpoch,
        "StaleShardMap": StaleShardMap,
        "PermissionDenied": PermissionDenied,
        # a poisoned durable log: the commit was NOT acked and the server
        # will fail every further commit until it restarts and recovers
        "WalFailed": WalFailed,
        "ValueError": ValueError,
        "KeyError": KeyError,
    }
    cls = table.get(etype)
    if cls is not None:
        return cls(msg)
    return RemoteError(f"{etype}: {msg}")
