"""TensorState: pytrees as FaaSFS files — the ML adaptation of the paper.

Every pytree leaf maps to one file (``<prefix>/<name>/<leaf.path>``) whose
bytes are the raw array data, plus a ``.meta`` JSON file (dtype/shape/tree
structure). Files are block-partitioned by the store, so the paper's
block-granular machinery gives us, for free:

  * **delta checkpointing** — a commit only ships blocks whose bytes
    changed (cf. the paper's fine-grained cache updates vs. NFS whole-file
    invalidation),
  * **snapshot restore** — read-only transactions pin a commit timestamp
    and read a consistent parameter version while training keeps
    committing (the paper's multiversion snapshot reads),
  * **optimistic concurrent writers** — parameter partitions act like the
    paper's TPC-C warehouses: disjoint-block commits interleave without
    locks; conflicting commits abort and retry.

The on-device companion is the ``block_delta`` Pallas kernel, which computes
per-block dirty masks / int8-quantized deltas so only changed blocks cross
the wire (gradient/update compression keyed to block layout).
"""
from __future__ import annotations

import json
import weakref
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.arena import BlockArena, default_arena
from repro_torch.core.posix import FaaSFS, O_CREAT, O_TRUNC
from repro_torch.core.types import TENSOR_BLOCK_BYTES, NotFound

PyTree = Any


def flatten_with_names(tree: PyTree, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """Deterministic (name, leaf) pairs; names are '/'-joined dict paths."""
    out: List[Tuple[str, np.ndarray]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(flatten_with_names(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(flatten_with_names(v, f"{prefix}{i}/"))
    else:
        out.append((prefix.rstrip("/"), np.asarray(tree)))
    return out


def _leaf_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


class TensorStore:
    """Save/load pytrees through a FaaSFS transaction.

    ``arena`` backs the zero-copy restore path (``load(zero_copy=True)``):
    leaf bytes land in pooled writable-once buffers straight off the
    wire and the returned arrays alias the sealed buffers (readonly) —
    see ``docs/mlstate.md`` for the lifetime rules. Buffers are returned
    to the pool automatically when the last array view over them is
    garbage-collected."""

    def __init__(self, fs: FaaSFS, prefix: str = "/mnt/tsfs/state",
                 arena: Optional[BlockArena] = None):
        self.fs = fs
        self.prefix = prefix.rstrip("/")
        self.arena = arena

    # ------------------------------------------------------------------ #
    def _meta_path(self, name: str) -> str:
        return f"{self.prefix}/{name}/.meta"

    def _leaf_path(self, name: str, leaf: str) -> str:
        return f"{self.prefix}/{name}/{leaf}"

    # ------------------------------------------------------------------ #
    def save(
        self,
        name: str,
        tree: PyTree,
        *,
        baseline: Optional[Dict[str, np.ndarray]] = None,
        block_bytes: int = TENSOR_BLOCK_BYTES,
        dirty_blocks: Optional[Dict[str, Iterable[int]]] = None,
    ) -> Dict[str, int]:
        """Write a pytree. With ``baseline`` (previous leaf arrays), only
        blocks whose bytes changed are written — the delta-commit path.

        ``dirty_blocks`` short-circuits the byte-compare: for a leaf
        listed there, ONLY the given block indices are written (exact
        new bytes — the mask is a detector, never a value source), so a
        kernel-computed dirty mask (``compute_block_delta``/``pack_dirty``)
        drives the write set without touching the clean bytes at all.
        Leaves absent from the dict fall back to baseline comparison.

        Returns stats: leaves, bytes_total, bytes_written, blocks_written.
        """
        leaves = flatten_with_names(tree)
        meta = {
            "leaves": [
                {"name": n, "dtype": str(a.dtype), "shape": list(a.shape)}
                for n, a in leaves
            ],
            "block_bytes": block_bytes,
        }
        stats = {"leaves": len(leaves), "bytes_total": 0, "bytes_written": 0,
                 "blocks_written": 0}
        for lname, arr in leaves:
            raw = _leaf_bytes(arr)
            stats["bytes_total"] += len(raw)
            path = self._leaf_path(name, lname)
            fd = self.fs.open(path, O_CREAT)
            mask = dirty_blocks.get(lname) if dirty_blocks else None
            base_raw = None
            if mask is None and baseline is not None and lname in baseline:
                base_raw = _leaf_bytes(baseline[lname])
                if len(base_raw) != len(raw):
                    base_raw = None
            if mask is not None:
                for bi in sorted(set(int(b) for b in mask)):
                    off = bi * block_bytes
                    chunk = raw[off : off + block_bytes]
                    if not chunk:
                        continue
                    self.fs.pwrite(fd, chunk, off)
                    stats["bytes_written"] += len(chunk)
                    stats["blocks_written"] += 1
                self.fs.ftruncate(fd, len(raw))
            elif base_raw is None:
                self.fs.pwrite(fd, raw, 0)
                stats["bytes_written"] += len(raw)
                stats["blocks_written"] += -(-len(raw) // block_bytes)
            else:
                for off in range(0, len(raw), block_bytes):
                    chunk = raw[off : off + block_bytes]
                    if chunk != base_raw[off : off + block_bytes]:
                        self.fs.pwrite(fd, chunk, off)
                        stats["bytes_written"] += len(chunk)
                        stats["blocks_written"] += 1
                self.fs.ftruncate(fd, len(raw))
            self.fs.close(fd)
        mfd = self.fs.open(self._meta_path(name), O_CREAT | O_TRUNC)
        self.fs.write(mfd, json.dumps(meta).encode())
        self.fs.close(mfd)
        return stats

    # ------------------------------------------------------------------ #
    def load(self, name: str, *, zero_copy: bool = False) -> Dict[str, np.ndarray]:
        """Read all leaves as a flat {name: array} dict.

        ``zero_copy=True`` is the arena path: the ``.meta`` layout keys a
        tensor-sized span read per leaf — every block of the leaf goes
        out in ONE ``fetch_blocks`` round trip and each payload lands
        directly in the leaf's arena buffer (no per-block ``bytes``, no
        assembly copy, no ``.copy()``). Returned arrays are READONLY
        views over sealed arena buffers; they stay valid as long as any
        view is alive and the backing buffer is recycled when the last
        one dies. Callers that need to mutate must ``.copy()``."""
        mfd = self.fs.open(self._meta_path(name))
        size = self.fs.fstat(mfd)["st_size"]
        meta = json.loads(self.fs.pread(mfd, size, 0))
        self.fs.close(mfd)
        # tensor-sized readahead: the meta layout names every leaf, so
        # one lookup_many primes the whole checkpoint's name->fid map
        # before any data moves (readdir-free, single round trip)
        paths = [self._leaf_path(name, l["name"]) for l in meta["leaves"]]
        if hasattr(self.fs, "txn"):
            self.fs.txn.lookup_many(paths)
        out: Dict[str, np.ndarray] = {}
        arena = None
        if zero_copy:
            arena = self.arena if self.arena is not None else default_arena()
            txn = self.fs.txn
            sunk0, copied0 = txn.bytes_sunk, txn.bytes_copied_into
        for leaf in meta["leaves"]:
            path = self._leaf_path(name, leaf["name"])
            dt = np.dtype(leaf["dtype"])
            fd = self.fs.open(path)
            n = self.fs.fstat(fd)["st_size"]
            if arena is not None:
                buf = arena.alloc(n, round_to=self.fs.txn.block_size)
                # block-aligned capacity: every block in the span is a
                # full-size sink destination, incl. the ragged tail
                self.fs.pread_into(fd, n, 0, buf.view(0, buf.capacity))
                self.fs.close(fd)
                mv = buf.seal()
                count = int(np.prod(leaf["shape"], dtype=np.int64)) \
                    if leaf["shape"] else 1
                root = np.frombuffer(mv, dtype=dt, count=count)
                # recycle the buffer when the last aliasing view dies:
                # every numpy view of ``root`` keeps ``root`` alive
                # (base chains collapse to the owning array), so this
                # fires only once nothing can read the memory
                weakref.finalize(root, buf.release)
                out[leaf["name"]] = root.reshape(leaf["shape"])
            else:
                raw = self.fs.pread(fd, n, 0)
                self.fs.close(fd)
                out[leaf["name"]] = np.frombuffer(
                    raw, dtype=dt
                ).reshape(leaf["shape"]).copy()
        if arena is not None:
            arena.note_fill(txn.bytes_sunk - sunk0)
            arena.note_copy(txn.bytes_copied_into - copied0)
        return out

    def exists(self, name: str) -> bool:
        return self.fs.exists(self._meta_path(name))


def unflatten_like(template: PyTree, flat: Dict[str, np.ndarray]) -> PyTree:
    """Rebuild a pytree with ``template``'s structure from named leaves."""
    def rebuild(node, prefix: str):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            return type(node)(t)
        key = prefix.rstrip("/")
        if key not in flat:
            raise NotFound(f"leaf {key} missing from stored state")
        return flat[key]

    return rebuild(template, "")
