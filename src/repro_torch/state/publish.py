"""Publishing a host tree into FaaSFS with one host copy per byte.

``TensorStore.save`` copies every byte several times on its way into the
store: the leaf's ``tobytes``, a slice per block in ``Transaction.write``,
and in the commit ``WriteRecord.apply_to`` (pad, patch, freeze) once in
the backend's apply and once in the client's write-through, over a fresh
zero block for every block never written before.

``PublishStore.publish`` writes what ``TensorStore.save`` writes, byte for
byte and in the same file operations, but builds each whole block once as
an immutable ``bytes`` and hands that object on: its ``WholeBlockWrite``
returns it from ``apply_to`` unchanged, so the transaction, the backend's
block store and the client's cache all hold the same object. A leaf's
ragged last block, and a leaf under one block, takes ``save``'s patch
path. ``PublishBackend``'s block store answers a never-written block with
one shared zero block instead of a fresh one.

The one copy left lands in fresh memory, and first-touch page faults bound
it: on an H100's host ``tobytes`` a block made 0.48-0.52 GB/s. So a whole
block is a ``bytes`` made uninitialised through the C API
(``PyBytes_FromStringAndSize(NULL, n)``, whose buffer the API lets its
creator fill before anyone else sees it) and filled by ``ctypes.memmove``,
which releases the interpreter lock, from a thread a CPU: faults in
different threads proceed in parallel (1.76 GB/s over 8 threads there).

The transaction is the same: one ``FunctionRuntime.invoke`` with its
validation and its retry on ``Conflict`` (a retry builds fresh records),
blind writes installed at the commit's timestamp, older versions kept.
``TensorStore.load`` reads the result.
"""
from __future__ import annotations

import ctypes
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.backend import BackendService
from repro_torch.core.blockstore import BlockStore
from repro_torch.core.posix import FaaSFS, O_CREAT, O_TRUNC
from repro_torch.core.tensorstate import PyTree, TensorStore, flatten_with_names
from repro_torch.core.types import BlockKey, Timestamp, WriteRecord


# private prototypes: the attributes of ``ctypes.pythonapi`` are shared
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_buffer = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))


def _fill(jobs: List[Tuple[bytes, int]]) -> None:
    for blk, src in jobs:
        ctypes.memmove(_bytes_buffer(blk), src, len(blk))


class WholeBlockWrite(WriteRecord):
    """A write record for a block overwritten whole: when its one patch is
    a ``bytes`` of the block's size at offset 0, that object is the new
    block, whatever the base. Any other patch list applies as
    ``WriteRecord``'s.

    The payload stays a real ``bytes``: a later delta publish reads it as
    a base (``base.ljust``) and readers compare blocks as ``bytes``."""

    def apply_to(self, base: bytes, block_size: int) -> bytes:
        if len(self.patches) == 1:
            off, data = self.patches[0]
            if off == 0 and type(data) is bytes and len(data) == block_size:
                return data
        return super().apply_to(base, block_size)


class SharedZeroBlockStore(BlockStore):
    """``BlockStore`` whose never-written block is one shared, immutable
    zero block (version 0) instead of a fresh ``b"\\0" * block_size`` a
    read: the value and the version are ``BlockStore.block``'s."""

    def __init__(self, block_size: int, versions_kept: int = 16):
        super().__init__(block_size, versions_kept)
        self._zero = bytes(block_size)

    def block(self, key: BlockKey,
              ts: Optional[Timestamp] = None) -> Tuple[Timestamp, bytes]:
        with self._lock:
            v = self._blocks.get(key)
            ent = None
            if v is not None and v.versions:
                ent = v.at(ts) if ts is not None else v.current()
            return (0, self._zero) if ent is None else ent


class PublishBackend(BackendService):
    """``BackendService`` over a ``SharedZeroBlockStore``."""

    def __init__(self, block_size: int, **kwargs):
        super().__init__(block_size, **kwargs)
        self.store = SharedZeroBlockStore(block_size, self.store.versions_kept)


class PublishStore(TensorStore):
    """``TensorStore`` with ``publish``, the one-copy writer; ``load``,
    ``exists`` and the file layout are ``TensorStore``'s."""

    def publish(
        self,
        name: str,
        tree: PyTree,
        *,
        dirty_blocks: Optional[Dict[str, Iterable[int]]] = None,
    ) -> Tuple[Dict[str, int], int]:
        """Write ``tree`` as ``TensorStore.save(name, tree,
        block_bytes=<the backend's block size>, dirty_blocks=...)`` does:
        the same files, lengths, ``.meta`` and blocks. A leaf listed in
        ``dirty_blocks`` gets only those blocks and a ``ftruncate`` to its
        length; any other leaf is written whole.

        Returns ``save``'s stats (leaves, bytes_total, bytes_written,
        blocks_written) and how many of the blocks written were handed
        over whole; the rest took the patch path."""
        fs: FaaSFS = self.fs
        txn = fs.txn
        bs = txn.block_size
        leaves = flatten_with_names(tree)
        meta = {
            "leaves": [
                {"name": n, "dtype": str(a.dtype), "shape": list(a.shape)}
                for n, a in leaves
            ],
            "block_bytes": bs,
        }
        stats = {"leaves": len(leaves), "bytes_total": 0, "bytes_written": 0,
                 "blocks_written": 0}
        # each leaf's length, whether it has a mask, and its blocks in write
        # order; the whole ones are filled below
        plan: List[Tuple[int, bool, List[Tuple[int, bytes]]]] = []
        jobs: List[Tuple[bytes, int]] = []
        raws = []
        for lname, arr in leaves:
            raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            raws.append(raw)    # the source stays alive until it is copied
            n = raw.size
            stats["bytes_total"] += n
            mask = dirty_blocks.get(lname) if dirty_blocks else None
            offsets = (range(0, n, bs) if mask is None
                       else [bi * bs for bi in sorted(set(int(b) for b in mask))])
            base = raw.ctypes.data
            leaf = []
            for off in offsets:
                if 0 <= off and off + bs <= n:
                    blk = _new_bytes(None, bs)
                    jobs.append((blk, base + off))
                else:   # ragged, or empty (past the end: written by neither)
                    blk = raw[off : off + bs].tobytes()
                leaf.append((off, blk))
            plan.append((n, mask is not None, leaf))
        threads = min(os.cpu_count() or 1, len(jobs))
        if threads:
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(_fill, [jobs[i::threads] for i in range(threads)]))
        del jobs, raws
        whole = 0
        for (lname, _), (n, masked, leaf) in zip(leaves, plan):
            fd = fs.open(self._leaf_path(name, lname), O_CREAT)
            fid = fs._fd(fd).fid   # not fstat: its length read adds a predicate
            for off, blk in leaf:
                if not blk:
                    continue
                if len(blk) == bs:
                    # CPython's full slice of a bytes is the object itself,
                    # so Transaction.write stores ``blk`` in this record
                    txn.writes[(fid, off // bs)] = WholeBlockWrite((fid, off // bs))
                    whole += 1
                fs.pwrite(fd, blk, off)
                stats["bytes_written"] += len(blk)
                stats["blocks_written"] += 1
            if masked:
                fs.ftruncate(fd, n)
            fs.close(fd)
        mfd = fs.open(self._meta_path(name), O_CREAT | O_TRUNC)
        fs.write(mfd, json.dumps(meta).encode())
        fs.close(mfd)
        return stats, whole
