"""Paged KV-cache manager over the FaaSFS block model.

KV pages are the serving-side twin of the paper's file blocks: fixed-size
(page_tokens) slabs of per-layer K/V state, owned by a free-list allocator,
referenced by per-sequence page tables, and — the FaaSFS twist —
*persistable*: a finished/evicted sequence's pages can be committed to the
block store and re-attached later (prefix reuse across requests, exactly
the cross-invocation cache survival the paper builds on). Committed pages
are read back with snapshot consistency, so a server can re-hydrate a
conversation's KV state while other workers keep committing.

The dense-assembly path (``materialize``) produces the (L, B, S, KV, hd)
layout the jit'd ``decode_step`` consumes; on TPU a paged decode-attention
kernel would read the page table directly (recorded future work).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.posix import FaaSFS, O_CREAT
from repro_torch.core.runtime import InvocationStats, runtime_for


@dataclass
class _Sequence:
    pages: List[int] = field(default_factory=list)
    length: int = 0


class PagedKVCache:
    """Fixed-pool paged allocator for decode KV state (host-side)."""

    def __init__(self, cfg: ModelConfig, *, num_pages: int, page_tokens: int = 16,
                 dtype=np.float32):
        if not cfg.has_attention:
            raise ValueError("paged KV cache requires an attention arch")
        self.cfg = cfg
        self.page_tokens = page_tokens
        self.num_pages = num_pages
        shape = (num_pages, cfg.num_layers, page_tokens, cfg.num_kv_heads, cfg.head_dim)
        self.k_pages = np.zeros(shape, dtype)
        self.v_pages = np.zeros(shape, dtype)
        self._free = list(range(num_pages - 1, -1, -1))
        self._seqs: Dict[str, _Sequence] = {}

    # ------------------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def new_sequence(self, seq_id: str) -> None:
        if seq_id in self._seqs:
            raise KeyError(f"sequence {seq_id} exists")
        self._seqs[seq_id] = _Sequence()

    def length(self, seq_id: str) -> int:
        return self._seqs[seq_id].length

    def _page_for(self, seq: _Sequence, pos: int) -> Tuple[int, int]:
        pi, off = divmod(pos, self.page_tokens)
        while len(seq.pages) <= pi:
            if not self._free:
                raise MemoryError("KV page pool exhausted")
            seq.pages.append(self._free.pop())
        return seq.pages[pi], off

    def append(self, seq_id: str, k: np.ndarray, v: np.ndarray) -> int:
        """Append one token's K/V. k/v: (L, KV, hd). Returns new length."""
        seq = self._seqs[seq_id]
        page, off = self._page_for(seq, seq.length)
        self.k_pages[page, :, off] = k
        self.v_pages[page, :, off] = v
        seq.length += 1
        return seq.length

    def materialize(self, seq_id: str, max_seq: int) -> Tuple[np.ndarray, np.ndarray]:
        """Assemble the dense (L, max_seq, KV, hd) views for decode_step."""
        cfg, seq = self.cfg, self._seqs[seq_id]
        out_shape = (cfg.num_layers, max_seq, cfg.num_kv_heads, cfg.head_dim)
        k = np.zeros(out_shape, self.k_pages.dtype)
        v = np.zeros(out_shape, self.v_pages.dtype)
        for pi, page in enumerate(seq.pages):
            lo = pi * self.page_tokens
            hi = min(lo + self.page_tokens, seq.length, max_seq)
            if hi <= lo:
                break
            k[:, lo:hi] = self.k_pages[page][:, : hi - lo]
            v[:, lo:hi] = self.v_pages[page][:, : hi - lo]
        return k, v

    def release(self, seq_id: str) -> None:
        seq = self._seqs.pop(seq_id)
        self._free.extend(reversed(seq.pages))

    # ------------------------------------------------------------------ #
    # FaaSFS persistence: commit / re-attach sequences across invocations
    # ------------------------------------------------------------------ #
    # ``target`` below is a FunctionRuntime or a bare LocalServer (a
    # cached runtime is built over it) — persistence runs as real FaaS
    # invocations: implicit BEGIN/COMMIT, Conflict restart, and the
    # read-only fast path for attach, over any BackendAPI transport.
    # Layout: ``{prefix}/{seq_id}.len`` (8-byte LE length) plus one
    # ``.p{i}k`` / ``.p{i}v`` file per page — K and V separated so each
    # file maps onto ONE contiguous pool destination and ``attach`` can
    # land page bytes straight off the wire into the pool (zero-copy,
    # counted by ``Transaction.bytes_sunk``).
    def persist(self, target, seq_id: str, *, prefix: str = "/mnt/tsfs/kv") -> int:
        """Commit a sequence's pages atomically; returns commit timestamp."""
        seq = self._seqs[seq_id]
        pages_k = [self.k_pages[p] for p in seq.pages]
        pages_v = [self.v_pages[p] for p in seq.pages]
        inv = InvocationStats()

        def do(fs: FaaSFS) -> None:
            meta = f"{prefix}/{seq_id}.len"
            fd = fs.open(meta, O_CREAT)
            fs.pwrite(fd, int(seq.length).to_bytes(8, "little"), 0)
            fs.close(fd)
            for i, (pk, pv) in enumerate(zip(pages_k, pages_v)):
                fd = fs.open(f"{prefix}/{seq_id}.p{i}k", O_CREAT)
                fs.pwrite(fd, pk.tobytes(), 0)
                fs.close(fd)
                fd = fs.open(f"{prefix}/{seq_id}.p{i}v", O_CREAT)
                fs.pwrite(fd, pv.tobytes(), 0)
                fs.close(fd)

        runtime_for(target).invoke(do, stats=inv)
        return inv.commit_ts

    def attach(self, target, seq_id: str, *, prefix: str = "/mnt/tsfs/kv") -> int:
        """Re-hydrate a persisted sequence (snapshot-consistent read).

        Page bytes are read INTO the pool slabs (``pread_into``): the
        destination of every full block is the ``k_pages``/``v_pages``
        memory itself, so a remote attach performs zero per-block
        payload copies beyond the single wire decode."""
        self.new_sequence(seq_id)
        seq = self._seqs[seq_id]
        page_shape = self.k_pages.shape[1:]
        page_bytes = int(np.prod(page_shape)) * self.k_pages.dtype.itemsize
        holder: Dict[str, int] = {}

        def do(fs: FaaSFS) -> None:
            fd = fs.open(f"{prefix}/{seq_id}.len")
            length = int.from_bytes(fs.pread(fd, 8, 0), "little")
            fs.close(fd)
            holder["length"] = length
            n_pages = -(-length // self.page_tokens)
            for i in range(n_pages):
                # idempotent across Conflict/staleness restarts:
                # _page_for only appends pages the sequence lacks, and a
                # re-run simply overwrites the same pool slabs
                page, _ = self._page_for(seq, i * self.page_tokens)
                for suffix, pool in (("k", self.k_pages), ("v", self.v_pages)):
                    fd = fs.open(f"{prefix}/{seq_id}.p{i}{suffix}")
                    n = fs.fstat(fd)["st_size"]
                    if n != page_bytes:
                        raise ValueError(
                            f"kv page {seq_id}.p{i}{suffix}: {n} bytes, "
                            f"expected {page_bytes}"
                        )
                    fs.pread_into(fd, n, 0, memoryview(pool[page]).cast("B"))
                    fs.close(fd)

        runtime_for(target).invoke(do, read_only=True)
        seq.length = int(holder["length"])
        return seq.length
