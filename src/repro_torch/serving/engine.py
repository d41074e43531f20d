"""Snapshot serving: inference replicas on multiversioned parameter state.

A serving replica pins a committed version (the paper's snapshot reads):
requests are served from a consistent parameter snapshot even while training
transactions keep committing. ``refresh()`` advances to the newest committed
version, pulling only changed blocks (fine-grained cache updates) — the
serving-side analogue of delta checkpoint restore.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.runtime import runtime_for
from repro_torch.core.tensorstate import TensorStore, unflatten_like

PyTree = Any


@dataclass
class ServeStats:
    requests: int = 0
    tokens: int = 0
    refreshes: int = 0
    refresh_bytes: int = 0
    wall_s: float = 0.0


class SnapshotServer:
    """Batched decode against a pinned parameter snapshot."""

    def __init__(
        self,
        local: LocalServer,
        decode_fn: Callable[[PyTree, Any], Any],
        template: PyTree,
        *,
        root: str = "/mnt/tsfs/train",
        name: str = "state",
    ):
        self.local = local
        self.decode_fn = decode_fn
        self.template = template
        self.root = root.rstrip("/")
        self.name = name
        self.params: Optional[PyTree] = None
        self.version: int = -1
        self.stats = ServeStats()

    # ------------------------------------------------------------------ #
    def refresh(self) -> int:
        """Load (or delta-update to) the latest committed snapshot."""
        holder: Dict[str, Any] = {}
        before = self.local.misses

        def do_read(fs: FaaSFS) -> None:
            store = TensorStore(fs, prefix=self.root)
            holder["flat"] = store.load(self.name, zero_copy=True)
            holder["ts"] = fs.txn.read_ts

        runtime_for(self.local).invoke(do_read, read_only=True)
        self.params = unflatten_like(self.template, holder["flat"])
        self.version = holder["ts"]
        self.stats.refreshes += 1
        self.stats.refresh_bytes += (
            (self.local.misses - before) * self.local.backend.block_size
        )
        return self.version

    # ------------------------------------------------------------------ #
    def serve(self, batch: Any) -> Any:
        if self.params is None:
            self.refresh()
        t0 = time.perf_counter()
        out = self.decode_fn(self.params, batch)
        self.stats.requests += 1
        self.stats.wall_s += time.perf_counter() - t0
        return out
