"""The "NFS-like" baseline the paper compares against (Figs 4-6).

Semantics modeled after close-to-open-consistency NFS with server-side
locking:

  * every metadata operation and lock acquisition is a *blocking* round
    trip to the server (simulated with a configurable latency),
  * writes go through to the server (write-through on close/fsync),
  * client caches are invalidated at **whole-file granularity** whenever the
    file changes — the exact behavior the paper blames for NFS's 10x TPC-C
    collapse from 1 -> 2 clients ("clients must invalidate an entire cached
    file whenever any part of it changes").

The benchmark harness runs identical workloads over this and over FaaSFS.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class _File:
    data: bytearray
    version: int = 0


class NFSServer:
    """A lock-based shared file server with per-file versioning."""

    def __init__(self, rpc_latency_s: float = 0.0):
        self.rpc_latency_s = rpc_latency_s
        self._files: Dict[str, _File] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._mu = threading.Lock()
        self.rpcs = 0

    def _rpc(self) -> None:
        with self._mu:
            self.rpcs += 1
        if self.rpc_latency_s:
            time.sleep(self.rpc_latency_s)

    def lock(self, path: str) -> None:
        self._rpc()
        with self._mu:
            lk = self._locks.setdefault(path, threading.Lock())
        lk.acquire()

    def unlock(self, path: str) -> None:
        self._rpc()
        self._locks[path].release()

    def getattr(self, path: str) -> Tuple[int, int]:
        self._rpc()
        with self._mu:
            f = self._files.get(path)
            if f is None:
                raise FileNotFoundError(path)
            return len(f.data), f.version

    def create(self, path: str) -> None:
        self._rpc()
        with self._mu:
            self._files.setdefault(path, _File(bytearray()))

    def read_all(self, path: str) -> Tuple[bytes, int]:
        self._rpc()
        with self._mu:
            f = self._files.get(path)
            if f is None:
                raise FileNotFoundError(path)
            return bytes(f.data), f.version

    def write(self, path: str, offset: int, data: bytes) -> int:
        self._rpc()
        with self._mu:
            f = self._files.setdefault(path, _File(bytearray()))
            if len(f.data) < offset + len(data):
                f.data.extend(b"\0" * (offset + len(data) - len(f.data)))
            f.data[offset : offset + len(data)] = data
            f.version += 1
            return f.version

    def exists(self, path: str) -> bool:
        self._rpc()
        with self._mu:
            return path in self._files


class NFSClient:
    """Whole-file caching client with close-to-open consistency."""

    def __init__(self, server: NFSServer):
        self.server = server
        self.cache: Dict[str, Tuple[bytes, int]] = {}
        self.hits = 0
        self.misses = 0

    def open(self, path: str, create: bool = False) -> str:
        if create and not self.server.exists(path):
            self.server.create(path)
        # close-to-open: revalidate on open — whole-file invalidation
        try:
            size, version = self.server.getattr(path)
        except FileNotFoundError:
            if not create:
                raise
            self.server.create(path)
            size, version = self.server.getattr(path)
        ent = self.cache.get(path)
        if ent is None or ent[1] != version:
            self.cache.pop(path, None)
        return path

    def read(self, path: str, offset: int, size: int) -> bytes:
        ent = self.cache.get(path)
        if ent is None:
            data, version = self.server.read_all(path)
            self.cache[path] = (data, version)
            self.misses += 1
        else:
            data = ent[0]
            self.hits += 1
        return data[offset : offset + size]

    def write(self, path: str, offset: int, data: bytes) -> None:
        # write-through; our own cache copy is patched, other clients
        # invalidate the whole file on next open
        version = self.server.write(path, offset, data)
        ent = self.cache.get(path)
        if ent is not None:
            buf = bytearray(ent[0])
            if len(buf) < offset + len(data):
                buf.extend(b"\0" * (offset + len(data) - len(buf)))
            buf[offset : offset + len(data)] = data
            self.cache[path] = (bytes(buf), version)

    def lock(self, path: str) -> None:
        self.server.lock(path)

    def unlock(self, path: str) -> None:
        self.server.unlock(path)
