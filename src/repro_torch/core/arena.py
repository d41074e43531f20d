"""Shared block arena: pooled, refcounted, writable-once buffers.

The zero-copy tensor path (Faasm-style shared state, see
``docs/mlstate.md``) needs somewhere for block payloads to land that

  * is writable while the transport fills it (``recv_into`` rolling
    buffer -> wire-codec bin sink -> arena memory, one copy total),
  * becomes immutable once handed to the application, so a
    ``jax.numpy``/``numpy`` array built over it with ``frombuffer``
    can never observe a torn refill, and
  * is recycled only when every array over it has dropped its
    reference — releasing pooled memory that a live ndarray still
    aliases is silent corruption, so recycling is explicit and
    refcounted, never implicit.

Lifetime protocol (the aliasing rules, normative):

  1. ``buf = arena.alloc(nbytes)`` — returns a writable-once buffer.
     Capacity is rounded up to ``round_to`` (pass the block size so
     every wire block lands on a full-size destination slice).
  2. Fill via ``buf.view(off, n)`` writable slices (the transport
     sink copies payloads in) or ``buf.write(off, data)`` (counted
     fallback copy).
  3. ``mv = buf.seal()`` — flips the buffer read-only and returns a
     readonly memoryview of the logical ``nbytes``. After seal, every
     ``view()`` raises; the payload can no longer change under a
     reader.
  4. Arrays built over ``mv`` must call ``buf.retain()`` once per
     independent holder (``TensorStore`` does this for you) and
     ``buf.release()`` when done. The last release returns the
     backing memory to the pool for reuse.

Counters extend the transport's ``bytes_copied`` discipline:
``bytes_filled`` is payload landed zero-copy (sink path),
``bytes_copied`` is payload that needed a fallback copy (cache hits,
overlay patches, non-sink backends). The restore-path gate asserts
``bytes_copied == 0`` over the wire kinds.
"""

from __future__ import annotations

import threading
from typing import List, Optional

__all__ = ["ArenaBuffer", "BlockArena", "ArenaError"]


class ArenaError(RuntimeError):
    pass


class ArenaBuffer:
    """One pooled allocation: writable until ``seal()``, then frozen."""

    __slots__ = ("_arena", "_data", "size", "capacity", "_refs",
                 "_sealed", "_mv")

    def __init__(self, arena: "BlockArena", data: bytearray, size: int):
        self._arena = arena
        self._data = data
        self.size = size
        self.capacity = len(data)
        self._refs = 1
        self._sealed = False
        self._mv: Optional[memoryview] = None

    # -- fill phase ------------------------------------------------
    def view(self, off: int, n: int) -> memoryview:
        """Writable destination slice for the transport sink."""
        if self._sealed:
            raise ArenaError("arena buffer is sealed (writable-once)")
        if off < 0 or n < 0 or off + n > self.capacity:
            raise ArenaError("view out of bounds")
        return memoryview(self._data)[off:off + n]

    def write(self, off: int, data) -> int:
        """Counted fallback copy into the buffer (non-sink sources)."""
        n = len(data)
        self.view(off, n)[:] = data
        self._arena.note_copy(n)
        return n

    # -- seal + alias phase ----------------------------------------
    def seal(self) -> memoryview:
        """Freeze and return a readonly view of the logical payload."""
        if not self._sealed:
            self._sealed = True
            self._mv = memoryview(self._data).toreadonly()[:self.size]
        return self._mv

    @property
    def sealed(self) -> bool:
        return self._sealed

    def retain(self) -> "ArenaBuffer":
        if self._refs <= 0:
            raise ArenaError("retain after final release")
        self._refs += 1
        return self

    def release(self) -> None:
        if self._refs <= 0:
            raise ArenaError("double release")
        self._refs -= 1
        if self._refs == 0:
            if self._mv is not None:
                self._mv.release()
                self._mv = None
            data, self._data = self._data, None  # type: ignore[assignment]
            self._arena._recycle(data)


class BlockArena:
    """Pool of reusable backing buffers with zero-copy accounting.

    Thread-safe; one arena is typically shared by every ``TensorStore``
    / ``PagedKVCache`` on a worker (warm-container reuse is the point:
    a restore loop stops allocating after the first iteration)."""

    def __init__(self, max_pooled_bytes: int = 256 << 20):
        self._mu = threading.Lock()
        self._free: List[bytearray] = []
        self._pooled_bytes = 0
        self.max_pooled_bytes = max_pooled_bytes
        # counters (monotonic; read them with snapshots around an op)
        self.allocs = 0
        self.reuses = 0
        self.outstanding = 0
        self.bytes_filled = 0    # payload landed zero-copy (sink)
        self.bytes_copied = 0    # payload needing a fallback copy

    def alloc(self, nbytes: int, round_to: int = 1) -> ArenaBuffer:
        """Writable-once buffer of logical size ``nbytes``; capacity is
        rounded up to a multiple of ``round_to`` so whole-block sink
        destinations exist even for a ragged tail."""
        if nbytes < 0:
            raise ArenaError("negative allocation")
        step = max(1, round_to)
        cap = max(step, ((nbytes + step - 1) // step) * step)
        data = None
        with self._mu:
            for i, cand in enumerate(self._free):
                if len(cand) >= cap:
                    data = self._free.pop(i)
                    self._pooled_bytes -= len(data)
                    self.reuses += 1
                    break
            self.allocs += 1
            self.outstanding += 1
        if data is None:
            data = bytearray(cap)
        return ArenaBuffer(self, data, nbytes)

    def note_fill(self, n: int) -> None:
        with self._mu:
            self.bytes_filled += n

    def note_copy(self, n: int) -> None:
        with self._mu:
            self.bytes_copied += n

    def _recycle(self, data: bytearray) -> None:
        with self._mu:
            self.outstanding -= 1
            if self._pooled_bytes + len(data) <= self.max_pooled_bytes:
                self._free.append(data)
                self._pooled_bytes += len(data)

    def stats(self) -> dict:
        with self._mu:
            return {
                "allocs": self.allocs,
                "reuses": self.reuses,
                "outstanding": self.outstanding,
                "pooled_bytes": self._pooled_bytes,
                "bytes_filled": self.bytes_filled,
                "bytes_copied": self.bytes_copied,
            }


#: process-wide default arena (TensorStore/kvcache share it unless the
#: caller wires their own)
_DEFAULT: Optional[BlockArena] = None
_DEFAULT_MU = threading.Lock()


def default_arena() -> BlockArena:
    global _DEFAULT
    with _DEFAULT_MU:
        if _DEFAULT is None:
            _DEFAULT = BlockArena()
        return _DEFAULT
