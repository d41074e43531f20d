"""Transactional, block-granular checkpoints of training state, and the
dirty-block detection they and the trainer use.

Port of ``repro.state.checkpoint``. ``dirty_block_indices`` (reference
``:50-97``) runs on the tensors' device: the block-delta kernel's exact
flag on the card, its plain version on the CPU. ``CheckpointManager``
(reference ``:100-224``) runs on the copied ``FunctionRuntime``: a save is
one transaction and a restore one read-only transaction pinned to a
snapshot; a ``latest`` pointer file is renamed into place.

The reference's delta save has a fault (ROADMAP, Queue 3, item 1): it
writes only the dirty blocks into a NEW ``step_{n}`` directory, so the
clean blocks of that step read back as zeros. Here a delta step also
stores ``.delta``, a JSON record that names the step it was taken against,
that step's save identity, and each leaf's dirty blocks (``null`` for a
leaf written whole), and ``restore`` loads the full step its chain starts
from and overlays each delta's blocks in order, all in the same read-only
transaction. Every save writes a fresh random identity (``.id``, 128 bits)
into its step's directory in the save's own transaction, so a base that
has been saved again since a delta was taken is detected: such a restore
raises ``ValueError`` naming both steps and never mixes two versions of a
step (Queue 3, item 8). A save of a step at or below this manager's last
one is always a full save, so a chain cannot loop (item 9), and the walk
raises on a cycle in a hand-made or older chain. So every committed step
restores bit-identical to what was saved, or raises because a step of
its chain has been replaced since; a delta save still writes only the
dirty blocks' bytes. Checkpoints written without identities restore by
the chain walk alone.
"""
from __future__ import annotations

import json
import secrets
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import flat_tensors
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS, O_CREAT, O_TRUNC
from repro_torch.core.runtime import FunctionRuntime, InvocationStats, runtime_for
from repro_torch.core.tensorstate import TensorStore, unflatten_like
from repro_torch.kernels.block_delta.ops import blockify, compute_block_delta_flat

PyTree = Any


def exact_dirty_blocks(new: torch.Tensor, old: torch.Tensor, block_bytes: int) -> List[int]:
    """Blocks (``block_bytes`` granularity over the raw leaf bytes) where
    the bytes of ``new`` and ``old`` differ, compared on their device."""
    a = new.contiguous().reshape(-1).view(torch.uint8)
    b = old.contiguous().reshape(-1).view(torch.uint8)
    diff = blockify(a != b, block_bytes).any(dim=1)
    return torch.nonzero(diff).flatten().tolist()


def dirty_block_indices(
    new: torch.Tensor,
    old: torch.Tensor,
    block_bytes: int,
) -> Optional[List[int]]:
    """Block indices where ``new`` differs from ``old``; ``None`` means
    "unknown, write conservatively" (shape or dtype changed).

    A float32 leaf at least one block long goes through the block-delta
    kernel (its plain version for CPU tensors), read flat with the ragged
    last block padded inside the kernel, and a block is dirty where the
    kernel's exact flag is set: the bits of some element differ between
    ``new`` and ``old``. Any other leaf gets the exact byte compare. So the
    answer is the byte compare's, ``exact_dirty_blocks`` and the
    reference's default ``impl="auto"``, also where the kernel's norm^2 and
    q see nothing: a zero whose sign flips, a NaN whose payload changes, a
    finite value that becomes NaN (norm^2 NaN, scale 1, q 0), a delta whose
    square underflows. The kernel is only the detector: ``TensorStore.save``
    writes the dirty blocks' exact new bytes, never the lossy int8 delta."""
    if new.dtype != old.dtype or new.shape != old.shape:
        return None
    if new.numel() == 0:
        return []
    if new.dtype == torch.float32 and block_bytes % 4 == 0 \
            and new.numel() >= block_bytes // 4:
        _, _, _, dirty = compute_block_delta_flat(new.reshape(-1), old.reshape(-1),
                                                  block_bytes // 4)
        return torch.nonzero(dirty).flatten().tolist()
    return exact_dirty_blocks(new, old, block_bytes)



@dataclass
class SaveInfo:
    step: int
    commit_ts: int
    bytes_total: int
    bytes_written: int
    blocks_written: int
    wall_s: float
    # per-leaf dirty blocks of a delta save (None: a full save); a leaf
    # whose shape or type changed, or that is new, lists all its blocks
    dirty: Optional[Dict[str, List[int]]] = None
    detect_s: float = 0.0   # dirty detection, synchronized, outside the transaction


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves have no numpy dtype; checkpoint float32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _device_copy(leaf, host: np.ndarray) -> torch.Tensor:
    """The baseline of a leaf: a copy on the leaf's device (the CPU for
    numpy leaves), so later changes to the caller's tensor do not reach it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return torch.from_numpy(np.array(host))


def _read_json(fs: FaaSFS, path: str) -> Optional[Dict]:
    if not fs.exists(path):
        return None
    fd = fs.open(path)
    n = fs.fstat(fd)["st_size"]
    out = json.loads(fs.pread(fd, n, 0))
    fs.close(fd)
    return out


def _write_json(fs: FaaSFS, path: str, obj) -> None:
    fd = fs.open(path, O_CREAT | O_TRUNC)
    fs.write(fd, json.dumps(obj).encode())
    fs.close(fd)


class CheckpointManager:
    """Step-indexed checkpoints with kernel-flagged delta commits and
    snapshot restores, running on ``FunctionRuntime``.

    ``target`` is a ``FunctionRuntime`` or a bare ``LocalServer`` (a cached
    runtime is built over it). ``save`` takes a tree of tensors (on any one
    device) or of numpy arrays; a delta save compares it, block by block,
    with a copy of the last saved tree kept on that device
    (``dirty_block_indices``: the block-delta kernel on the card, its plain
    version on the CPU), once and outside the transaction, as the
    reference does. ``restore`` returns numpy leaves. ``max_staleness_s``
    lets ``latest_step`` / ``restore`` be served from the lease tier's
    bounded-staleness view, as in the reference."""

    def __init__(
        self,
        target,
        root: str = "/mnt/tsfs/ckpt",
        block_bytes: int = 256 * 1024,
        max_staleness_s: Optional[float] = None,
    ):
        if max_staleness_s is not None and not isinstance(target, FunctionRuntime):
            self.runtime = runtime_for(target, max_staleness_s=max_staleness_s)
        else:
            self.runtime = runtime_for(target)
        self.local: LocalServer = self.runtime.local
        self.root = root.rstrip("/")
        self.block_bytes = block_bytes
        self._baseline: Optional[Dict[str, torch.Tensor]] = None
        self._last_step: Optional[int] = None
        self._last_id: Optional[str] = None   # identity of that save

    def _step_dir(self, step: int) -> str:
        return f"{self.root}/step_{step}"

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: PyTree, *, delta_from_last: bool = True) -> SaveInfo:
        """Commit ``state`` as ``step_{step}`` and point ``latest`` at it, in
        one transaction. With ``delta_from_last`` and an earlier save of a
        lower step by this manager, only the blocks that differ from that
        save are written, and the step records its base, the base's save
        identity and the dirty blocks; any other save is full."""
        t0 = time.perf_counter()
        leaves = flat_tensors(state).items()   # any leaves, by their FaaSFS names
        host = {n: _host(leaf) for n, leaf in leaves}
        base = self._baseline if delta_from_last and self._last_step is not None \
            and step > self._last_step else None
        save_id = secrets.token_hex(16)
        current = {n: _device_copy(leaf, host[n]) for n, leaf in leaves}
        dirty: Optional[Dict[str, Optional[List[int]]]] = None
        t_detect = time.perf_counter()
        if base is not None:
            # None: a new leaf, or one whose shape or type changed
            dirty = {n: dirty_block_indices(t, base[n], self.block_bytes) if n in base else None
                     for n, t in current.items()}
            if any(t.is_cuda for t in current.values()):
                torch.cuda.synchronize()
        detect_s = time.perf_counter() - t_detect
        blocks = None
        record = None
        if dirty is not None:
            blocks = {n: idx if idx is not None else
                      list(range(-(-host[n].nbytes // self.block_bytes)))
                      for n, idx in dirty.items()}
            record = {"base": self._last_step, "base_id": self._last_id, "dirty": dirty}
        stats: Dict[str, int] = {}

        def do_save(fs: FaaSFS) -> None:
            stats.clear()
            store = TensorStore(fs, prefix=self.root)
            # a flat {name: array} dict flattens to the same leaf names
            stats.update(store.save(f"step_{step}", host, block_bytes=self.block_bytes,
                                    dirty_blocks=blocks))
            _write_json(fs, f"{self._step_dir(step)}/.id", {"id": save_id})
            delta_path = f"{self._step_dir(step)}/.delta"
            if record is not None:
                _write_json(fs, delta_path, record)
            elif fs.exists(delta_path):
                fs.unlink(delta_path)   # a full save over an older delta step
            # atomically flip the latest pointer (POSIX rename semantics)
            tmp = f"{self.root}/.latest.tmp"
            _write_json(fs, tmp, {"step": step})
            if fs.exists(f"{self.root}/latest"):
                fs.unlink(f"{self.root}/latest")
            fs.rename(tmp, f"{self.root}/latest")

        inv = InvocationStats()
        self.runtime.invoke(do_save, stats=inv)
        self._baseline = current
        self._last_step = step
        self._last_id = save_id
        return SaveInfo(
            step=step,
            commit_ts=inv.commit_ts,
            bytes_total=stats.get("bytes_total", 0),
            bytes_written=stats.get("bytes_written", 0),
            blocks_written=stats.get("blocks_written", 0),
            wall_s=time.perf_counter() - t0,
            dirty=blocks,
            detect_s=detect_s,
        )

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        out: Dict[str, Optional[int]] = {"step": None}

        def do_read(fs: FaaSFS) -> None:
            rec = _read_json(fs, f"{self.root}/latest")
            if rec is not None:
                out["step"] = rec["step"]

        self.runtime.invoke(do_read, read_only=True)
        return out["step"]

    def restore(
        self,
        template: PyTree,
        step: Optional[int] = None,
        *,
        zero_copy: bool = True,
    ) -> Tuple[PyTree, int]:
        """Snapshot-consistent restore; returns (state, step) with numpy
        leaves. A full step loads as in the reference (with ``zero_copy``,
        READONLY views over arena buffers); a delta step loads the full step
        its chain starts from into writable arrays and overlays the chain's
        dirty blocks in order, in the same read-only transaction. Raises
        ``ValueError`` if a base of the chain has been saved again since
        its delta was taken, or if the chain loops."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint committed yet")
        holder: Dict[str, Any] = {}

        def do_load(fs: FaaSFS) -> None:
            holder["flat"] = self._load(fs, step, zero_copy)

        self.runtime.invoke(do_load, read_only=True)
        return unflatten_like(template, holder["flat"]), step

    def _load(self, fs: FaaSFS, step: int, zero_copy: bool) -> Dict[str, np.ndarray]:
        store = TensorStore(fs, prefix=self.root)
        chain = []                  # delta steps, newest first
        visited = set()
        s = step
        while True:
            rec = _read_json(fs, f"{self._step_dir(s)}/.delta")
            if rec is None:
                break
            if s in visited:
                raise ValueError(f"step_{step}: the delta chain loops at step_{s} "
                                 f"({' -> '.join(str(c) for c, _ in chain)} -> {s})")
            visited.add(s)
            chain.append((s, rec))
            base = rec["base"]
            if rec.get("base_id") is not None:   # older deltas name only the step
                ident = _read_json(fs, f"{self._step_dir(base)}/.id")
                if ident is None or ident["id"] != rec["base_id"]:
                    raise ValueError(f"step_{s} is a delta against step_{base}, which has "
                                     f"been saved again since; step_{s} cannot be restored")
            s = base
        if not chain:
            return store.load(f"step_{s}", zero_copy=zero_copy)
        flat = store.load(f"step_{s}")          # writable copies
        for s, rec in reversed(chain):
            meta = _read_json(fs, f"{self._step_dir(s)}/.meta")
            bb = meta["block_bytes"]
            out: Dict[str, np.ndarray] = {}
            for leaf in meta["leaves"]:
                name, dt, shape = leaf["name"], np.dtype(leaf["dtype"]), leaf["shape"]
                fd = fs.open(f"{self._step_dir(s)}/{name}")
                blocks = rec["dirty"].get(name)
                if blocks is None:       # written whole in this step
                    n = fs.fstat(fd)["st_size"]
                    arr = np.frombuffer(fs.pread(fd, n, 0), dtype=dt).reshape(shape).copy()
                else:
                    arr = flat[name]
                    if arr.dtype != dt or list(arr.shape) != shape:
                        raise ValueError(f"step_{s}/{name}: delta against a leaf of "
                                         f"another shape or type")
                    raw = arr.reshape(-1).view(np.uint8)
                    for bi in blocks:
                        off = bi * bb
                        chunk = fs.pread(fd, min(bb, raw.size - off), off)
                        raw[off:off + len(chunk)] = np.frombuffer(chunk, np.uint8)
                fs.close(fd)
                out[name] = arr
            flat = out
        return flat
