"""Carry parameter and training-state trees between FaaSFS (numpy leaves)
and torch devices.

Leaf names are those of ``core.tensorstate.flatten_with_names`` (sorted,
'/'-joined dict paths), so a tree published by either package loads in the
other. A training state ``{"params", "opt": {"m", "v", "count"}}`` crosses
as a parameter tree does, its int32 scalar ``count`` as a 0-d array on the
host and a 0-d tensor on the device, so a state written by either
package's trainer or checkpoint manager loads into the other.
``DeviceSnapshot`` keeps the device copy of a served snapshot: it moves a
snapshot to the card once per snapshot version, and after the first
version it moves only the blocks whose bytes changed.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.tensorstate import flatten_with_names, unflatten_like
from repro_torch.core.types import TENSOR_BLOCK_BYTES

PyTree = Any


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, of ``arr``'s shape (0-d too:
    ``np.ascontiguousarray`` would make a scalar 1-d). FaaSFS snapshot
    leaves are readonly arena views; torch warns on those, and every caller
    here only reads the tensor (copies it to a device or into a fresh
    buffer)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.require(arr, requirements="C"))


def params_from_numpy(tree: PyTree, device: str = "cuda") -> PyTree:
    """Nested dict of numpy leaves -> same structure of tensors on
    ``device``. Leaves are always copied, so the result never aliases a
    (possibly recycled) arena buffer."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    t = _from_numpy(np.asarray(tree))
    return t.to(device, copy=True)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> same structure of host numpy arrays (0-d
    tensors to 0-d arrays)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        raise TypeError("bf16 leaves have no numpy dtype; publish float32")
    return tree.detach().cpu().numpy()


def structure(tree: PyTree) -> PyTree:
    """``tree``'s dict structure with empty leaves: a template for
    ``unflatten_like`` that holds no tensor or array memory."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    return None


def flat_tensors(tree: PyTree) -> Dict[str, torch.Tensor]:
    """{leaf name: tensor} in ``flatten_with_names`` order and naming."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix: str) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        else:
            out[prefix.rstrip("/")] = node

    walk(tree, "")
    return out


@dataclass
class UploadStats:
    versions: int = 0          # snapshot versions moved to the device
    bytes_moved: int = 0       # host -> device bytes, all versions
    blocks_moved: int = 0      # blocks moved by delta updates
    seconds: float = 0.0       # host wall time in get() for new versions
    last_blocks: Optional[Dict[str, List[int]]] = None  # per-leaf, last delta


class DeviceSnapshot:
    """The device copy of the parameter tree a ``SnapshotServer`` serves.

    ``get(state)`` takes the host tree that ``SnapshotServer.refresh`` put
    in ``params`` (readonly arena views) and returns the device tree. A new
    host tree object is a new snapshot version: the first one is copied to
    the device whole; later ones are compared with the previous version's
    host leaves block by block (exact bytes, ``block_bytes`` granularity)
    and only the blocks that differ are copied, in place. Requests served
    from one version reuse its device tree with no transfer.
    """

    def __init__(self, device: str = "cuda",
                 block_bytes: int = TENSOR_BLOCK_BYTES):
        self.device = device
        self.block_bytes = block_bytes
        self.stats = UploadStats()
        self._state: Optional[PyTree] = None
        self._host: Dict[str, np.ndarray] = {}
        self._dev: Dict[str, torch.Tensor] = {}
        self._tree: Optional[PyTree] = None

    def get(self, state: PyTree) -> PyTree:
        if state is self._state:
            return self._tree
        t0 = time.perf_counter()
        flat = dict(flatten_with_names(state))
        if not self._dev:
            for name, arr in flat.items():
                self._dev[name] = _from_numpy(arr).to(self.device, copy=True)
                self.stats.bytes_moved += arr.nbytes
        else:
            self.stats.last_blocks = {}
            for name, arr in flat.items():
                self.stats.last_blocks[name] = self._update_leaf(name, arr)
        self._host = flat  # keeps the arena views alive for the next compare
        self._state = state
        self._tree = unflatten_like(state, self._dev)
        self.stats.versions += 1
        self.stats.seconds += time.perf_counter() - t0
        return self._tree

    def _update_leaf(self, name: str, arr: np.ndarray) -> List[int]:
        old = self._host[name]
        dev = self._dev[name]
        if old.shape != arr.shape or old.dtype != arr.dtype:
            self._dev[name] = _from_numpy(arr).to(self.device, copy=True)
            self.stats.bytes_moved += arr.nbytes
            return list(range(-(-arr.nbytes // self.block_bytes)))
        a = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        b = np.ascontiguousarray(old).reshape(-1).view(np.uint8)
        bb = self.block_bytes
        n = len(a)
        dirty = []
        for bi in range(-(-n // bb)):
            lo, hi = bi * bb, min(n, (bi + 1) * bb)
            if not np.array_equal(a[lo:hi], b[lo:hi]):
                dirty.append(bi)
        if dirty:
            # copy dirty blocks through a byte view of the device leaf
            dbytes = dev.view(-1).view(torch.uint8)
            src = _from_numpy(a)
            for bi in dirty:
                lo, hi = bi * bb, min(n, (bi + 1) * bb)
                dbytes[lo:hi].copy_(src[lo:hi])
                self.stats.bytes_moved += hi - lo
            self.stats.blocks_moved += len(dirty)
        return dirty
