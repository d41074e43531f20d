"""Transactional training: every step is a function-grained transaction.

Port of ``repro.train.loop``. The FaaS execution model mapped onto a
training worker with a device:

  * a worker BEGINs a transaction and reads the current training state
    (block-cached; only changed blocks cross the wire),
  * moves it to its device once, runs ``train_step`` there, and finds the
    blocks the step changed on the device (``dirty_block_indices``: the
    block-delta kernel's exact flag on the card) against the state it read,
  * moves the new state to the host once and COMMITs those blocks, written
    in place, plus a step-counter increment.

OCC consequences, exactly the reference's: workers whose steps touch
disjoint blocks commit independently, a conflicting commit aborts and the
step retries on fresh state, and a worker that dies mid-step leaves no
partial state. The one change is forced: the reference turns the new state
into numpy with ``jax.tree.map(np.asarray, ...)`` (``:102``), which cannot
read a CUDA tensor; here the state crosses host and device through
``repro_torch.bridge`` once each way per step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from repro_torch.bridge import flat_tensors, params_from_numpy, params_to_numpy, structure
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS, O_CREAT
from repro_torch.core.runtime import FunctionRuntime, InvocationStats
from repro_torch.core.tensorstate import TensorStore, unflatten_like
from repro_torch.core.types import TENSOR_BLOCK_BYTES
from repro_torch.state.checkpoint import dirty_block_indices

PyTree = Any


@dataclass
class StepResult:
    step: int
    metrics: Dict[str, float]
    attempts: int
    commit_ts: int
    bytes_written: int
    blocks_written: int = 0
    # per-leaf dirty blocks the device found and the commit wrote
    dirty: Dict[str, List[int]] = field(default_factory=dict)


@dataclass
class WorkerStats:
    steps: int = 0
    aborts: int = 0
    commit_bytes: int = 0
    wall_s: float = 0.0


def _host_tree(state: PyTree) -> PyTree:
    """A state of tensors or of numpy leaves as numpy leaves."""
    if isinstance(state, dict):
        return {k: _host_tree(v) for k, v in state.items()}
    return params_to_numpy(state) if hasattr(state, "detach") else state


class TransactionalTrainer:
    """Drives train steps as FaaSFS transactions against shared state.

    ``train_step(state, batch) -> (new_state, metrics)`` takes and returns
    trees of tensors on ``device`` (``models.runtime.make_train_step``);
    ``template`` gives the state's structure, and only its structure is
    kept. Blocks are ``block_bytes`` long, for the writes and for dirty
    detection alike.
    """

    def __init__(
        self,
        local: LocalServer,
        train_step: Callable[[PyTree, Any], tuple],
        template: PyTree,
        *,
        root: str = "/mnt/tsfs/train",
        name: str = "state",
        device: str = "cuda",
        block_bytes: int = TENSOR_BLOCK_BYTES,
    ):
        self.local = local
        self.train_step = train_step
        self.template = structure(template)
        self.root = root.rstrip("/")
        self.name = name
        self.device = device
        self.block_bytes = block_bytes
        self.stats = WorkerStats()
        self._runtime = FunctionRuntime(local)

    # ------------------------------------------------------------------ #
    def init(self, state: PyTree) -> int:
        host = _host_tree(state)

        def do_init(fs: FaaSFS) -> None:
            store = TensorStore(fs, prefix=self.root)
            store.save(self.name, host, block_bytes=self.block_bytes)
            fd = fs.open(f"{self.root}/{self.name}.step", O_CREAT)
            fs.pwrite(fd, (0).to_bytes(8, "little"), 0)
            fs.close(fd)

        inv = InvocationStats()
        self._runtime.invoke(do_init, stats=inv)
        return inv.commit_ts

    # ------------------------------------------------------------------ #
    def step(self, batch: Any) -> StepResult:
        """One training step as one transaction (with OCC retry inside)."""
        t0 = time.perf_counter()
        holder: Dict[str, Any] = {}

        def do_step(fs: FaaSFS) -> None:
            store = TensorStore(fs, prefix=self.root)
            flat = store.load(self.name)
            state = params_from_numpy(unflatten_like(self.template, flat), self.device)
            old = flat_tensors(state)   # held: a step may consume ``state``
            new_state, metrics = self.train_step(state, batch)
            new = flat_tensors(new_state)
            dirty = {}
            for lname, t in new.items():
                idx = dirty_block_indices(t, old[lname], self.block_bytes)
                if idx is not None:
                    dirty[lname] = idx
            del state, old
            host = params_to_numpy(new_state)
            s = store.save(self.name, host, baseline=flat, block_bytes=self.block_bytes,
                           dirty_blocks=dirty)
            fd = fs.open(f"{self.root}/{self.name}.step")
            cur = int.from_bytes(fs.pread(fd, 8, 0), "little")
            fs.pwrite(fd, (cur + 1).to_bytes(8, "little"), 0)
            fs.close(fd)
            holder["metrics"] = {k: float(v) for k, v in metrics.items()}
            holder["step"] = cur + 1
            holder["bytes"] = s["bytes_written"]
            holder["blocks"] = s["blocks_written"]
            holder["dirty"] = dirty

        inv = InvocationStats()
        self._runtime.invoke(do_step, stats=inv)
        self.stats.steps += 1
        self.stats.aborts += inv.aborts
        self.stats.commit_bytes += holder.get("bytes", 0)
        self.stats.wall_s += time.perf_counter() - t0
        return StepResult(
            step=holder.get("step", -1),
            metrics=holder.get("metrics", {}),
            attempts=inv.attempts,
            commit_ts=inv.commit_ts,
            bytes_written=holder.get("bytes", 0),
            blocks_written=holder.get("blocks", 0),
            dirty=holder.get("dirty", {}),
        )

    # ------------------------------------------------------------------ #
    def read_state(self, snapshot: bool = True) -> PyTree:
        """The committed state, as tensors on the trainer's device."""
        holder: Dict[str, Any] = {}

        def do_read(fs: FaaSFS) -> None:
            store = TensorStore(fs, prefix=self.root)
            holder["flat"] = store.load(self.name)

        self._runtime.invoke(do_read, read_only=snapshot)
        return params_from_numpy(unflatten_like(self.template, holder["flat"]), self.device)
