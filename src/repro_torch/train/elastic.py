"""Elastic membership via OCC topology predicates — no barriers, no leases.

The paper's file-length predicate generalizes: a cluster 'topology' file
records (generation, num_workers, partition map). Every training step reads
it (adding it to the read set); scale-up/down is a normal transaction that
bumps the generation. In-flight steps from the old generation then FAIL
VALIDATION at commit and retry against the new topology — the paper's
optimistic lock elision applied to cluster membership, instead of the
lease/barrier dance shared filesystems (and classic trainers) use.

Straggler mitigation falls out of the same mechanism: a backup worker may
race the same logical step; whichever commits first wins, the other aborts
at validation and moves on (at-most-once effects without coordination).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS, O_CREAT, O_TRUNC
from repro_torch.core.runtime import FunctionRuntime

TOPOLOGY_PATH = "/mnt/tsfs/cluster/topology"


@dataclass
class Topology:
    generation: int
    workers: List[str]
    partitions: Dict[str, List[str]]  # worker -> parameter partitions

    def to_bytes(self) -> bytes:
        return json.dumps(
            {"generation": self.generation, "workers": self.workers,
             "partitions": self.partitions}
        ).encode()

    @staticmethod
    def from_bytes(raw: bytes) -> "Topology":
        d = json.loads(raw)
        return Topology(d["generation"], d["workers"], d["partitions"])


class ElasticCoordinator:
    def __init__(self, local: LocalServer, path: str = TOPOLOGY_PATH):
        self.local = local
        self.path = path
        self._runtime = FunctionRuntime(local)

    # ------------------------------------------------------------------ #
    def bootstrap(self, workers: List[str], partitions: Dict[str, List[str]]) -> None:
        topo = Topology(1, workers, partitions)

        def do(fs: FaaSFS) -> None:
            fd = fs.open(self.path, O_CREAT | O_TRUNC)
            fs.write(fd, topo.to_bytes())
            fs.close(fd)

        self._runtime.invoke(do)

    def read(self, fs: FaaSFS) -> Topology:
        """Read topology INSIDE a step's transaction: joins the read set, so
        any membership change aborts this step at commit."""
        fd = fs.open(self.path)
        n = fs.fstat(fd)["st_size"]
        raw = fs.pread(fd, n, 0)
        fs.close(fd)
        return Topology.from_bytes(raw)

    # ------------------------------------------------------------------ #
    def _rewrite(self, mutate) -> Topology:
        out: Dict[str, Topology] = {}

        def do(fs: FaaSFS) -> None:
            topo = self.read(fs)
            topo = mutate(topo)
            topo.generation += 1
            fd = fs.open(self.path, O_TRUNC)
            fs.write(fd, topo.to_bytes())
            fs.close(fd)
            out["topo"] = topo

        self._runtime.invoke(do)
        return out["topo"]

    def join(self, worker: str, partitions: Optional[List[str]] = None) -> Topology:
        def mutate(t: Topology) -> Topology:
            if worker not in t.workers:
                t.workers.append(worker)
            t.partitions[worker] = partitions or []
            return t

        return self._rewrite(mutate)

    def leave(self, worker: str) -> Topology:
        def mutate(t: Topology) -> Topology:
            t.workers = [w for w in t.workers if w != worker]
            orphaned = t.partitions.pop(worker, [])
            # reassign orphaned partitions round-robin (restart-free rebalance)
            for i, p in enumerate(orphaned):
                if t.workers:
                    t.partitions.setdefault(t.workers[i % len(t.workers)], []).append(p)
            return t

        return self._rewrite(mutate)
