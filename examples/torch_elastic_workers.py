"""Elastic swarm training on the PyTorch port: workers join/leave mid-run,
stragglers race.

Shows the FaaS fault-tolerance model applied to training:
  * workers are stateless functions — any of them can run any step,
  * membership changes are OCC commits on the topology file (no barriers);
    in-flight steps from the old generation abort + retry,
  * a duplicated ("backup") step commits exactly once — the loser aborts
    at validation,
  * a killed worker leaves NO partial state.

Each worker's step runs on its trainer's device (``--device``).

Run:  PYTHONPATH=src python examples/torch_elastic_workers.py [--device cpu]
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.types import CachePolicy
from repro_torch.train.elastic import ElasticCoordinator
from repro_torch.train.loop import TransactionalTrainer


def template():
    return {"w": np.zeros((64, 64), np.float32), "count": np.int64(0)}


def make_step(coord: ElasticCoordinator):
    def train_step(state, batch):
        # a real step would shard work by the partition map; here we just
        # pull the state toward the batch
        w = state["w"]
        g = w - torch.as_tensor(batch, device=w.device)
        return (
            {"w": w - 0.1 * g, "count": state["count"] + 1},
            {"loss": float(torch.mean(g * g))},
        )

    return train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    backend = BackendService(block_size=65536, policy=CachePolicy.EAGER)
    coord = ElasticCoordinator(LocalServer(backend))
    coord.bootstrap(["w0"], {"w0": ["all"]})

    target = np.full((64, 64), 1.0, np.float32)
    stop = threading.Event()
    stats = {}

    def worker(name: str, delay: float = 0.0):
        time.sleep(delay)
        local = LocalServer(backend)
        if delay > 0:
            topo = ElasticCoordinator(local).join(name)
            print(f"[{name}] joined at generation {topo.generation}")
        tr = TransactionalTrainer(local, make_step(coord), template(), device=dev)
        while not stop.is_set():
            # each step reads the topology inside its txn: membership
            # changes invalidate in-flight steps (no barrier, no lease)
            tr.step(target)
        stats[name] = tr.stats
        print(f"[{name}] done: {tr.stats.steps} steps, {tr.stats.aborts} occ aborts")

    trainer0 = TransactionalTrainer(LocalServer(backend), make_step(coord), template(),
                                    device=dev)
    trainer0.init(template())

    threads = [
        threading.Thread(target=worker, args=("w0", 0.0)),
        threading.Thread(target=worker, args=("w1", 0.3)),   # elastic scale-up
        threading.Thread(target=worker, args=("w2", 0.6)),
    ]
    for t in threads:
        t.start()

    time.sleep(1.0)
    topo = ElasticCoordinator(LocalServer(backend)).leave("w2")  # scale-down
    print(f"[coord] w2 left; generation {topo.generation}, workers {topo.workers}")
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()

    final = trainer0.read_state()
    total_steps = int(final["count"])
    committed = sum(s.steps for s in stats.values())
    print(f"\nfinal committed step count: {total_steps} "
          f"(== {committed} worker commits, exactly-once despite races)")
    assert total_steps == committed
    print("loss:", float(torch.mean((final["w"] - torch.as_tensor(target, device=dev)) ** 2)))


if __name__ == "__main__":
    main()
