"""Serve a model from pinned snapshots while training commits new versions,
on the PyTorch port.

Demonstrates the paper's multiversion snapshot reads as an ML-serving
feature: inference replicas serve a *consistent* parameter version with
zero coordination against the writer, then delta-refresh to newer commits.
The serving replica keeps its parameters on the device
(``bridge.DeviceSnapshot``): a new version moves only the blocks that
changed since the last one.

Run:  PYTHONPATH=src python examples/torch_serve_snapshot.py [--device cpu]
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.bridge import DeviceSnapshot, params_to_numpy
from repro_torch.configs.base import ShapeCell, get_config, reduced_config
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.types import CachePolicy
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import model as M
from repro_torch.models.runtime import CellPlan, make_train_step
from repro_torch.optim import adamw
from repro_torch.serving.engine import SnapshotServer
from repro_torch.train.loop import TransactionalTrainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    cfg = reduced_config(get_config("qwen2-1.5b"), num_layers=2, d_model=64,
                         d_ff=128, vocab_size=512)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state0 = {"params": params, "opt": adamw.init_opt_state(params)}
    plan = CellPlan(cfg, ShapeCell("t", "train", 64, 4), q_chunk=0, ce_chunk=32)
    step_fn = make_train_step(plan, adamw.AdamWConfig(lr_peak=1e-3))

    backend = BackendService(block_size=1 << 18, policy=CachePolicy.EAGER)
    trainer = TransactionalTrainer(LocalServer(backend), step_fn, state0, device=dev,
                                   block_bytes=1 << 18)
    trainer.init(state0)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)

    stop = threading.Event()

    def train_loop():
        step = 0
        while not stop.is_set():
            trainer.step(synth_batch(dcfg, step))
            step += 1

    t = threading.Thread(target=train_loop)
    t.start()

    # a serving replica pins snapshots and refreshes on its own schedule
    snap = DeviceSnapshot(dev, block_bytes=1 << 18)

    @torch.no_grad()
    def decode_fn(state, toks):
        logits, _ = M.prefill(cfg, snap.get(state["params"]),
                              torch.as_tensor(toks, device=dev).long(), q_chunk=0)
        return logits.argmax(dim=-1).cpu().numpy()

    server = SnapshotServer(LocalServer(backend), decode_fn, params_to_numpy(state0))
    prompt = synth_batch(dcfg, 12345)["tokens"][:2, :16]
    try:
        for round_ in range(5):
            version = server.refresh()
            outs = [server.serve(prompt) for _ in range(3)]
            assert all(np.array_equal(outs[0], o) for o in outs), \
                "snapshot must be stable between refreshes"
            print(f"round {round_}: pinned version {version}, "
                  f"next tokens {outs[0].tolist()} "
                  f"(trainer committed {trainer.stats.steps} steps so far)")
            time.sleep(0.3)
    finally:
        stop.set()
        t.join()
    print(f"served {server.stats.requests} requests across "
          f"{server.stats.refreshes} snapshot versions while training ran")
    print(f"device copies on {dev}: {snap.stats.versions} versions, "
          f"{snap.stats.bytes_moved:,} bytes moved")


if __name__ == "__main__":
    main()
