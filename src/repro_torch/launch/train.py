"""Training launcher: ``--arch <id>`` selects an architecture.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --reduced --device cpu --steps 4

Port of ``repro.launch.train`` on one device (``--device``, default
``cuda``), for every family of ``configs/``. A vlm config's batches carry
``vision_prefix`` pixel embeddings before the ``--seq`` text tokens
(``train_batch``), which take no loss. ``--remat-policy dots`` keeps the
products' outputs through the layer's rematerialization. The slice, in the
reference's order:

  1. ``init_params`` and ``init_opt_state`` (float32, from ``--seed``);
  2. ``TransactionalTrainer.init`` commits the state to an in-process
     FaaSFS backend (256 KiB blocks, eager cache updates);
  3. ``--steps`` trainer steps on ``synth_batch`` batches, each one FaaSFS
     transaction: load, step on the device, dirty blocks found on the
     device, in-place delta commit;
  4. every ``--ckpt-every`` steps and after the last one,
     ``CheckpointManager.save``: the first save is full, later ones are
     deltas against the last;
  5. ``CheckpointManager.restore`` of the latest step;
  6. the restored params are published and served through the serving
     slice (``launch/serve.py``): prefill of ``--batch`` prompts of
     ``--seq`` tokens and greedy decoding.

``--reduced`` takes the tiny same-family config of the CPU tests.
``--full`` is the reference's: it traces the FULL config's ``train_4k``
cell on the production pod mesh through ``launch.dryrun.run_cell`` (fake
process group, fake tensors, on the CPU), prints one device's memory and
cost, and returns; real devices would run the same step and plan.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import (ModelConfig, ShapeCell, get_config, list_configs,
                                      reduced_config)
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.types import CachePolicy
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.runtime import CellPlan, make_train_step
from repro_torch.optim import adamw
from repro_torch.state.checkpoint import CheckpointManager, SaveInfo
from repro_torch.train.loop import StepResult, TransactionalTrainer

BLOCK_BYTES = serve.BLOCK_BYTES


@dataclass
class TrainRun:
    trainer: TransactionalTrainer
    manager: CheckpointManager
    steps: List[StepResult]
    saves: List[SaveInfo]
    restored: Dict                  # numpy tree of the latest checkpoint
    restored_step: int
    serve_slice: serve.ServeSlice
    prompts: torch.Tensor
    served: Any                     # (prefill logits, tokens) of the restored params
    # committed states on the device, after init and after each step
    # (``keep_states``), for checks against the dirty sets
    states: List[Dict] = field(default_factory=list)
    seconds: Dict[str, float] = field(default_factory=dict)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """``synth_batch``, and for a vlm config "pixel_embeds" (batch,
    vision_prefix, d_model) float32, standard normal from (seed, step): the
    stub frontend's output the reference's ``input_specs`` stands for."""
    batch = synth_batch(dcfg, step)
    if cfg.vision_prefix:
        rng = np.random.default_rng([dcfg.seed, step])
        batch["pixel_embeds"] = rng.standard_normal(
            (dcfg.global_batch, cfg.vision_prefix, cfg.d_model), dtype=np.float32)
    return batch


def run(
    cfg: ModelConfig,
    *,
    device: str = "cuda",
    steps: int = 20,
    batch: int = 2,
    seq: int = 64,
    ckpt_every: int = 10,
    seed: int = 0,
    serve_tokens: int = 32,
    keep_states: bool = False,
    remat_policy: Optional[str] = None,
) -> TrainRun:
    """Steps 1-6 of the module docstring; seconds of each stage in
    ``seconds`` (synchronized)."""
    secs: Dict[str, float] = {}
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                           device=device)
    state0 = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    plan = CellPlan(cfg, ShapeCell("t", "train", seq, batch), q_chunk=0, ce_chunk=32,
                    remat_policy=remat_policy)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=5, decay_steps=steps)
    step_fn = make_train_step(plan, opt_cfg)
    _sync(device)
    secs["init_state"] = time.perf_counter() - t0

    backend = BackendService(block_size=BLOCK_BYTES, policy=CachePolicy.EAGER)
    local = LocalServer(backend)
    trainer = TransactionalTrainer(local, step_fn, state0, device=device,
                                   block_bytes=BLOCK_BYTES)
    cm = CheckpointManager(local, block_bytes=BLOCK_BYTES)
    t0 = time.perf_counter()
    trainer.init(state0)
    secs["trainer_init"] = time.perf_counter() - t0
    del state0
    states = [trainer.read_state()] if keep_states else []

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed)
    results: List[StepResult] = []
    saves: List[SaveInfo] = []
    for step in range(steps):
        t0 = time.perf_counter()
        results.append(trainer.step(train_batch(cfg, dcfg, step)))
        secs[f"step_{step + 1}"] = time.perf_counter() - t0
        if keep_states:
            states.append(trainer.read_state())
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            t0 = time.perf_counter()
            saves.append(cm.save(step + 1, trainer.read_state()))
            _sync(device)
            secs[f"save_{step + 1}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    restored, restored_step = cm.restore(trainer.template)
    secs["restore"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prompts = torch.as_tensor(synth_batch(dcfg, 1 << 20)["tokens"]).long().to(device)
    sl = serve.ServeSlice(cfg, device=device, tokens=serve_tokens, block_bytes=BLOCK_BYTES)
    sl.publish(params_from_numpy(restored["params"], device))
    sl.refresh()
    served = sl.serve(prompts)
    _sync(device)
    secs["serve"] = time.perf_counter() - t0
    return TrainRun(trainer, cm, results, saves, restored, restored_step, sl, prompts,
                    served, states, secs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of the CPU tests")
    ap.add_argument("--full", action="store_true",
                    help="trace the FULL config's train_4k cell on the production mesh "
                         "(the dry run; nothing runs on a device)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat-policy", choices=["dots"], default=None,
                    help="dots: keep the outputs of the products with no batch dimension "
                         "(default: recompute the whole layer)")
    args = ap.parse_args()

    if args.full:
        from repro_torch.launch import dryrun

        rec = dryrun.run_cell(args.arch, "train_4k", "pod", force=True)
        if not rec.get("ok"):
            raise SystemExit(f"dry run failed: {rec.get('error')}")
        mem, a = rec["memory"], rec["analysis"]
        print(f"{args.arch} train_4k on the pod mesh {rec['mesh_shape']}, per device: "
              f"arguments {mem['argument_bytes'] / 2**30:.2f} GiB, peak "
              f"{mem['peak_bytes_est'] / 2**30:.2f} GiB; {a['flops_per_device']:.4e} FLOPs, "
              f"{a['bytes_per_device']:.4e} HBM bytes, "
              f"{a['collective_bytes_per_device']:.4e} collective bytes "
              f"{a['collective_counts']}")
        print("full config traced; attach real devices to execute")
        return

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    print(f"arch={cfg.name} device={args.device} params={cfg.param_count():,} "
          f"family={cfg.family}")
    r = run(cfg, device=args.device, steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt_every=args.ckpt_every, seed=args.seed, remat_policy=args.remat_policy)
    for res in r.steps:
        print(f"step {res.step:4d} loss={res.metrics['loss']:.4f} attempts={res.attempts} "
              f"blocks={res.blocks_written} bytes={res.bytes_written:,}")
    for s in r.saves:
        kind = "full" if s.dirty is None else "delta"
        print(f"checkpoint step {s.step} ({kind}): {s.blocks_written} blocks, "
              f"{s.bytes_written:,} of {s.bytes_total:,} B in {s.wall_s:.2f}s")
    print(f"restored step {r.restored_step}; served {tuple(r.prompts.shape)} prompts, "
          f"row 0 tokens {r.served[1][0].tolist()}")
    print("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in r.seconds.items()))
    print(f"{r.trainer.stats.aborts} occ aborts")


if __name__ == "__main__":
    main()
