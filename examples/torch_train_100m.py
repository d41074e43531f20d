"""End-to-end driver on the PyTorch port: train a ~100M-param model with
transactional state.

Every training step runs as a function-grained FaaSFS transaction (BEGIN ->
read params -> step on the device -> COMMIT delta blocks), with atomic
checkpoints every ``--ckpt-every`` steps and crash-free restart: a run
resumes from the last committed checkpoint of its backend. On a CUDA device
the step's attention is the flash kernel (forward and backward) and the
dirty blocks of each commit and delta checkpoint are found by the
block-delta kernel; ``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python examples/torch_train_100m.py --steps 300
      (add --device cpu --d-model 128 --layers 4 for a quick CPU pass)
"""
import argparse
import math
import time

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.types import CachePolicy
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.kernels.block_delta import ops as bd_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import model as M
from repro_torch.models.runtime import CellPlan, make_train_step
from repro_torch.optim import adamw
from repro_torch.state.checkpoint import CheckpointManager
from repro_torch.train.loop import TransactionalTrainer

BLOCK_BYTES = 1 << 20


def build_cfg(args) -> ModelConfig:
    return ModelConfig(
        name="train100m",
        family="dense",
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=args.d_model // 64,
        num_kv_heads=max(1, args.d_model // 256),
        head_dim=64,
        d_ff=args.d_model * 4,
        vocab_size=8192,
        tie_embeddings=True,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)   # ~100M params
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = build_cfg(args)
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.num_layers}L d{cfg.d_model})")

    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=args.device)
    state0 = {"params": params, "opt": adamw.init_opt_state(params)}
    plan = CellPlan(cfg, ShapeCell("t", "train", args.seq, args.batch), q_chunk=0,
                    ce_chunk=128, attn_impl="auto")
    step_fn = make_train_step(
        plan, adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=20, decay_steps=args.steps))

    backend = BackendService(block_size=BLOCK_BYTES, policy=CachePolicy.EAGER)
    local = LocalServer(backend)
    trainer = TransactionalTrainer(local, step_fn, state0, device=args.device,
                                   block_bytes=BLOCK_BYTES)
    cm = CheckpointManager(local, block_bytes=BLOCK_BYTES)

    # resume if a checkpoint exists (crash/restart = just rerun the step loop)
    start = 0
    try:
        restored, start = cm.restore(trainer.template)
        trainer.init(restored)
        print(f"resumed from committed checkpoint @ step {start}")
    except FileNotFoundError:
        trainer.init(state0)
        print("fresh start")
    del state0, params

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    t0 = time.time()
    for step in range(start, args.steps):
        res = trainer.step(synth_batch(dcfg, step))
        if not math.isfinite(res.metrics["loss"]):
            raise SystemExit(f"step {step}: loss is {res.metrics['loss']}")
        if step % 10 == 0:
            toks = args.batch * args.seq * (step + 1 - start)
            print(f"step {step:4d} loss={res.metrics['loss']:.4f} "
                  f"gnorm={res.metrics['grad_norm']:.2f} "
                  f"commit_bytes={res.bytes_written:,} "
                  f"tok/s={toks / (time.time() - t0):,.0f}")
        if (step + 1) % args.ckpt_every == 0:
            info = cm.save(step + 1, trainer.read_state())
            kind = "full" if info.dirty is None else "delta"
            print(f"  checkpoint @ {step+1}: {info.bytes_written:,} bytes "
                  f"({info.blocks_written} blocks, {kind}) in {info.wall_s:.2f}s")
    print(f"done: {trainer.stats.steps} steps, {trainer.stats.aborts} occ aborts, "
          f"{trainer.stats.commit_bytes/1e6:.1f}MB committed")
    print(f"kernels on {args.device}: flash_attention {fa_ops.flash_attention.launches} "
          f"(sm90 {fa_ops.flash_attention.launches_sm90}), flash_attention_bwd "
          f"{fa_ops.flash_attention_bwd.launches} "
          f"(sm90 {fa_ops.flash_attention_bwd.launches_sm90}), "
          f"block_delta {bd_ops.block_delta.launches}")


if __name__ == "__main__":
    main()
