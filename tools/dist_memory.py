#!/usr/bin/env python3
"""Where the planned train step's device memory and time go on one rank.

  python3 tools/dist_memory.py [--arch NAME] [--layers N]

The train step of ``chip_smoke.py``'s ``dist`` phase (full width, B 4 x S
512, bf16, float32 AdamW state from seed 0) through ``plan_cell`` on a
1-rank NCCL group over the card (``launch.mesh.make_host_mesh``), with the
one-device state kept beside the plan's, as the phase keeps it. Three
versions of the plan, and the unsharded step:

  * ``now``: the code as it is. The reference's placements, split over
    axes of one rank; over those ``shard_state`` keeps the state's own
    tensors (``runtime._distribute``);
  * ``copy``: the same placements, with ``shard_state`` cutting each leaf
    by ``distribute_tensor`` (a new buffer for a split, even over one
    rank);
  * ``shortcut``: every split over an axis of one rank made
    ``Replicate()`` (so nothing is split at all), as the plan's placements
    were before it ran on several ranks.

For each: the device memory held before the step (state, batch and the
plan's state), the bytes of the plan's state that are copies and not the
one-device state's own tensors, the step's peak (``max_memory_allocated``
after a warm-up step) and its excess over what was held, the wall time of
two more steps (host clock, synchronized), the device-busy time of one
more (``torch.profiler``) and its ten host operations of most self time,
and whether the new params equal the unsharded
step's bit for bit. Prints one JSON object; needs a CUDA card and
``nvcc`` (the flash kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("dist_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import perf, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers, model as M, runtime
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    B, S = 4, 512
    shape = runtime.ShapeCell("t", "train", S, B)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=2, decay_steps=100)
    batch = train.train_batch(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                              global_batch=B), 0)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    mesh = make_host_mesh("cuda")
    own = {t.data_ptr() for t in _flat(state).values()}

    literal, distribute = layers.placements, runtime._distribute

    def shortcut(s, mesh):
        return tuple(Replicate() if mesh.size(m) == 1 else p
                     for m, p in enumerate(literal(s, mesh)))

    def copying(full, mesh, s):
        return distribute_tensor(full, mesh, runtime.placements(
            tuple(s) + (None,) * (full.dim() - len(s)), mesh), src_data_rank=None)

    def patch(placements, dist_fn):
        for mod in (layers, runtime):
            mod.placements = placements
        runtime._distribute = dist_fn

    def measure(step, st, b):
        new, _ = step(st, b)                      # warm-up
        del new
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        new, metrics = step(st, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # the new params on the host: the card holds one new state at a time
        out = {k: (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()
               for k, t in _flat(new["params"]).items()}
        del new
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            again, _ = step(st, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            again, _ = step(st, b)
            torch.cuda.synchronize()
        del again
        trace = ROOT / "build" / "profile" / "dist_memory_trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        busy = sum(perf.device_time(json.loads(trace.read_text())["traceEvents"])
                   ["kernel"].values())
        host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        return out, {"held_gib": held / 2**30, "peak_gib": peak / 2**30,
                     "step_excess_gib": (peak - held) / 2**30, "wall_s": walls,
                     "device_busy_ms": busy, "loss": metrics["loss"],
                     "host_self_ms_top": [(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count)
                                          for e in host]}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    report = {"card": smi.stdout.strip(), "torch": torch.__version__, "arch": cfg.name,
              "layers": cfg.num_layers, "B": B, "S": S,
              "state_gib": sum(t.numel() * t.element_size()
                               for t in _flat(state).values()) / 2**30,
              "versions": {}}
    try:
        # undonated throughout: every version steps from the same state
        one, rep = measure(runtime.make_train_step(
            runtime.CellPlan(cfg, shape, ce_chunk=512), opt_cfg, donate=False), state, batch)
        report["versions"]["unsharded"] = rep
        for name, knobs in (("now", (literal, distribute)), ("copy", (literal, copying)),
                            ("shortcut", (shortcut, copying))):
            patch(*knobs)
            plan = runtime.plan_cell(cfg, shape, mesh)
            sstate = runtime.shard_state(plan, mesh, state)
            sbatch = runtime.shard_batch(plan, mesh, batch)
            copied = sum(t.to_local().numel() * t.to_local().element_size()
                         for t in _flat(sstate).values() if t.to_local().data_ptr() not in own)
            got, rep = measure(runtime.make_train_step(plan, opt_cfg, donate=False), sstate,
                               sbatch)
            rep["state_copies_gib"] = copied / 2**30
            rep["params_equal_unsharded"] = all(torch.equal(t, got[k]) for k, t in one.items())
            report["versions"][name] = rep
            del got, sstate, sbatch
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        patch(literal, distribute)
        dist.destroy_process_group()
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
