#!/usr/bin/env python3
"""Where one training step of the port goes, at full width and depth.

  python3 tools/train_profile.py [--arch NAME] [--layers N] [--steps N] [--src DIR]

Initialises the model's float32 weights and AdamW state on the card from
seed 0 (no file system) and runs ``models.runtime.make_train_step`` on
4 x 512-token ``synth_batch`` batches (bf16 compute, remat, one
cross-entropy chunk of 512), as ``chip_smoke.py``'s training phase does.
After ``--steps`` warm-up steps it prints:

  * three whole steps, each timed by the host clock around it ending in
    ``torch.cuda.synchronize()``;
  * the step's two halves timed apart, host clock around each ending in
    ``torch.cuda.synchronize()``: the loss and its gradients
    (``loss_fn`` + ``torch.autograd.grad``) and the AdamW update;
  * one more step under ``torch.profiler`` (CPU and CUDA activities; the
    trace is written to ``build/profile/train_profile_trace.json``): the
    device time summed by kernel from the trace, grouped (flash forward
    and backward, selective scan forward and backward, matrix products,
    the rest), the share of the step's
    wall time the device was busy, the split of the device time by the
    program's innermost range (``launch/perf.py`` ``range_of``: the
    train, model and block ranges of ``repro_torch.tracing`` and, for an
    MoE config, ``moe_ffn``'s routing, dispatch and expert ranges; a
    kernel launched inside one, or by the backward of an op launched
    inside one, belongs to it), and the ten kernels that took longest.

Needs a CUDA card and ``nvcc``; ``--layers`` cuts the depth
(``--arch qwen3-moe-30b-a3b --layers 2`` is chip_smoke's MoE training run). ``--src``
points at another checkout's ``src`` (an unpacked parent commit), so that
two versions can be compared in one run on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "profile"    # the profiler's trace goes here (git ignores build/)


def _perf():
    """``repro_torch.launch.perf`` of this checkout (its kernel groups and
    trace readers), whatever ``--src`` the step runs from."""
    import importlib.util

    path = ROOT / "src" / "repro_torch" / "launch" / "perf.py"
    spec = importlib.util.spec_from_file_location("_repro_torch_perf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--steps", type=int, default=2, help="warm-up steps before timing")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import model as M
    from repro_torch.models import runtime
    from repro_torch.models.runtime import CellPlan, batch_to_device, make_train_step
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{smi.stdout.strip()}; src {args.src}")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    B, S = 4, 512
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    plan = CellPlan(cfg, ShapeCell("t", "train", S, B), ce_chunk=512)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=2, decay_steps=100)
    step = make_train_step(plan, opt_cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    for i in range(args.steps):
        state, _ = step(state, synth_batch(dcfg, i))
    torch.cuda.synchronize()
    secs = []
    for i in range(3):
        batch = synth_batch(dcfg, args.steps + i)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(f"{cfg.name}, {cfg.num_layers} layers, B{B} x S{S}: whole steps "
          f"{', '.join(f'{t:.4f}' for t in secs)} s")

    # the two halves of make_train_step, apart
    batch = batch_to_device(synth_batch(dcfg, args.steps), "cuda")
    leaves = runtime._leaves(state["params"])
    t0 = time.perf_counter()
    ps = [t.detach().requires_grad_(True) for _, t in leaves]
    total, _ = M.loss_fn(cfg, runtime._unflatten([(p, t) for (p, _), t in zip(leaves, ps)]),
                         batch, ce_chunk=512)
    grads = torch.autograd.grad(total, ps)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    del ps, total
    gtree = runtime._unflatten([(p, g) for (p, _), g in zip(leaves, grads)])
    t0 = time.perf_counter()
    new_p, new_opt, _ = adamw.adamw_update(opt_cfg, state["params"], gtree, state["opt"])
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    del grads, gtree, new_p, new_opt
    torch.cuda.empty_cache()
    print(f"{cfg.name}, {cfg.num_layers} layers, B{B} x S{S}: loss and gradients {grad_s:.4f} s, "
          f"AdamW update {adam_s:.4f} s")

    # one whole step under the profiler
    perf = _perf()
    batch = synth_batch(dcfg, args.steps + 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    trace = OUT / "train_profile_trace.json"
    prof.export_chrome_trace(str(trace))
    dev = perf.device_time(json.loads(trace.read_text())["traceEvents"])
    busy = sum(dev["kernel"].values())
    print(f"profiled step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.1%} of the wall time; profiler on)")
    for group, ms in sorted(dev["group"].items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {ms:.2f} ms ({ms / max(busy, 1e-9):.1%} of device time)")
    print("\n".join(perf.range_lines(dev)))
    print("  longest kernels:")
    for name, ms in sorted(dev["kernel"].items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:9.2f} ms  x{int(dev['count'][name]):<5d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
