#!/usr/bin/env python3
"""Time the port's bf16 prefill of one 4 x 512-token batch at full width.

  python3 tools/prefill_time.py [--src DIR] [--arch NAME ...] [--reps N]

Initialises each model's weights on the card from seed 0 (no file system),
casts them to bf16 as serving does, and times ``models.model.prefill`` of
a random 4 x 512 prompt batch two ways, after one warm-up call: the host
clock around each eager call, ending in ``torch.cuda.synchronize()`` (what
a request waits for; the eager prefill issues one launch at a time from
Python), and CUDA events around replays of the same prefill captured once
in a CUDA graph (the device's time for its work). Prints the card, then
per model the medians and each repetition in seconds and the kernel
launches of one prefill. ``--src`` points at another checkout's ``src``
(for instance an unpacked parent commit), so two versions of the port can
be compared in one run on one card. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", nargs="+", default=["qwen2-1.5b", "hymba-1.5b"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.models import model as M

    if not torch.cuda.is_available():
        print("prefill_time: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{smi.stdout.strip()}; src {args.src}")
    for arch in args.arch:
        cfg = get_config(arch)
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        cast = M.cast_params(params, torch.bfloat16)
        del params
        prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                                generator=torch.Generator().manual_seed(1)).cuda()
        M.prefill(cfg, cast, prompts)
        torch.cuda.synchronize()
        fa_ops.flash_attention.launches = scan_ops.selective_scan_fwd.launches = 0
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            M.prefill(cfg, cast, prompts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {"flash_attention": fa_ops.flash_attention.launches // args.reps,
                    "ssm_scan": scan_ops.selective_scan_fwd.launches // args.reps}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            M.prefill(cfg, cast, prompts)
        graph.replay()
        torch.cuda.synchronize()
        device = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            device.append(start.elapsed_time(end) / 1e3)
        print(f"{arch}: prefill eager median {statistics.median(times):.4f} s "
              f"({', '.join(f'{t:.4f}' for t in times)}); as a CUDA graph, device median "
              f"{statistics.median(device):.5f} s ({', '.join(f'{t:.5f}' for t in device)}); "
              f"launches per prefill {launches}")
        del cast, graph
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
