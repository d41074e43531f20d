#!/usr/bin/env python3
"""Time the port's flash-attention backward at the two training shapes.

  python3 tools/flash_bwd_time.py [--src DIR] [--reps N]

At qwen2-1.5b's training shape (B 4, S 512, H 12, KV 2, hd 128, causal)
and hymba-1.5b's (H 25, KV 5, hd 64, window 2048), bf16, on random inputs
from seed 7, it prints device times per call, each the mean of 20 calls
captured in a CUDA graph and replayed ``--reps`` times between CUDA events:

  * the forward kernel without and with its log-sum-exp stored;
  * the backward on the tensor-core route (``flash_attention_bwd``), also
    eager (calls issued from Python, wrapper included), and its three
    kernels apart, from ``torch.profiler`` over 20 eager calls;
  * the CUDA-core route on the same bf16 inputs;
  * SDPA's backward (``enable_gqa``; forward and backward captured, minus
    the forward), the yardstick;
  * how many thread-block clusters of the dK/dV kernel the card holds at
    once (``cudaOccupancyMaxActiveClusters``), against its SM count.

Prints the card's name and power limit first. ``--src`` points at another
checkout's ``src`` (an unpacked parent commit, or a variant under the
ignored ``build/``), so that two versions can be compared in one run on
one card. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"qwen2-1.5b": (4, 512, 12, 2, 128, 0), "hymba-1.5b": (4, 512, 25, 5, 64, 2048)}


def device_ms(torch, fn, calls: int = 20, reps: int = 3) -> float:
    """Mean device milliseconds of one ``fn()``: ``calls`` calls captured in
    a CUDA graph (warmed up on a side stream), replayed ``reps`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def eager_ms(torch, fn, calls: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def kernel_split(torch, fn, calls: int = 20):
    """{kernel name: device ms per call} from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        name = re.search(r"fa_bwd_\w+", ev.key)
        if us and name:
            out[name.group(0)] += us / 1e3 / calls
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    if not torch.cuda.is_available():
        print("flash_bwd_time: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{smi.stdout.strip()}; src {args.src}", flush=True)
    for tag, (B, S, H, KV, hd, window) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn(*shape, generator=g, device="cuda").bfloat16()
                       for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd),
                                     (B, H, S, hd)))
        o, lse = fa_ops.flash_attention(q, k, v, causal=True, window=window, return_lse=True)
        t = {}
        t["forward"] = device_ms(torch, lambda: fa_ops.flash_attention(
            q, k, v, causal=True, window=window), reps=args.reps)
        t["forward + lse"] = device_ms(torch, lambda: fa_ops.flash_attention(
            q, k, v, causal=True, window=window, return_lse=True), reps=args.reps)

        def bwd():
            return fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=window)

        t["backward, tensor cores"] = device_ms(torch, bwd, reps=args.reps)
        t["backward, tensor cores, eager"] = eager_ms(torch, bwd)
        t["backward, CUDA cores"] = device_ms(torch, lambda: fa_ops._launch_bwd(
            q, k, v, o, do, lse, causal=True, window=window, sm90=False), calls=5,
            reps=args.reps)
        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, is_causal=True, enable_gqa=True)

        both = device_ms(torch, lambda: torch.autograd.grad(sdpa(qs, ks, vs), (qs, ks, vs), do),
                         reps=args.reps)
        with torch.no_grad():
            fwd = device_ms(torch, lambda: sdpa(q, k, v), reps=args.reps)
        t["SDPA backward"] = both - fwd
        split = kernel_split(torch, bwd)
        clusters = ctypes.c_int(0)
        lib = _build.load("flash_attention_bwd")
        rc = lib.repro_flash_attention_bwd_dkdv_clusters(hd, H // KV, ctypes.byref(clusters))
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"{tag}: B{B} S{S} H{H} KV{KV} hd{hd} window {window} bf16, device ms per "
              f"call: " + "; ".join(f"{n} {ms:.4f}" for n, ms in t.items())
              + "; tensor-core kernels (profiler): "
              + ", ".join(f"{n} {ms:.4f}" for n, ms in sorted(split.items()))
              + f"; dK/dV clusters of {H // KV} held at once: {clusters.value} (rc {rc}), "
              f"{clusters.value * (H // KV)} of {n_sm} SMs", flush=True)
        del q, k, v, do, o, lse, qs, ks, vs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
