#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from a checkout of the repository, on a machine with a CUDA card,
``nvcc`` and PyTorch built for CUDA. It prints one line per phase and exits
non-zero at the first failure:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels (flash attention forward and backward, block
     delta, selective scan forward and backward), one ``nvcc`` per source,
     all at once;
  3. flash attention: the kernels against their plain version at the JAX
     kernel tests' cases in float32 (CUDA-core kernel) and bf16
     (tensor-core kernel) and at the five full-width shapes
     (``FLASH_SHAPES``: qwen2-1.5b: B 4, S 512, H 12, KV 2, hd 128;
     hymba-1.5b: H 25, KV 5, hd 64, window 2048; qwen3-moe-30b-a3b: H 32,
     KV 4, hd 128, 8 query heads a KV head; internvl2-76b: S 768 (256 pixel
     embeddings + 512 tokens), H 64, KV 8, hd 128; musicgen-large: H 32,
     KV 32, hd 64, one query head a KV head; ``examples/
     torch_train_100m.py``'s default: B 8, S 256, H 12, KV 3, hd 64;
     causal, bf16; each on ``fa_fwd_sm90``); kernel, plain and
     ``scaled_dot_product_attention``
     times, and the model-level ``attention()`` from (B, S, H, hd) inputs,
     which adds the layout copies around the kernel;
  4. flash backward: the forward kernels' stored log-sum-exp against its
     plain version (``attention_lse_ref``), then the backward, fed the
     forward kernel's output and lse, against its plain version
     (``attention_bwd_ref``) at the JAX kernel tests' cases in float32
     (CUDA-core route) and bf16 (tensor-core route at head_dim 64 and 128),
     at the same six shapes (bf16, all on the tensor-core route);
     tensor-core kernels (eager and CUDA graph), the CUDA-core route
     on the same bf16 inputs, plain and SDPA backward times;
  5. block delta: both kernels (the cluster kernel and the two-pass one)
     against the plain version on rows of special values (NaN, +-inf, -0,
     subnormal); the cluster kernel against the plain version on the
     float32 leaves each serving path passes it, flat and ragged (8 of
     qwen2-1.5b, 18 of hymba-1.5b, 10 of qwen3-moe-30b-a3b at 1 layer, 9
     of internvl2-76b at 1 layer, up to 4.2 GB a leaf, in 65,536-element
     rows; 8 of ``examples/torch_train_100m.py``'s model in its
     262,144-element (1 MiB) rows, the cluster kernel's 1,024-thread,
     16-block shape, 2 of them ragged); times of both
     kernels, eager and as a
     CUDA graph, and of the plain version;
  6. selective scan: the kernel against its plain version at the JAX
     kernel tests' cases in float32 and bf16 and at the hymba-1.5b serving
     shape (B 4, S 512, Di 3200, N 16, x bf16; y and the last state);
     kernel and plain times; then the scan backward kernel, fed the chunk
     states the forward kernel saves, against its plain version
     (``selective_scan_bwd_ref``) at the same cases, in float32 and bf16,
     with and without h0 and a gradient on the last state, and at
     hymba-1.5b's training shape (x and dy bf16), two calls bit-identical,
     with the launch geometry there (blocks, threads, cluster, resident
     blocks an SM, waves, registers, spills); kernel (eager and CUDA graph)
     and plain times, and the forward's device time without and with the
     chunk states;
  7. small inputs: the reduced qwen2-1.5b, hymba-1.5b, falcon-mamba-7b,
     qwen3-moe-30b-a3b, mixtral-8x7b, internvl2-76b (pixel embeddings
     before the prompt) and musicgen-large serving computations in float32
     on the card (kernels) against the same on the CPU (prefill and decode
     logits, tokens; for attention models also decode with the int8 KV
     cache, see ``SMALL_INT8_REL``), and one float32 train step of each on
     the card (flash and scan kernels in both directions) against the same
     on the CPU (loss, each leaf's gradient, the new params);
  8. the serving slice at full width, first internvl2-76b with the depth
     cut to ``VLM_LAYERS`` = 1 (2.957 G float32 parameters, 4.2 GB
     leaves): publish, refresh, serve 4 x (256 pixel embeddings + 512
     tokens) plus 32 greedy tokens, delta publish, refresh, serve with the
     bf16 cache and again with the int8 cache, then a one-block delta of
     layer 0's ``attn/wo`` published, refreshed and served; launch counts,
     dirty sets, the int8 cache against the bf16 one (``INT8_LOGIT_BOUND``,
     ``INT8_ARGMAX_AGREE``), prefill kernel vs plain path; then, after its
     trees are freed, qwen2-1.5b (28 layers, 1.54 G
     float32 parameters), then, after its trees are freed, hymba-1.5b (32
     hybrid layers, 1.66 G), then qwen3-moe-30b-a3b with the depth cut to
     ``MOE_LAYERS`` = 1 (1.245 G; its bf16 prefill is held in its own form,
     ``PREFILL_MOE_BF16_RATIO``, and the routing slots where the kernel and
     plain paths pick another expert are counted; the delta publish must
     find the updated expert block): publish, refresh, serve 4 x 512-token prompts
     plus 32 greedy tokens, in-place delta publish, refresh, serve; launch
     counts set to 0 before each run and read after it (every bf16 prefill
     attention must go to the tensor-core kernel, every block delta to the
     cluster kernel), the seconds of dirty detection, and its results
     checked;
  9. the training slice: three train steps of qwen2-1.5b, then, after its
     trees are freed, of hymba-1.5b, at full width and depth, then of
     qwen3-moe-30b-a3b at full width and 1 layer (aux loss printed, the
     routing flips of step 3 counted), on the card
     (B 4 x S 512 from ``synth_batch``, bf16 compute, remat), outside
     FaaSFS, with seconds, tokens/s, peak device memory and the launches
     per kernel (every flash forward on the tensor-core kernel, two a layer
     with the remat recompute, one flash backward a layer on the
     tensor-core route; for hymba-1.5b also two scan forward and one scan
     backward launches a layer), then one step with the plain attention and
     scan from the state before the third (no flash or scan launch; loss
     and grad norm compared); one loss-and-gradient pass of internvl2-76b at
     full width and 1 layer (4 x (256 + 512), bf16, remat) on the kernel
     path against the plain attention; one qwen2-1.5b step at full width and
     depth with ``remat_policy="dots"`` beside the default remat from the
     same state, twice in turn (seconds, peak device memory, launches; loss,
     grad norm and new params compared); then ``launch/train.run`` for qwen2-1.5b at
     full width with the depth cut to 1 layer (the FaaSFS stack is host
     Python): init, 2 transactional steps, a full checkpoint, 1 step, a
     delta checkpoint, a restore, and prefill + 32 greedy tokens served
     from the restored params, with every
     dirty set held against the exact byte compare and ``blocks_written``,
     the restore against the trainer's state and the served params against
     the restore, bit for bit;
  10. the distribution plan (``dist``) on a 1-rank NCCL group over the
     card (``launch.mesh.make_host_mesh``): one qwen2-1.5b AdamW step at
     full width and depth (B 4 x S 512, bf16) through ``plan_cell`` with
     DTensor state and batch, against the unsharded step from the same
     state (the train phase's bounds; bit-identity printed; 56 forward and
     28 backward flash launches, so the plan's ``local_map`` reaches the
     kernel); the dry run of the same cell on fake tensors against the card:
     its FLOPs must equal ``FlopCounterMode``'s count of the card step plus
     the flash kernels' formula, and the predicted peak memory and roofline
     step time (datasheet constants) are printed beside
     ``max_memory_allocated``, the device busy time (``torch.profiler``)
     and the wall time; then ``moe_ffn_a2a`` at qwen3-moe-30b-a3b's width
     (B 4 x S 512, bf16) against ``moe_ffn``, outputs and routing bit for
     bit (the exchange over one rank is an identity); the phase's seconds;
  11. the plan on four and on eight ranks (``dist_ranks``): ``python -m
     repro_torch.launch.ranks --mesh pod``, started in the background
     after the kernels' timed phases and read after the small checks, runs
     four gloo ranks as CPU processes (the card is not used) on a (2, 2)
     ``data`` x ``model`` mesh; ``--mesh multipod``, started then and read
     after the training slice, eight on a (2, 2, 2) ``pod`` x ``data`` x
     ``model`` mesh (batch over ``("pod", "data")``); both at a lower CPU
     priority (``RANKS_NICE``), so that the card phases' host work comes
     first. Each rank runs, for the reduced qwen2-1.5b, hymba-1.5b and
     qwen3-moe-30b-a3b, a planned float32 train step, a planned prefill,
     10 planned decode steps with a float32, an int8 and a bf16 cache, and
     the hill-climb's overrides (``train_rules_v2``, ``remat_policy=
     "dots"``, a ``q_chunk``, ``moe_impl="a2a"`` with no slot dropped),
     each against the same computation on plain tensors (``RANKS_TOL``),
     no ``_StridedShard`` placement made; torch's version is printed;
  12. the examples (``examples``), five subprocesses at once:
     ``examples/torch_train_100m.py --steps 2 --ckpt-every 1`` at its full
     default width (109 M parameters, 12 layers, B 8 x S 256) on the card
     (finite losses, the second checkpoint a delta, flash and block-delta
     launches above 0, every flash launch on the tensor-core kernels), and
     ``torch_serve_snapshot.py``, ``torch_elastic_workers.py``,
     ``torch_quickstart.py`` and ``torch_wordcount_functions.py`` as they
     are (``EXAMPLE_CHECKS``); the flash times at the example's shape are
     phases 3 and 4's;
  13. one JSON line of per-kernel numbers, then the result line
     ``{"ok": true, "device": {...}}``. A kernel's ``launches`` is the sum
     over the full-width runs (``launches_by_path`` splits it); its times
     and bound are at the qwen2-1.5b shapes for flash attention, its
     backward and block delta (the flash rows carry every shape of
     ``FLASH_SHAPES`` under ``by_shape``; the other block-delta paths are
     printed beside them) and at the hymba-1.5b shape for the selective
     scan and its backward. ``ms``,
     ``plain_ms`` and ``library_ms`` are eager times per call, which
     include the wrappers' host work; ``device_ms`` and
     ``library_device_ms`` are device times of the kernel calls and of
     SDPA (20 calls, 5 per block-delta leaf, captured in a CUDA graph and
     replayed).

Without a CUDA device, or outside a checkout, it exits 1 and prints no
result line. The kernels build into ``build/kernels`` of the checkout.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import resource
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor rate
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLASH_CASES = [  # tests/kernels/test_flash_attention.py
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 4, 64, True, 0),
    (1, 512, 8, 2, 128, True, 0),
    (2, 256, 4, 1, 64, True, 0),
    (2, 256, 4, 2, 64, False, 0),
    (2, 512, 4, 2, 64, True, 128),
    (1, 512, 2, 2, 64, True, 256),
    (1, 384, 4, 2, 64, True, 0),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.5e-2}
# The attention shapes of the full-width paths, bf16, causal (B, S, H, KV,
# hd, window): the serving prompts and training batches of each model.
# internvl2-76b's S is its 256 pixel embeddings plus 512 tokens, at 8
# query heads a KV head; musicgen-large's is multi-head attention (G 1).
FLASH_SHAPES = {
    "qwen2-1.5b": (4, 512, 12, 2, 128, 0),
    "hymba-1.5b": (4, 512, 25, 5, 64, 2048),
    "qwen3-moe-30b-a3b": (4, 512, 32, 4, 128, 0),
    "internvl2-76b": (4, 768, 64, 8, 128, 0),
    "musicgen-large": (4, 512, 32, 32, 64, 0),
    "torch_train_100m": (8, 256, 12, 3, 64, 0),
}
SHAPE_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "library_device_ms")
# Prefill logits of the served request (bf16, flash kernel) against the same
# prefill with the plain attention math (bf16, which rounds scores and
# probabilities to bf16 as the JAX model does): max |diff| over max |logit|.
# The bf16 matmuls of the other layers dominate: at seed 0 on the H100 both
# paths lie 4.4-4.5e-2 from a float32 prefill and 4.357e-2 from each other,
# with every argmax equal. The sharp check is in float32, where the two
# paths differ only in the attention core.
#
# hymba-1.5b's bound, 1e-1, was stated before its first full-width run: the
# attention branch differs as qwen2's does, the scan kernel and its plain
# version both run float32, and each layer averages two normalized branches
# over 32 layers; expected about 5e-2.
#
# internvl2-76b's bound, 5e-2, was stated before its first full-width run:
# one layer, so less rounding to pile up than in qwen2's 28, but its bf16
# logits come from a 8,192-wide product over a 128,256-entry head, each
# rounded to bf16 (2^-8 of a value); expected about 1e-2.
PREFILL_REL_BOUND = {"qwen2-1.5b": 5e-2, "hymba-1.5b": 1e-1, "internvl2-76b": 5e-2}
PREFILL_F32_REL_BOUND = 1e-4
# qwen3-moe-30b-a3b's bf16 check, stated before its first full-width run:
# in bf16 the kernel and plain paths round the attention differently, which
# flips near-tie expert choices among 128 gates, so one logit bound would
# test the routing's ties, not the kernel. The kernel path's error against
# the plain float32 prefill (max |diff| over max |logit|) must be at most
# this ratio times the plain bf16 path's own error against it; the routing
# slots whose expert differs between the two bf16 paths are counted.
PREFILL_MOE_BF16_RATIO = 1.25
# Flash backward, kernel against attention_bwd_ref, max |diff| over the
# gradient's largest |value|: float32 sums in another order (1.3e-6 seen
# between the plain version and JAX on the CPU); bf16 gradients round to
# bf16, up to 3.9e-3 of a value.
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# The log-sum-exp the forward kernels store, against attention_lse_ref, max
# |diff|: float32 sums in another order, and ex2.approx (2 ulp) in the
# tensor-core kernel, on values of order 1-10.
LSE_TOL = 1e-4
# The full-depth training step, kernel path against the plain attention
# path from the same state, both bf16, relative differences. Stated before
# the first run on the card: the two paths round the attention's scores and
# probabilities at other places (the prefill logits differ by 4.4e-2 of the
# largest logit); the loss averages 2,044 tokens' NLL, so expect about
# 1e-3 there, and some 1e-2 in the global gradient norm.
TRAIN_LOSS_REL = 1e-2
TRAIN_GNORM_REL = 5e-2
# Reduced qwen2-1.5b float32 train step, card against CPU: loss to 1e-5,
# each leaf's gradient to 1e-4 of its largest |g|, the new params to 1e-6
# where |g| is above 1e-3 of its leaf's largest (AdamW's first step is
# +-lr by the sign of g, which rounding may flip where g is tiny).
SMALL_TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "param": 1e-6}
# Decode with the int8 KV cache against the bf16 cache, internvl2-76b at
# full width: both caches fed the same tokens (the bf16 path's greedy ones)
# after one prefill of the 256 pixel embeddings and 512 tokens. The bounds
# are those of the reference's test_int8_kv_decode_matches_bf16, stated
# before the first run on the card: the largest |logit difference| under
# 0.35 and the argmax agreement at least 0.5. Expected: quantization moves
# K and V by up to half a step, 1/254 of each (position, head)'s largest,
# so the attention output by well under 1%, and the logits (largest about
# 9) by some 0.05.
INT8_LOGIT_BOUND = 0.35
INT8_ARGMAX_AGREE = 0.5
# The int8-cache decode of the reduced configs, card against CPU, float32
# compute. A K/V value whose quotient t / scale lies within float32
# rounding of a half step may round the other way on the two devices (t
# differs in the last bits), which moves it by one step, 1/127 of its row's
# largest, and later steps carry that on. So the quantization and the rest
# are held apart: the card's quantization of its own K/V equals the CPU's
# of the same values bit for bit (IEEE division and round half to even on
# both), and the card's logits lie within this much of the largest of the
# CPU's decode given the card's quantized values (``_quantized`` replays
# them). The attention over the dequantized cache runs in bf16, as the
# reference's (scores and probabilities rounded to bf16, one step 2^-8 of a
# value), so this is the bf16 bound of the CPU parity tests (BF16_REL in
# tests/test_torch_model.py). The bounds first stated here were 5e-3 on the
# logits against the CPU's own quantization, then 1e-4 given the card's
# values; the first runs on the card exceeded them (6.2e-3 from two values a
# step apart in the reduced internvl2-76b; 7.8e-4 in the reduced
# qwen3-moe-30b-a3b from the bf16 attention), see PERF.md.
SMALL_INT8_REL = 2e-2
# Depth of internvl2-76b's full-width runs: its 80 layers are 76 G
# parameters; one layer is 2.957 G (11.83 GB float32; embed and lm_head
# (128,256 x 8,192) 4.2 GB each, the largest leaves any path passes to
# FaaSFS or the block-delta kernel). Serving through FaaSFS has held some
# 5-7x the float32 tree in host memory; AdamW's state at one layer (params,
# gradients, m, v and the new ones) would not fit the card, so it takes a
# loss-and-gradient pass there.
VLM_LAYERS = 1
# Depth of the transactional run: the FaaSFS stack is host Python and
# commits about 0.2 GB/s (a 6.2 GB publish took 30-40 s), and a training
# transaction writes params, m and v whole (AdamW dirties every block). One
# layer (0.28 G parameters, the tied embedding most of them; 3.36 GB of
# state) keeps the whole script near half its time limit since internvl2-76b
# joined it (4 layers, 5.05 GB, until then).
TXN_LAYERS = 1
# Depth of the qwen3-moe-30b-a3b runs, full width: its 48 layers are 30.5 G
# parameters, 122 GB as the float32 tree FaaSFS publishes, more than the
# card holds; 1 layer is 1.245 G (4.98 GB, 14.9 GB of AdamW state), each
# expert leaf (1, 128, 2048, 768) 0.81 GB (2 layers until internvl2-76b's
# 4.2 GB leaves joined the script and took its time).
MOE_LAYERS = 1
# The plan on four and eight gloo ranks (``repro_torch.launch.ranks``)
# against the unsharded steps: the bounds of tests/test_torch_dist_ranks.py
# (loss and grad norm relative; new params absolute where the gradient is
# above 1e-3 of its leaf's largest; prefill and decode logits and the float32
# cache absolute; int8 scales relative, int8 values identical; the bf16
# decode's logits, and qwen3-moe's int8 decode's, within two bf16 epsilons
# of the largest logit: a float32 query element can round to the
# neighbouring bf16 value on the two paths).
RANKS_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "param": 1e-6, "prefill": 1e-5,
             "decode_f32": 1e-5, "int8_logits": 1e-5, "int8_scale": 1e-6,
             "bf16_logit_rel": 2 * 2.0 ** -7}
RANKS_INT8_AT_BF16 = ("qwen3-moe-30b-a3b",)
# the dist_ranks phase's seconds a mesh, printed beside its time (the pod
# run took 38 s on 8 idle CPU cores, the multipod one 114 s)
RANKS_BUDGET_S = {"pod": 90, "multipod": 300}
RANKS_NICE = 10
# ``examples/torch_train_100m.py`` on the card: 2 steps with a checkpoint
# after each, so that the second checkpoint is a delta against the first.
# Its FaaSFS stack is host Python (about 0.2 GB/s), and each step loads and
# commits the 1.31 GB state (params, m and v), as each checkpoint writes it:
# 4 steps with a checkpoint every 2 took 62.3 s on the H100 (PERF.md §6),
# 2 steps save two of them. The other examples run beside it.
EXAMPLE_ARGS = ("--steps", "2", "--ckpt-every", "1")
EXAMPLE_TIMEOUT_S = 300
EXAMPLE_CHECKS = {   # the other examples, each with a line it must print
    "torch_serve_snapshot.py": r"^served 15 requests across 5 snapshot versions",
    "torch_elastic_workers.py": r"^final committed step count: (\d+) \(== \1 worker commits",
    "torch_quickstart.py": r"^7\. remote commit",
    "torch_wordcount_functions.py": r"^top words: ",
}


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


_START = time.perf_counter()


def phase(name: str, msg: str) -> None:
    """One line per phase step, with the seconds since the script started."""
    print(f"[{name} +{time.perf_counter() - _START:.0f}s] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean milliseconds per call on the card, by CUDA events. Eager, the
    calls are issued from Python one after another, so a short kernel reads
    its wrapper's host time; with ``graph`` the calls are captured once into
    a CUDA graph and the graph is replayed three times, which leaves the
    device time of what the calls launch."""
    import torch

    if graph:   # a capture's warm-up runs on a side stream, as torch.cuda.graph asks
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
    else:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    run, reps = fn, iters
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, reps = g.replay, 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters if graph else 1) / reps


def ptxas_entries(log: str):
    """(entry name, registers, spill-store bytes) for each entry point in an
    ``nvcc -Xptxas -v`` log; names are demangled by ``c++filt`` where it is
    on PATH."""
    out, entry, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), spill))
            entry, spill = None, 0
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt", "-p"], input="\n".join(e for e, _, _ in out),
                               capture_output=True, text=True).stdout.split("\n")
        if len(names) >= len(out):
            out = [(n, r, sp) for n, (_, r, sp) in zip(names, out)]
    return out


def attended_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep, per (batch, head)."""
    total = 0
    for qp in range(S):
        lo = 0 if window <= 0 else max(0, qp - window + 1)
        hi = qp if causal else S - 1
        total += max(0, hi - lo + 1)
    return total


def flash_phase(torch, fa_ops, attention_ref):
    import torch.nn.functional as F

    def inputs(B, S, H, KV, hd, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return (torch.randn(B, H, S, hd, generator=g, device="cuda").to(dtype),
                torch.randn(B, KV, S, hd, generator=g, device="cuda").to(dtype),
                torch.randn(B, KV, S, hd, generator=g, device="cuda").to(dtype))

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for (B, S, H, KV, hd, causal, window) in FLASH_CASES:
            q, k, v = inputs(B, S, H, KV, hd, dtype, 42)
            got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            check(err < FLASH_TOL[name], f"flash {name} case {(B, S, H, KV, hd, causal, window)}"
                                         f" err {err} >= {FLASH_TOL[name]}")
            worst = max(worst, err / FLASH_TOL[name])
    phase("flash", f"8 reference cases x {{float32, bf16}} within tolerance "
                   f"(worst err/tol {worst:.3f}); launches: tensor-core "
                   f"{fa_ops.flash_attention.launches_sm90}, CUDA-core "
                   f"{fa_ops.flash_attention.launches_simt}")

    def serving_shape(B, S, H, KV, hd, window, tag):
        q, k, v = inputs(B, S, H, KV, hd, torch.bfloat16, 7)
        before = fa_ops.flash_attention.launches_sm90
        got = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        check(fa_ops.flash_attention.launches_sm90 == before + 1,
              f"flash {tag} serving shape: not launched on fa_fwd_sm90")
        want = attention_ref(q, k, v, causal=True, window=window)
        err = float((got.float() - want.float()).abs().max())
        check(err < FLASH_TOL["bfloat16"], f"flash {tag} serving shape err {err}")
        call = lambda: fa_ops.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
        ms = time_ms(call)
        device_ms = time_ms(call, graph=True)
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True, window=window))
        # window >= S here, so causal SDPA computes the same function
        ke, ve = k.repeat_interleave(H // KV, dim=1), v.repeat_interleave(H // KV, dim=1)
        sdpa = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True)  # noqa: E731
        lib_ms = time_ms(sdpa)
        lib_device_ms = time_ms(sdpa, graph=True)
        # the model's call: (B, S, H, hd) in and out, transposes and the
        # wrapper's .contiguous() copies around the same kernel
        qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        model_ms = time_ms(lambda: fa_ops.attention(qm, km, vm, causal=True, window=window),
                           graph=True)
        flops = 4 * hd * B * H * attended_pairs(S, True, window)
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        entry = {
            "name": "flash_attention", "route": "cuda", "route_detail": "fa_fwd_sm90",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:104",
            "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library_device_ms": lib_device_ms,
        }
        phase("flash", f"{tag}: B{B} S{S} H{H} KV{KV} hd{hd} causal window {window} bf16: "
                       f"err {err:.3e}; eager per call: kernel {ms:.4f} ms, sdpa "
                       f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms; device times (CUDA "
                       f"graph): kernel {device_ms:.4f} ms, attention() from (B, S, H, hd) "
                       f"{model_ms:.4f} ms, sdpa {lib_device_ms:.4f} ms; bound "
                       f"{entry['bound_ms']:.4f} ms "
                       f"({entry['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v, ke, ve, qm, km, vm, got, want
        torch.cuda.empty_cache()
        return entry

    shapes = {tag: serving_shape(*shape, tag) for tag, shape in FLASH_SHAPES.items()}
    return _with_shapes(shapes)


def flash_bwd_phase(torch, fa_ops, attention_lse_ref, attention_bwd_ref):
    import torch.nn.functional as F

    def inputs(B, S, H, KV, hd, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(*shape, generator=g, device="cuda").to(dtype)
                for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd))]

    def errors(q, k, v, do, causal, window, tag):
        """The forward kernel's output and lse, the lse's largest error
        against the plain version, the backward's (dq, dk, dv) errors
        against the plain backward at that output, each over the gradient's
        largest value, and the largest absolute error of the three."""
        o, lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
        lse_err = float((lse - attention_lse_ref(q, k, v, causal=causal, window=window))
                        .abs().max())
        check(lse_err <= LSE_TOL, f"flash lse {tag}: err {lse_err} > {LSE_TOL}")
        fb = fa_ops.flash_attention_bwd
        before = (fb.launches_sm90, fb.launches_simt)
        got = fb(q, k, v, o, do, lse, causal=causal, window=window)
        sm90 = fa_ops.uses_sm90_bwd(q.dtype, q.shape[-1], q.shape[1] // k.shape[1])
        check((fb.launches_sm90, fb.launches_simt) == (before[0] + sm90, before[1] + 1 - sm90),
              f"flash_bwd {tag}: launched on the wrong route")
        want = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
        errs, worst_abs = [], 0.0
        for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
            check(gg.dtype == ww.dtype and gg.shape == ww.shape
                  and bool(torch.isfinite(gg.float()).all()), f"flash_bwd {tag}: bad {name}")
            diff = float((gg.float() - ww.float()).abs().max())
            errs.append(diff / float(ww.float().abs().max()))
            worst_abs = max(worst_abs, diff)
        return o, lse, lse_err, errs, worst_abs

    worst, worst_lse = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst[name] = [0.0, 0.0, 0.0]
        for (B, S, H, KV, hd, causal, window) in FLASH_CASES:
            tag = f"{name} case {(B, S, H, KV, hd, causal, window)}"
            _, _, lse_err, errs, _ = errors(*inputs(B, S, H, KV, hd, dtype, 42), causal, window,
                                            tag)
            check(max(errs) <= BWD_TOL[name], f"flash_bwd {tag}: rel err dq/dk/dv {errs} > "
                                               f"{BWD_TOL[name]}")
            worst[name] = [max(a, b) for a, b in zip(worst[name], errs)]
            worst_lse = max(worst_lse, lse_err)
    phase("flash_bwd", f"forward lse vs plain: max abs err {worst_lse:.2e} (tol {LSE_TOL}); "
                       "8 reference cases x {float32 (CUDA-core), bf16 (tensor-core)} within "
                       "tolerance; max rel err dq/dk/dv: " + "; ".join(
                           f"{n} {' / '.join(f'{e:.2e}' for e in w)} (tol {BWD_TOL[n]})"
                           for n, w in worst.items()))

    def train_shape(B, S, H, KV, hd, window, tag):
        check(fa_ops.uses_sm90_bwd(torch.bfloat16, hd, H // KV),
              f"flash_bwd {tag}: G {H // KV} is not on the tensor-core route")
        q, k, v, do = inputs(B, S, H, KV, hd, torch.bfloat16, 7)
        o, lse, lse_err, errs, worst_abs = errors(q, k, v, do, True, window, tag)
        check(max(errs) <= BWD_TOL["bfloat16"], f"flash_bwd {tag}: rel err {errs}")
        call = lambda: fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True,  # noqa: E731
                                                  window=window)
        first = call()
        again = call()
        same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(first, again))
        check(same, f"flash_bwd {tag}: two calls on the same inputs differ")
        ms = time_ms(call)
        device_ms = time_ms(call, graph=True)
        # the CUDA-core route on the same bf16 inputs, for comparison
        simt = lambda: fa_ops._launch_bwd(q, k, v, o, do, lse, causal=True,  # noqa: E731
                                          window=window, sm90=False)
        simt_errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                     for a, b in zip(simt(), first)]
        simt_ms = time_ms(simt, iters=5, warmup=1)
        simt_device_ms = time_ms(simt, iters=5, warmup=1, graph=True)
        plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, causal=True,
                                                     window=window), iters=5, warmup=1)
        # SDPA's backward, the same function (window >= S here, so causal):
        # eager, its forward's graph kept and the backward called again;
        # device time, forward and backward captured minus the forward
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, is_causal=True, enable_gqa=True)

        out = sdpa(qs, ks, vs)
        lib_ms = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True))
        # fresh leaves, the eager graph freed: a capture may not meet autograd
        # nodes made on another stream
        del out, qs, ks, vs
        qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        both = time_ms(lambda: torch.autograd.grad(sdpa(qs, ks, vs), (qs, ks, vs), do),
                       graph=True)
        with torch.no_grad():
            fwd = time_ms(lambda: sdpa(q, k, v), graph=True)
        lib_device_ms = both - fwd
        pairs = B * H * attended_pairs(S, True, window)
        flops = 5 * 2 * hd * pairs          # Q K^T again, dV, dP, dK, dQ
        nbytes = 2 * 4 * (q.numel() + k.numel())   # q, o, dO, dq; k, v, dk, dv (bf16)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        entry = {
            "name": "flash_attention_bwd", "route": "cuda",
            "route_detail": "fa_bwd_dsum, then fa_bwd_dkdv_sm90 (clusters of H/KV) beside "
                            "fa_bwd_dq_sm90 on a second stream",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/model.py:268",
            "max_abs_err": worst_abs, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library_device_ms": lib_device_ms,
        }
        phase("flash_bwd", f"{tag}: B{B} S{S} H{H} KV{KV} hd{hd} causal window {window} bf16: "
                           f"lse err {lse_err:.2e}; rel err dq/dk/dv "
                           f"{' / '.join(f'{e:.2e}' for e in errs)}, max abs err "
                           f"{worst_abs:.3e}; two calls bit-identical; tensor-core route "
                           f"{ms:.4f} ms eager, {device_ms:.4f} ms device (CUDA graph); "
                           f"CUDA-core route {simt_ms:.4f} ms eager, {simt_device_ms:.4f} ms "
                           f"device (rel diff to the tensor-core route dq/dk/dv "
                           f"{' / '.join(f'{e:.1e}' for e in simt_errs)}); plain "
                           f"{plain_ms:.3f} ms; SDPA backward {lib_ms:.4f} ms eager, "
                           f"{lib_device_ms:.4f} ms device; bound {entry['bound_ms']:.4f} ms "
                           f"({entry['bound_by']}; {pairs / 1e6:.2f} M pairs, "
                           f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v, do, o, lse, qs, ks, vs, first, again
        torch.cuda.empty_cache()
        return entry

    shapes = {tag: train_shape(*shape, tag) for tag, shape in FLASH_SHAPES.items()}
    return _with_shapes(shapes)


def _with_shapes(shapes):
    """The first shape's entry, with every shape's numbers under
    ``by_shape``."""
    first = dict(next(iter(shapes.values())))
    first["by_shape"] = {tag: {k: e[k] for k in SHAPE_KEYS} for tag, e in shapes.items()}
    return first


def block_delta_special_check(torch, bd_ops, block_delta_flat_ref):
    """Both block-delta kernels against the plain version on rows with NaN,
    +-inf, inf - inf, a zero-sign flip, a scale that flushes to 0, subnormal
    deltas, a NaN payload change and a clean row, in float32 (65,536) and
    bf16 (131,072): q, scale and the dirty flag equal, norm2 at rtol 1e-5
    with NaN equal."""
    for dtype, be in ((torch.float32, 65536), (torch.bfloat16, 131072)):
        g = torch.Generator(device="cuda").manual_seed(11)
        old = torch.randn(10, be, generator=g, device="cuda")
        new = old + 0.01 * torch.randn(10, be, generator=g, device="cuda")
        new[1, 17] = float("nan")
        new[2, 5] = float("inf")
        new[3, 9] = -float("inf")
        old[4, 0] = new[4, 0] = float("inf")
        new[4, 1] = -float("inf")
        old[5] = new[5] = 0.0
        new[5, 3] = -0.0
        old[6] = 0.0
        new[6] = torch.randn(be, generator=g, device="cuda") * 1e-38
        old[7] = 0.0
        new[7] = torch.randn(be, generator=g, device="cuda") * 1e-39
        old[8] = 0.0
        old[8, 2] = float("nan")
        new[8] = old[8]
        old[9] = new[9]
        new, old = new.to(dtype).reshape(-1), old.to(dtype).reshape(-1)
        new.view(torch.int32 if dtype == torch.float32 else torch.int16)[8 * be + 2] += 3
        want = block_delta_flat_ref(new, old, be)
        check(want[3].tolist() == [True] * 9 + [False], "block_delta special rows: plain flag")
        for kernel in ("cluster", "two_pass"):
            got = bd_ops.block_delta_flat(new, old, be, kernel=kernel)
            tag = f"block_delta {kernel} special rows {dtype}"
            check(torch.equal(got[0], want[0]), f"{tag}: q differs")
            check(torch.equal(got[2], want[2]), f"{tag}: scale differs")
            check(torch.equal(got[3], want[3]), f"{tag}: dirty flag differs")
            a, b = got[1].cpu().double(), want[1].cpu().double()
            same = (a == b) | (a.isnan() & b.isnan()) | ((a - b).abs() <= 1e-5 * b.abs())
            check(bool(same.all()), f"{tag}: norm2 {a.tolist()} vs {b.tolist()}")
        del new, old, want, got
    phase("block_delta", "special rows (NaN, +-inf, inf - inf, -0, flushed scale, subnormal "
                         "deltas, NaN payload, clean) in float32 and bf16: cluster and two-pass "
                         "kernels equal the plain version (q, scale, flag; norm2 NaN-equal)")


def block_delta_phase(torch, bd_ops, block_delta_flat_ref, leaf_numels, block_elems, tag):
    """Each float32 leaf of at least one row, flat and ragged as the serving
    path passes it: the kernel of the route (the cluster kernel, checked by
    its counter) against the plain version, then per-leaf times summed over
    the leaves: the cluster kernel eager and as a CUDA graph, the two-pass
    kernel the same way (this call's yardstick), the plain version eager."""
    total = dict(ms=0.0, device_ms=0.0, two_pass_ms=0.0, two_pass_device_ms=0.0, plain_ms=0.0)
    total_bytes = total_ops = 0.0
    worst_norm = worst_abs = 0.0
    for i, n in enumerate(leaf_numels):
        nb = -(-n // block_elems)
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        new = torch.randn(n, generator=g, device="cuda")
        old = new + 0.01 * torch.randn(n, generator=g, device="cuda")
        step = max(1, nb // 3) * block_elems
        for r0 in range(0, n, step):                     # some clean rows
            old[r0:r0 + block_elems] = new[r0:r0 + block_elems]
        before = bd_ops.block_delta.launches_cluster
        qk, nk, sk, dk = bd_ops.block_delta_flat(new, old, block_elems)
        check(bd_ops.block_delta.launches_cluster == before + 1,
              f"block_delta leaf {i}: the serving row did not go to the cluster kernel")
        qr, nr, sr, dr = block_delta_flat_ref(new, old, block_elems)
        check(torch.equal(qk, qr), f"block_delta leaf {i}: int8 q differs")
        check(torch.equal(sk, sr), f"block_delta leaf {i}: scale differs")
        check(torch.equal(dk, dr), f"block_delta leaf {i}: dirty flag differs")
        rel = float(((nk - nr).abs() / nr.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5, f"block_delta leaf {i}: norm2 rel err {rel}")
        worst_norm = max(worst_norm, rel)
        # largest absolute difference over the kernel's outputs
        worst_abs = max(worst_abs, float((qk.int() - qr.int()).abs().max()),
                        float((sk - sr).abs().max()), float((nk - nr).abs().max()),
                        float((dk.int() - dr.int()).abs().max()))
        del qk, nk, sk, dk, qr, nr, sr, dr
        for key, kernel in (("", "cluster"), ("two_pass_", "two_pass")):
            call = lambda: bd_ops.block_delta_flat(new, old, block_elems, kernel=kernel)  # noqa: E731
            total[key + "ms"] += time_ms(call, iters=5, warmup=1)
            total[key + "device_ms"] += time_ms(call, iters=5, warmup=1, graph=True)
        total["plain_ms"] += time_ms(lambda: block_delta_flat_ref(new, old, block_elems),
                                     iters=3, warmup=1)
        total_bytes += 8 * n + nb * block_elems + 9 * nb
        total_ops += 6 * n
        del new, old
        torch.cuda.empty_cache()
    t_bytes, t_ops = total_bytes / PEAK_BYTES, total_ops / PEAK_F32_FLOPS
    entry = {
        "name": "block_delta", "route": "cuda", "route_detail": "delta_cluster_kernel",
        "source": "src/repro_torch/kernels/block_delta/csrc/block_delta.cu",
        "replaces": "src/repro/kernels/block_delta/kernel.py:36",
        "max_abs_err": worst_abs, "ms": total["ms"], "device_ms": total["device_ms"],
        "plain_ms": total["plain_ms"], "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "library_device_ms": None,
    }
    share = entry["bound_ms"] / total["ms"]
    phase("block_delta", f"{tag}: {len(leaf_numels)} leaves, {sum(leaf_numels) / 1e9:.3f} G "
                         f"float32 in {block_elems}-element rows, all on the cluster kernel: "
                         f"q, scale and flag equal, norm2 rel err {worst_norm:.2e}, max abs err "
                         f"{worst_abs:.3e}; cluster kernel {total['ms']:.3f} ms eager, "
                         f"{total['device_ms']:.3f} ms device (CUDA graph), {share:.1%} of the "
                         f"bound; two-pass kernel {total['two_pass_ms']:.3f} ms eager, "
                         f"{total['two_pass_device_ms']:.3f} ms device; plain "
                         f"{total['plain_ms']:.3f} ms; bound {entry['bound_ms']:.3f} ms "
                         f"({total_bytes / 1e9:.2f} GB)")
    return entry


SCAN_CASES = [  # tests/kernels/test_ssm_scan.py: B, S, Di, N
    (2, 64, 32, 8),
    (1, 128, 64, 16),
    (2, 96, 32, 8),
    (1, 64, 128, 16),
]
SCAN_TOL = {"float32": 2e-4, "bfloat16": 1e-1}
SM_CLOCK_HZ = 1.98e9          # H100 SXM boost clock
EX2_PER_CLOCK_SM = 16         # special-function unit exp2 rate, per SM and clock


def scan_phase(torch, scan_ops, ssm_scan_ref, selective_scan_ref):
    import torch.nn.functional as F

    def inputs(B, S, Di, N, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(B, S, Di, generator=g, device="cuda")
        dt = F.softplus(torch.randn(B, S, Di, generator=g, device="cuda") * 0.5 - 1.0)
        b = torch.randn(B, S, N, generator=g, device="cuda")
        c = torch.randn(B, S, N, generator=g, device="cuda")
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device="cuda"))
        d = torch.full((Di,), 0.5, device="cuda")
        return (x.to(dtype), dt.to(dtype), b.to(dtype), c.to(dtype),
                a_log.repeat(Di, 1), d)

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for case in SCAN_CASES:
            args = inputs(*case, dtype, 3)
            err = float((scan_ops.ssm_scan(*args).float() - ssm_scan_ref(*args).float())
                        .abs().max())
            check(err < SCAN_TOL[name], f"ssm_scan {name} case {case} err {err} "
                                        f">= {SCAN_TOL[name]}")
            worst = max(worst, err / SCAN_TOL[name])
    phase("ssm_scan", f"4 reference cases x {{float32, bf16}} within tolerance "
                      f"(worst err/tol {worst:.3f})")

    # The serving shape with the model's types: x bf16, dt, B and C float32,
    # A = -exp(A_log) with A_log rounded to bf16 as the cast layers give it.
    B, S, Di, N = 4, 512, 3200, 16
    x, dt, b, c, a_log, d = inputs(B, S, Di, N, torch.float32, 9)
    a = -torch.exp(a_log.bfloat16().float())
    errs = {}
    for xdt in (torch.float32, torch.bfloat16):
        xs = x.to(xdt)
        y, h = scan_ops.selective_scan(xs, dt, b, c, a, d)
        yr, hr = selective_scan_ref(xs, dt, b, c, a, d)
        check(y.dtype == xdt and y.shape == xs.shape and h.shape == (B, Di, N)
              and bool(torch.isfinite(y.float()).all()), "ssm_scan serving shape: bad output")
        err_y = float((y.float() - yr.float()).abs().max())
        err_h = float((h - hr).abs().max())
        if xdt == torch.bfloat16:
            # y rounds to bf16: within 1e-1, or one bf16 ulp of a larger value
            over = float(((y.float() - yr.float()).abs()
                          - yr.float().abs() * 2.0 ** -7).max())
            check(err_y < SCAN_TOL["bfloat16"] or over <= 0,
                  f"ssm_scan serving bf16 y err {err_y}")
        else:
            check(err_y < SCAN_TOL["float32"], f"ssm_scan serving float32 y err {err_y}")
        check(err_h < 2e-4, f"ssm_scan serving last state err {err_h}")
        errs[str(xdt).split(".")[1]] = (err_y, err_h)
    x = x.bfloat16()
    call = lambda: scan_ops.selective_scan(x, dt, b, c, a, d)  # noqa: E731
    ms = time_ms(call)
    device_ms = time_ms(call, graph=True)
    plain_ms = time_ms(lambda: selective_scan_ref(x, dt, b, c, a, d), iters=3, warmup=1)
    nbytes = (2 * x.numel() * x.element_size() + 4 * (dt.numel() + b.numel() + c.numel()
              + a.numel() + d.numel() + B * Di * N))
    flops = 7 * B * S * Di * N + 3 * B * S * Di
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_ms = B * S * Di * N / (n_sm * EX2_PER_CLOCK_SM * SM_CLOCK_HZ) * 1e3
    entry = {
        "name": "ssm_scan", "route": "cuda", "route_detail": "ssm_scan_kernel",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:55",
        "max_abs_err": max(errs["bfloat16"]), "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "library_device_ms": None,
    }
    phase("ssm_scan", f"hymba-1.5b: B{B} S{S} Di{Di} N{N}: y / last-state err, x bf16 "
                      f"{errs['bfloat16'][0]:.3e} / {errs['bfloat16'][1]:.3e}, x float32 "
                      f"{errs['float32'][0]:.3e} / {errs['float32'][1]:.3e}; kernel {ms:.4f} ms "
                      f"eager per call, {device_ms:.4f} ms device (CUDA graph), "
                      f"plain {plain_ms:.3f} ms, bound {entry['bound_ms']:.4f} ms "
                      f"({entry['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
                      f"{B * S * Di * N / 1e6:.1f} M expf take {exp_ms:.4f} ms at "
                      f"{EX2_PER_CLOCK_SM}/clock/SM on {n_sm} SMs at {SM_CLOCK_HZ / 1e9} GHz")
    del x, dt, b, c, a, d
    torch.cuda.empty_cache()
    return entry


# Scan backward, kernel against selective_scan_bwd_ref, max |diff| over the
# gradient's largest |value|; stated before the first run on the card:
# float32 gradients sum in another order (5.1e-7 seen between the plain
# version and jax.vjp on the CPU); dx rounds to bf16 when x is bf16, where
# one ulp is up to 7.8e-3 of a value.
SCAN_BWD_TOL = {"float32": 1e-4, "dx_bf16": 2e-2}
SCAN_GRADS = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")
# float32 operations of the scan backward per (b, t, d, n): the state again
# (dt A, (dt x) B, one FMA: 4) and the reverse step (g += C dy, the dC and
# dB terms and their sums over d, sum_n g B, g Abar h, the ddt and dA FMAs,
# Abar g: 15); one expf
SCAN_BWD_FLOPS = 19


def scan_bwd_phase(torch, scan_ops, selective_scan_ref, selective_scan_bwd_ref):
    import torch.nn.functional as F

    def inputs(B, S, Di, N, dtype, with_state, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(B, S, Di, generator=g, device="cuda")
        dt = F.softplus(torch.randn(B, S, Di, generator=g, device="cuda") * 0.5 - 1.0)
        b = torch.randn(B, S, N, generator=g, device="cuda")
        c = torch.randn(B, S, N, generator=g, device="cuda")
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device="cuda"))
        a = -torch.exp(a_log.repeat(Di, 1).bfloat16().float())
        d = torch.randn(Di, generator=g, device="cuda")
        dy = torch.randn(B, S, Di, generator=g, device="cuda").to(dtype)
        h0 = 0.5 * torch.randn(B, Di, N, generator=g, device="cuda") if with_state else None
        dh = torch.randn(B, Di, N, generator=g, device="cuda") if with_state else None
        return x.to(dtype), dt, b, c, a, d, h0, dy, dh

    def errors(args, tag):
        """Kernel against the plain version: {gradient: rel err}, the
        largest absolute error; the kernel's gradients and chunk states.
        Two calls must give the same bits."""
        x, dt, b, c, a, d, h0, dy, dh = args
        _, _, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, h0=h0, chunk_states=True)
        got = scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh)
        again = scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh)
        same = all(torch.equal(u.reshape(-1).view(torch.uint8),
                               v.reshape(-1).view(torch.uint8)) for u, v in zip(got, again))
        check(same, f"ssm_scan_bwd {tag}: two calls on the same inputs differ")
        want = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, h0=h0, dh_last=dh)
        errs, worst_abs = {}, 0.0
        for name, gg, ww in zip(SCAN_GRADS, got, want):
            if name == "dh0" and h0 is None:
                continue
            check(gg.dtype == ww.dtype and gg.shape == ww.shape
                  and bool(torch.isfinite(gg.float()).all()), f"ssm_scan_bwd {tag}: bad {name}")
            diff = float((gg.float() - ww.float()).abs().max())
            errs[name] = diff / max(float(ww.float().abs().max()), 1e-30)
            tol = SCAN_BWD_TOL["dx_bf16" if name == "dx" and x.dtype == torch.bfloat16
                               else "float32"]
            check(errs[name] <= tol, f"ssm_scan_bwd {tag}: {name} rel err {errs[name]} > {tol}")
            worst_abs = max(worst_abs, diff)
        return errs, worst_abs, hc

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for case in SCAN_CASES:
            for with_state in (False, True):
                tag = f"{name} case {case}{' h0 dh_last' if with_state else ''}"
                errs, _, _ = errors(inputs(*case, dtype, with_state, 3), tag)
                for k, e in errs.items():
                    worst[(name, k)] = max(worst.get((name, k), 0.0), e)
    phase("ssm_scan_bwd", "4 reference cases x {float32, bf16} x {no h0, h0 + dh_last} within "
                          "tolerance, two calls bit-identical; max rel err: " + "; ".join(
                              f"{n} " + " ".join(f"{k} {worst[(n, k)]:.1e}" for k in SCAN_GRADS)
                              for n in ("float32", "bfloat16")))

    # hymba-1.5b's training shape with the model's types: x and dy bf16,
    # dt, B, C float32, A from A_log rounded to bf16; no h0, as in training
    B, S, Di, N = 4, 512, 3200, 16
    geo = scan_ops.selective_scan_bwd_geometry(B, S, Di, N)
    phase("ssm_scan_bwd", f"hymba-1.5b launch: {geo['blocks']} blocks of {geo['threads']} "
                          f"threads in clusters of {geo['cluster']}; {geo['blocks_per_sm']} blocks "
                          f"({geo['warps_per_sm']} warps) resident an SM, "
                          f"{geo['clusters_resident']} clusters at once on {geo['sms']} SMs: "
                          f"{geo['waves']:.3f} waves; {geo['registers']} registers, "
                          f"{geo['local_bytes']} B local a thread, {geo['smem_bytes']} B shared "
                          f"a block")
    check(geo["local_bytes"] == 0, "ssm_scan_bwd: the training shape's kernel spills")
    args = inputs(B, S, Di, N, torch.bfloat16, False, 9)
    x, dt, b, c, a, d, _, dy, _ = args
    errs, worst_abs, hc = errors(args, "hymba-1.5b")
    call = lambda: scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy,  # noqa: E731
                                               chunk_states=hc)
    ms = time_ms(call)
    device_ms = time_ms(call, graph=True)
    plain_ms = time_ms(lambda: selective_scan_bwd_ref(x, dt, b, c, a, d, dy, chunk_states=hc),
                       iters=3, warmup=1)
    # the forward as served (no chunk states) and as trained (with them)
    fwd_ms = time_ms(lambda: scan_ops.selective_scan_fwd(x, dt, b, c, a, d), graph=True)
    fwd_hc_ms = time_ms(lambda: scan_ops.selective_scan_fwd(x, dt, b, c, a, d,
                                                            chunk_states=True), graph=True)
    n = B * S * Di * N
    # each once: x, dy, dx; dt, ddt; the chunk states; b, c, db, dc; a, d, da, dd
    nbytes = (3 * x.numel() * x.element_size() + 4 * 2 * dt.numel() + 4 * hc.numel()
              + 4 * 2 * (b.numel() + c.numel()) + 4 * 2 * (a.numel() + d.numel()))
    flops = SCAN_BWD_FLOPS * n
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t_exp = n / (n_sm * EX2_PER_CLOCK_SM * SM_CLOCK_HZ)
    t_bytes, t_ops = nbytes / PEAK_BYTES, max(flops / PEAK_F32_FLOPS, t_exp)
    entry = {
        "name": "ssm_scan_bwd", "route": "cuda",
        "route_detail": "ssm_scan_bwd_kernel in clusters of "
                        f"{geo['cluster']} blocks, then ssm_scan_bwd_sum_kernel",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
        "replaces": None,
        "max_abs_err": worst_abs, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "library_device_ms": None,
    }
    phase("ssm_scan_bwd", f"hymba-1.5b: B{B} S{S} Di{Di} N{N} x and dy bf16: rel err "
                          + " ".join(f"{k} {e:.2e}" for k, e in errs.items())
                          + f", max abs err {worst_abs:.3e}; two calls bit-identical; kernel "
                          f"{ms:.4f} ms eager, {device_ms:.4f} ms device (CUDA graph); plain "
                          f"{plain_ms:.3f} ms; bound {entry['bound_ms']:.4f} ms "
                          f"({entry['bound_by']}; {nbytes / 1e6:.1f} MB take "
                          f"{t_bytes * 1e3:.4f} ms, {flops / 1e9:.2f} GFLOP "
                          f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms, {n / 1e6:.1f} M expf "
                          f"{t_exp * 1e3:.4f} ms); forward device time without / with chunk "
                          f"states {fwd_ms:.4f} / {fwd_hc_ms:.4f} ms")
    del args, x, dt, b, c, a, d, dy, hc
    torch.cuda.empty_cache()
    return entry


def forced_decode(torch, serve, M, cfg, params, prompts, pixels, forced, kv_dtype,
                  compute_dtype):
    """Prefill ``prompts`` (after ``pixels`` for a vlm config), seed a cache
    of ``kv_dtype`` with it, and decode the tokens ``forced`` (B, T) one
    step each: the logits of every step (B, T, V) float32, and the cache."""
    _, pc = M.prefill(cfg, params, prompts, pixel_embeds=pixels, compute_dtype=compute_dtype)
    B, T = forced.shape
    n = prompts.shape[1] + (pixels.shape[1] if pixels is not None else 0)
    cache = serve.seed_cache(cfg, pc, B, n + T, kv_dtype or compute_dtype,
                             device=prompts.device)
    out = []
    for i in range(T):
        logits, cache = M.decode_step(cfg, params, cache, forced[:, i:i + 1], n + i,
                                      compute_dtype=compute_dtype)
        out.append(logits)
    return torch.stack(out, dim=1), cache


def small_input_phase(torch, serve, M, cfg):
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # larger matrices so that greedy decoding does not collapse at this width
    normal = {d.path for d in M.param_defs(cfg) if d.init in ("normal", "out_normal")}
    flat = _flat(params)
    params = _unflat({k: t * 20 if k in normal else t for k, t in flat.items()})
    prompts = torch.randint(0, cfg.vocab_size, (4, 40), generator=torch.Generator().manual_seed(1))
    pixels = serve.request_pixel_embeds(cfg, 4, 0, "cpu") if cfg.vision_prefix else None
    gparams = _tree(params, lambda t: t.cuda())
    gpixels = pixels.cuda() if pixels is not None else None
    lc, tc = serve.generate(cfg, params, prompts, 8, compute_dtype=torch.float32,
                            pixel_embeds=pixels)
    lg, tg = serve.generate(cfg, gparams, prompts.cuda(), 8, compute_dtype=torch.float32,
                            pixel_embeds=gpixels)
    lg, tg = lg.cpu(), tg.cpu()
    check(bool(torch.isfinite(lg).all()) and lg.shape == lc.shape, "small input: bad logits")
    rel = float((lg - lc).abs().max() / lc.abs().max())
    check(rel <= 1e-4, f"small input {cfg.name}: card vs CPU logits rel err {rel}")
    check(torch.equal(tg, tc), f"small input {cfg.name}: greedy tokens differ between card "
                               f"and CPU")
    # the decode steps' logits, fed the greedy tokens, float32 cache
    dc, _ = forced_decode(torch, serve, M, cfg, params, prompts, pixels, tc[:, :8], None,
                          torch.float32)
    dg, _ = forced_decode(torch, serve, M, cfg, gparams, prompts.cuda(), gpixels,
                          tc[:, :8].cuda(), None, torch.float32)
    rel_d = float((dg.cpu() - dc).abs().max() / dc.abs().max())
    check(rel_d <= 1e-4, f"small input {cfg.name}: card vs CPU decode logits rel err {rel_d}")
    prefix = f"{cfg.vision_prefix} pixel embeds + " if pixels is not None else ""
    msg = (f"{cfg.name} float32, 4x({prefix}40) prompts + 8 tokens: card vs CPU prefill logits "
           f"rel err {rel:.2e}, decode logits {rel_d:.2e}, tokens equal")
    if cfg.has_attention:
        msg += "; int8 cache: " + small_int8_check(torch, serve, M, cfg, params, gparams,
                                                   prompts, pixels, gpixels, tc[:, :8])
    phase("small", msg)


def small_int8_check(torch, serve, M, cfg, params, gparams, prompts, pixels, gpixels, forced):
    """The decode of ``forced`` with an int8 cache on the CPU and on the
    card (float32), each quantization recorded; the card's quantizations
    done again on the CPU; the CPU's decode given the card's quantized
    values (see ``SMALL_INT8_REL``)."""
    def decode(ps, pr, px, fo, replay=None):
        with _quantized(M, replay) as calls:
            logits, _ = forced_decode(torch, serve, M, cfg, ps, pr, px, fo, torch.int8,
                                      torch.float32)
        return logits.cpu(), calls

    lc, calls_c = decode(params, prompts, pixels, forced)
    lg, calls_g = decode(gparams, prompts.cuda(), gpixels, forced.cuda())
    check(len(calls_c) == len(calls_g), f"small int8 {cfg.name}: quantize calls differ")
    n_vals = n_apart = 0
    for (_, qc, _), (tg, qg, sg) in zip(calls_c, calls_g):
        q, scale = M.quantize_kv(tg.cpu())
        check(torch.equal(q, qg.cpu()) and torch.equal(scale, sg.cpu()),
              f"small int8 {cfg.name}: the card's quantization differs from the CPU's on the "
              f"same values")
        n_vals += qc.numel()
        n_apart += int((qg.cpu() != qc).sum())
    lr, _ = decode(params, prompts, pixels, forced, replay=[(q, s) for _, q, s in calls_g])
    rel_own = float((lg - lc).abs().max() / lc.abs().max())
    rel = float((lg - lr).abs().max() / lr.abs().max())
    check(rel <= SMALL_INT8_REL, f"small int8 {cfg.name}: logits vs the CPU given the card's "
                                 f"int8 values rel {rel}")
    return (f"the card's quantization bit-identical to the CPU's on its values; decode logits "
            f"rel err {rel:.2e} given the card's int8 values (bound {SMALL_INT8_REL}); against "
            f"the CPU's own quantization {n_apart} of {n_vals} int8 values differ, logits {rel_own:.2e}")


@contextlib.contextmanager
def _quantized(M, replay=None):
    """Records (t, q, scale) of every ``M.quantize_kv`` call inside the
    block (prefill seeding and decode look it up in the module at each
    call); with ``replay``, a list of (q, scale) in call order, returns
    those (moved to t's device) instead of quantizing."""
    calls, real = [], M.quantize_kv

    def record(t):
        if replay is None:
            q, scale = real(t)
        else:
            q, scale = (x.to(t.device) for x in replay[len(calls)])
            check(q.shape == t.shape, "int8 replay: the quantize calls differ in shape")
        calls.append((t, q, scale))
        return q, scale

    M.quantize_kv = record
    try:
        yield calls
    finally:
        M.quantize_kv = real


def _grads(torch, M, cfg, params, batch, **kw):
    """{leaf path: gradient} of ``loss_fn`` at ``params``, as the train step
    takes it, and the loss."""
    flat = _flat(params)
    ps = {k: t.detach().requires_grad_(True) for k, t in flat.items()}
    total, metrics = M.loss_fn(cfg, _unflat(ps), batch, **kw)
    grads = torch.autograd.grad(total, list(ps.values()))
    return float(metrics["loss"].detach()), dict(zip(ps, grads))


def small_train_phase(torch, M, runtime, adamw, synth, counters, cfg):
    """One float32 train step of the reduced config on the card (kernels)
    and on the CPU (plain versions), and the gradients of the same loss."""
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth(cfg, 2, 64)
    plan = runtime.CellPlan(cfg, runtime.ShapeCell("t", "train", 64, 2), ce_chunk=32,
                            compute_dtype=torch.float32)
    step = runtime.make_train_step(plan, adamw.AdamWConfig())
    new_c, m_c = step(state, batch)
    bwd = (counters["flash_attention_bwd"], counters["ssm_scan_bwd"])
    before = [c.launches for c in bwd]
    new_g, m_g = step(_tree(state, lambda t: t.cuda()), batch)
    L = cfg.num_layers
    want = [L if cfg.has_attention else 0, L if cfg.has_ssm else 0]
    check([c.launches - b for c, b in zip(bwd, before)] == want,
          f"small train {cfg.name}: backward launches (flash, scan) differ from {want}")
    kw = dict(compute_dtype=torch.float32, ce_chunk=32)
    loss_c, g_c = _grads(torch, M, cfg, params, runtime.batch_to_device(batch, "cpu"), **kw)
    loss_g, g_g = _grads(torch, M, cfg, _tree(params, lambda t: t.cuda()),
                         runtime.batch_to_device(batch, "cuda"), **kw)
    tol = SMALL_TRAIN_TOL
    rel_loss = abs(m_g["loss"] - m_c["loss"]) / abs(m_c["loss"])
    check(rel_loss <= tol["loss"] and abs(loss_g - loss_c) <= tol["loss"] * abs(loss_c),
          f"small train {cfg.name}: card vs CPU loss {m_g['loss']} vs {m_c['loss']}")
    worst_g = worst_p = 0.0
    for path, gc in g_c.items():
        gg = g_g[path].cpu()
        err = float((gg - gc).abs().max() / gc.abs().max().clamp_min(1e-30))
        check(err <= tol["grad"], f"small train {cfg.name}: {path} gradient rel err {err}")
        worst_g = max(worst_g, err)
        pc, pg = _flat(new_c["params"])[path], _flat(new_g["params"])[path].cpu()
        big = gc.abs() > 1e-3 * gc.abs().max()
        diff = float((pg - pc).abs()[big].max()) if bool(big.any()) else 0.0
        check(diff <= tol["param"], f"small train {cfg.name}: {path} new params differ by {diff}")
        worst_p = max(worst_p, diff)
    phase("small", f"{cfg.name} float32 train step, B2 x S64: card vs CPU loss rel err "
                   f"{rel_loss:.2e}, gradients max rel err {worst_g:.2e} (of each leaf's "
                   f"largest), new params max abs diff {worst_p:.2e} where |g| is above 1e-3 "
                   f"of its leaf's largest")


def train_full_phase(torch, M, runtime, adamw, synth, counters, moe_mod, cfg):
    """Three train steps at full width on the card, outside FaaSFS; then
    one step with the plain attention and scan from the state before the
    third. For MoE, the routing of both step-3 forwards is recorded and the
    slots whose expert differs are counted."""
    B, S = 4, 512
    fa, fb = counters["flash_attention"], counters["flash_attention_bwd"]
    sf, sb = counters["ssm_scan"], counters["ssm_scan_bwd"]

    def split():
        return (fa.launches_sm90, fa.launches_simt, fb.launches_sm90, fb.launches_simt,
                sf.launches, sb.launches)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=2, decay_steps=100)
    plan = runtime.CellPlan(cfg, runtime.ShapeCell("t", "train", S, B), ce_chunk=512)
    step = runtime.make_train_step(plan, opt_cfg)
    _reset(counters)
    secs, metrics, launches = [], [], []
    kept = None
    for i in range(3):
        batch = synth(cfg, B, S, step=i)
        if i == 2:
            kept, kept_batch = state, batch
        before = split()
        t0 = time.perf_counter()
        with _routing_recorded(moe_mod) as ids_kernel:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append(m)
        launches.append(tuple(a - b for a, b in zip(split(), before)))
    path_launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_layers
    # remat: two forward launches a layer, one backward
    La, Ls = (L if cfg.has_attention else 0), (L if cfg.has_ssm else 0)
    want = (2 * La, 0, La, 0, 2 * Ls, Ls)
    for i, got in enumerate(launches):
        check(got == want, f"train step {i + 1}: launches (flash forward sm90, simt, flash "
                           f"backward sm90, simt, scan forward, scan backward) {got}, want "
                           f"{want}")
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()), f"train step metrics not finite: {m}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    tokens = B * S
    aux = f"; aux loss {_join(m['aux_loss'] for m in metrics)}" if cfg.is_moe else ""
    phase("train", f"{cfg.name} full width, {L} layers ({cfg.param_count()} params), "
                   f"B{B} x S{S}, bf16 compute, remat: step seconds "
                   f"{', '.join(f'{t:.3f}' for t in secs)}; tokens/s "
                   f"{', '.join(f'{tokens / t:.0f}' for t in secs)}; loss "
                   f"{_join(m['loss'] for m in metrics)}{aux}; grad norm "
                   f"{_join(m['grad_norm'] for m in metrics)}; peak device memory "
                   f"{peak:.1f} GiB; init {init_s:.1f} s; launches per step: flash "
                   f"{launches[0][0]} forward, all on fa_fwd_sm90 (CUDA-core "
                   f"{launches[0][1]}), {launches[0][2]} backward, all on the tensor-core "
                   f"route (CUDA-core {launches[0][3]}); scan {launches[0][4]} forward, "
                   f"{launches[0][5]} backward")
    plain = runtime.make_train_step(
        runtime.CellPlan(cfg, runtime.ShapeCell("t", "train", S, B), ce_chunk=512,
                         attn_impl="plain", scan_impl="plain"), opt_cfg)
    before = split()
    t0 = time.perf_counter()
    with _routing_recorded(moe_mod) as ids_plain:
        new, m_plain = plain(kept, kept_batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(split() == before, "the plain step launched a flash or scan kernel")
    # the forward's L routings come first, the remat recompute's after them
    flips = _routing_flips(ids_kernel[:L], ids_plain[:L]) if cfg.is_moe else None
    del new, kept
    gc.collect()
    torch.cuda.empty_cache()
    m_k = metrics[2]
    r_loss = abs(m_k["loss"] - m_plain["loss"]) / abs(m_plain["loss"])
    r_norm = abs(m_k["grad_norm"] - m_plain["grad_norm"]) / abs(m_plain["grad_norm"])
    routing = (f"; routing slots whose expert differs between the two forwards: {flips[0]} "
               f"of {flips[1]}; aux loss {m_k['aux_loss']:.6f} vs {m_plain['aux_loss']:.6f}"
               if flips else "")
    check(r_loss <= TRAIN_LOSS_REL and r_norm <= TRAIN_GNORM_REL,
          f"train step 3, kernel vs plain path: loss rel {r_loss}, grad norm rel {r_norm}"
          + routing)
    phase("train", f"{cfg.name} step 3, kernel path vs plain path (attention and scan) from "
                   f"the same state: loss "
                   f"{m_k['loss']:.6f} vs {m_plain['loss']:.6f} (rel {r_loss:.2e}, bound "
                   f"{TRAIN_LOSS_REL}), grad norm {m_k['grad_norm']:.6f} vs "
                   f"{m_plain['grad_norm']:.6f} (rel {r_norm:.2e}, bound {TRAIN_GNORM_REL}); "
                   f"plain step {plain_s:.3f} s{routing}")
    return path_launches


@contextlib.contextmanager
def _routing_recorded(moe_mod):
    """Collects the expert ids of every ``top_k_routing`` call inside the
    block (``moe_ffn`` looks the function up in its module at each call)."""
    ids, real = [], moe_mod.top_k_routing

    def record(logits, k):
        weights, chosen = real(logits, k)
        ids.append(chosen)
        return weights, chosen

    moe_mod.top_k_routing = record
    try:
        yield ids
    finally:
        moe_mod.top_k_routing = real


def _routing_flips(ids_a, ids_b):
    """(slots whose expert differs, slots) over two runs' routings."""
    diff = sum(int((a != b).sum()) for a, b in zip(ids_a, ids_b))
    return diff, sum(a.numel() for a in ids_a)


def train_txn_phase(torch, M, train, bridge, exact_dirty_blocks, flatten_with_names, counters,
                    cfg):
    """``launch/train.run``: the transactional slice at full width, depth cut."""
    torch.cuda.reset_peak_memory_stats()
    rss = _PeakRss()
    _reset(counters)
    t0 = time.perf_counter()
    r = train.run(cfg, device="cuda", steps=3, batch=4, seq=512, ckpt_every=2, seed=0,
                  serve_tokens=32, keep_states=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    fa, fb = counters["flash_attention"], counters["flash_attention_bwd"]
    bd = counters["block_delta"]
    L = cfg.num_layers
    # 3 steps of 2 L forward (remat) and L backward launches, one prefill of L
    want_fa = {"sm90": 3 * 2 * L + L, "simt": 0, "bwd_sm90": 3 * L, "bwd_simt": 0}
    got_fa = {"sm90": fa.launches_sm90, "simt": fa.launches_simt,
              "bwd_sm90": fb.launches_sm90, "bwd_simt": fb.launches_simt}
    check(got_fa == want_fa, f"transactional run: flash launches {got_fa}, want {want_fa}")
    # float32 leaves of at least one block: params, m and v per step, and
    # the delta checkpoint's detection of the same
    big = sum(1 for d in M.param_defs(cfg) if math.prod(d.shape) >= train.BLOCK_BYTES // 4)
    want_bd = {"cluster": 4 * 3 * big, "two_pass": 0}
    got_bd = {"cluster": bd.launches_cluster, "two_pass": bd.launches_two_pass}
    check(got_bd == want_bd, f"transactional run: block_delta launches {got_bd}, want {want_bd}")
    phase("train_txn", f"{cfg.name} at full width, depth cut to {L} layers "
                       f"({cfg.param_count()} params; the state, params + m + v, "
                       f"{3 * 4 * cfg.param_count() / 1e9:.2f} GB): run {wall:.1f} s; launches "
                       f"{launches}; flash by kernel {got_fa}; block_delta by kernel {got_bd}")

    bb = train.BLOCK_BYTES
    for i, res in enumerate(r.steps):
        old, new = bridge.flat_tensors(r.states[i]), bridge.flat_tensors(r.states[i + 1])
        for name, t in new.items():
            exact = exact_dirty_blocks(t, old[name], bb)
            check(res.dirty[name] == exact, f"step {i + 1} {name}: kernel dirty set "
                                            f"{res.dirty[name]} != exact {exact}")
        n_dirty = sum(len(v) for v in res.dirty.values())
        check(n_dirty == res.blocks_written and n_dirty > 0,
              f"step {i + 1}: dirty {n_dirty} != blocks_written {res.blocks_written}")
        check(res.step == i + 1, f"step counter {res.step} after {i + 1} steps")
    check(int(r.states[-1]["opt"]["count"]) == 3, "optimizer count is not 3 after 3 steps")
    full, delta = r.saves
    check(full.dirty is None and delta.dirty is not None, "want a full, then a delta checkpoint")
    old, new = bridge.flat_tensors(r.states[2]), bridge.flat_tensors(r.states[3])
    for name, t in new.items():
        exact = exact_dirty_blocks(t, old[name], bb)
        check(delta.dirty[name] == exact, f"delta checkpoint {name}: dirty set != exact")
    n_delta = sum(len(v) for v in delta.dirty.values())
    check(n_delta == delta.blocks_written, f"delta checkpoint: dirty {n_delta} != "
                                           f"blocks_written {delta.blocks_written}")
    phase("train_txn", f"each step's kernel dirty set == exact byte compare == blocks_written "
                       f"({', '.join(str(s.blocks_written) for s in r.steps)} of "
                       f"{full.blocks_written} blocks); delta checkpoint likewise "
                       f"({delta.blocks_written} blocks, {delta.bytes_written} of "
                       f"{delta.bytes_total} B; detection {delta.detect_s:.4f} s); step counter "
                       f"{r.steps[-1].step}")

    check(r.restored_step == 3, f"restored step {r.restored_step}")
    host = dict(flatten_with_names(r.restored))
    dev = bridge.flat_tensors(bridge.params_from_numpy(r.restored, "cuda"))
    for name, want in bridge.flat_tensors(r.states[-1]).items():
        check(host[name].tobytes() == want.cpu().numpy().tobytes(),
              f"{name}: restored host bytes differ from the trainer's state")
        check(torch.equal(dev[name].reshape(-1).view(torch.uint8),
                          want.reshape(-1).view(torch.uint8)),
              f"{name}: restored device tensor differs from the trainer's state")
    served = bridge.flat_tensors({"params": r.serve_slice.device_params()})
    snap = dict(flatten_with_names(r.serve_slice.server.params))
    for name, t in served.items():
        check(torch.equal(t.view(torch.int32), dev[name].view(torch.int32)),
              f"{name}: served device params differ from the restored ones")
        check(snap[name].tobytes() == host[name].tobytes(),
              f"{name}: served snapshot bytes differ from the restored ones")
    logits, toks = r.served
    check(logits.shape == (4, cfg.vocab_size) and bool(torch.isfinite(logits).all())
          and toks.shape == (4, 33), "transactional run: bad served outputs")
    peak_rss = rss.stop()
    phase("train_txn", f"restore (delta chain over step 2) bit-identical to the trainer's "
                       f"state on card and host; served params bit-identical to the restored "
                       f"ones; losses {_join(s.metrics['loss'] for s in r.steps)}; "
                       f"stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                     r.seconds.items())
          + f"; peak host RSS {peak_rss:.1f} GiB; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def _join(values, fmt: str = ".4f") -> str:
    return ", ".join(format(v, fmt) for v in values)


def _reset(counters) -> None:
    for fn in counters.values():
        for attr in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(fn, attr, 0)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


def _unflat(flat):
    tree = {}
    for path, t in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return 0.0


class _PeakRss:
    """Peak host RSS over a phase, sampled every 20 ms by a thread (the
    process's own high-water mark can be reset only where
    ``/proc/self/clear_refs`` is writable, which containers may forbid)."""

    def __init__(self):
        self.peak = _rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, _rss_gib())

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return max(self.peak, _rss_gib())


def full_width_phase(torch, serve, M, counters, bridge, exact_dirty_blocks,
                     flatten_with_names, moe_mod, cfg):
    B, S, T = 4, 512, 32
    torch.cuda.reset_peak_memory_stats()
    rss = _PeakRss()
    _reset(counters)
    t0 = time.perf_counter()
    run = serve.run(cfg, device="cuda", batch=B, prompt_len=S, tokens=T, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    fa, bd = counters["flash_attention"], counters["block_delta"]
    split = {"sm90": fa.launches_sm90, "simt": fa.launches_simt}
    bd_split = {"cluster": bd.launches_cluster, "two_pass": bd.launches_two_pass}
    phase("serve", f"{cfg.name}, {cfg.num_layers} layers: {cfg.param_count()} params, run "
                   f"{wall:.1f} s; launches "
                   f"{launches}; flash_attention by kernel {split}; block_delta by kernel "
                   f"{bd_split}")
    on_path = {"flash_attention": cfg.has_attention, "block_delta": True,
               "ssm_scan": cfg.has_ssm}
    for name, used in on_path.items():
        check(launches[name] > 0 or not used,
              f"{name} kernel never launched on the {cfg.name} serving path")
    # two requests, one bf16 prefill each, one attention per layer
    want_sm90 = 2 * cfg.num_layers if cfg.has_attention else 0
    check(split == {"sm90": want_sm90, "simt": 0},
          f"{cfg.name}: flash launches by kernel {split}, want all {want_sm90} on the "
          f"tensor-core kernel")
    # one delta publish, one launch per float32 leaf of at least one block
    want_bd = sum(1 for d in M.param_defs(cfg) if math.prod(d.shape) >= serve.BLOCK_BYTES // 4)
    check(bd_split == {"cluster": want_bd, "two_pass": 0},
          f"{cfg.name}: block_delta launches by kernel {bd_split}, want all {want_bd} on the "
          f"cluster kernel")

    for tag, (logits, toks) in (("v0", run.out_v0), ("v1", run.out_v1)):
        check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
              f"{tag}: prefill logits not finite of shape (B, V)")
        check(toks.shape == (B, T + 1) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"{tag}: bad token ids")
    sl = run.slice
    served = sl.device_params()
    cast = M.cast_params(served, torch.bfloat16)
    t0 = time.perf_counter()
    sl.serve(run.prompts)
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    t0 = time.perf_counter()
    M.prefill(cfg, cast, run.prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    plain_impls = dict(attn_impl="plain", scan_impl="plain")
    with _routing_recorded(moe_mod) as ids_plain:
        plain, _ = M.prefill(cfg, cast, run.prompts, **plain_impls)
    with _routing_recorded(moe_mod) as ids_kernel:
        kern_again, _ = M.prefill(cfg, cast, run.prompts)
    k32, _ = M.prefill(cfg, served, run.prompts, compute_dtype=torch.float32)
    p32, _ = M.prefill(cfg, served, run.prompts, compute_dtype=torch.float32, **plain_impls)
    kern = run.out_v1[0]
    check(torch.equal(kern_again, kern), "the kernel prefill differs from the served one")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    r_bf16, r_f32 = rel(kern, plain), rel(k32, p32)
    r_kern, r_plain = rel(kern, p32), rel(plain, p32)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    if cfg.is_moe:
        flips, slots = _routing_flips(ids_kernel, ids_plain)
        check(r_kern <= PREFILL_MOE_BF16_RATIO * r_plain,
              f"prefill logits bf16: kernel path {r_kern} from float32, over "
              f"{PREFILL_MOE_BF16_RATIO} x the plain path's {r_plain} ({flips} of {slots} "
              f"routing slots differ)")
        bf16 = (f"bf16 paths vs the plain float32 prefill: kernel {r_kern:.3e}, plain "
                f"{r_plain:.3e} (bound: kernel <= {PREFILL_MOE_BF16_RATIO} x plain, "
                f"{r_kern / r_plain:.3f} x); bf16 kernel vs plain rel err {r_bf16:.3e}, "
                f"argmax agreement {agree:.2f}, routing slots whose expert differs "
                f"{flips} of {slots}")
    else:
        bound = PREFILL_REL_BOUND[cfg.name]
        check(r_bf16 <= bound, f"prefill logits bf16: kernel vs plain rel err {r_bf16}")
        bf16 = (f"bf16 rel err {r_bf16:.3e} (bound {bound}, argmax agreement {agree:.2f}); "
                f"bf16 paths vs float32: kernel {r_kern:.3e}, plain {r_plain:.3e}")
    check(r_f32 <= PREFILL_F32_REL_BOUND, f"prefill logits f32: kernel vs plain rel err {r_f32}")
    phase("serve", f"prefill logits, kernel path vs plain path: float32 rel err {r_f32:.3e} "
                   f"(bound {PREFILL_F32_REL_BOUND}); {bf16}")
    del plain, k32, p32, cast, kern_again

    dirty = run.publish_v1.dirty
    old = bridge.flat_tensors({"params": run.params_v0})
    new = bridge.flat_tensors({"params": run.params_v1})
    for name in new:
        exact = exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
        check(dirty[name] == exact, f"{name}: kernel dirty set {dirty[name]} != exact {exact}")
    n_dirty = sum(len(v) for v in dirty.values())
    written = run.publish_v1.stats["blocks_written"]
    check(n_dirty == written and n_dirty > 0, f"dirty {n_dirty} != blocks_written {written}")
    check(not cfg.is_moe or bool(dirty.get("params/layers/moe/wi")),
          "delta publish: the updated expert block of moe/wi was not found")
    phase("serve", f"delta publish: kernel dirty set == exact byte compare == blocks_written "
                   f"({n_dirty} of {run.publish_v0.stats['blocks_written']} blocks; "
                   f"{', '.join(f'{k}:{len(v)}' for k, v in dirty.items() if v)}); dirty "
                   f"detection {run.publish_v1.detect_seconds:.4f} s of the "
                   f"{run.publish_v1.seconds:.3f} s publish")

    host = dict(flatten_with_names(sl.server.params))
    dev = bridge.flat_tensors({"params": served})
    for name, want in new.items():
        check(torch.equal(dev[name].view(torch.int32), want.view(torch.int32)),
              f"{name}: served device params differ from the published ones")
        check(host[name].tobytes() == want.cpu().numpy().tobytes(),
              f"{name}: served snapshot bytes differ from the published ones")
    up = sl.snapshot.stats
    check(up.last_blocks == dirty, "device refresh moved other blocks than the dirty ones")
    moved_v1 = up.bytes_moved - sum(t.numel() * t.element_size() for t in new.values())
    phase("serve", f"after refresh: served params bit-identical to v1 on card and host; "
                   f"device update moved exactly the {up.blocks_moved} dirty blocks "
                   f"({moved_v1} B); FaaSFS refresh read {sl.server.stats.refresh_bytes} B "
                   f"over 2 refreshes")
    secs = dict(run.seconds, serve_v1_pinned=again, prefill_alone=prefill_s,
                device_update=up.seconds)
    whole = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    phase("serve", "times (s): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; peak host RSS {rss.stop():.1f} GiB (this phase; whole process {whole:.1f}); "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def vlm_serve_phase(torch, serve, M, counters, bridge, exact_dirty_blocks, flatten_with_names,
                    cfg):
    """internvl2-76b at full width, depth cut: ``serve.run`` (v0 and v1
    served with the bf16 cache), v1 served again with the int8 cache, then
    v2, one block of layer 0's ``attn/wo`` changed, published in place,
    refreshed and served. Counts are read over these; then the checks."""
    B, S, T, P = 4, 512, 32, cfg.vision_prefix
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    rss = _PeakRss()
    _reset(counters)
    t0 = time.perf_counter()
    run = serve.run(cfg, device="cuda", batch=B, prompt_len=S, tokens=T, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sl = run.slice
    sl.kv_dtype = torch.int8
    t0 = time.perf_counter()
    out8 = sl.serve(run.prompts)
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    sl.kv_dtype = None
    # v2: one value of layer 0's attn/wo, in its block 5 (65,536 floats a block)
    params_v2 = {**run.params_v1, "layers": {**run.params_v1["layers"]}}
    attn = dict(params_v2["layers"]["attn"])
    wo = attn["wo"].clone()
    block_elems = serve.BLOCK_BYTES // 4
    wo.view(-1)[5 * block_elems + 3 * cfg.d_model + 17] += 0.01
    attn["wo"] = wo
    params_v2["layers"]["attn"] = attn
    pub2 = sl.publish(params_v2)
    t0 = time.perf_counter()
    sl.refresh()
    refresh2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2 = sl.serve(run.prompts)
    torch.cuda.synchronize()
    serve2_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    fa, bd = counters["flash_attention"], counters["block_delta"]
    split = {"sm90": fa.launches_sm90, "simt": fa.launches_simt}
    bd_split = {"cluster": bd.launches_cluster, "two_pass": bd.launches_two_pass}
    leaves = sum(1 for d in M.param_defs(cfg) if math.prod(d.shape) >= block_elems)
    largest = max(math.prod(d.shape) for d in M.param_defs(cfg)) * 4
    phase("serve", f"{cfg.name}, {L} layer(s): {cfg.param_count()} params, largest leaf "
                   f"{largest / 1e9:.2f} GB; serve.run {wall:.1f} s, then v1 with the int8 "
                   f"cache, then v2 published, refreshed, served; launches {launches}; "
                   f"flash_attention by kernel {split}; block_delta by kernel {bd_split}")
    # four requests of one prefill each (v0, v1, v1 int8, v2), one attention a layer
    check(split == {"sm90": 4 * L, "simt": 0},
          f"{cfg.name}: flash launches by kernel {split}, want all {4 * L} on fa_fwd_sm90")
    # two delta publishes, one launch per float32 leaf of at least one block
    check(bd_split == {"cluster": 2 * leaves, "two_pass": 0},
          f"{cfg.name}: block_delta launches by kernel {bd_split}, want all {2 * leaves} on "
          f"the cluster kernel")
    for tag, (logits, toks) in (("v0", run.out_v0), ("v1", run.out_v1), ("v1 int8", out8),
                                ("v2", out2)):
        check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
              f"{tag}: prefill logits not finite of shape (B, V)")
        check(toks.shape == (B, T + 1) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"{tag}: bad token ids")
    check(torch.equal(out8[0], run.out_v1[0]), "the int8 request's prefill differs")
    greedy_agree = float((out8[1] == run.out_v1[1]).float().mean())

    # the delta publishes
    for tag, pub, old_p, new_p in (("v1", run.publish_v1, run.params_v0, run.params_v1),
                                   ("v2", pub2, run.params_v1, params_v2)):
        old = bridge.flat_tensors({"params": old_p})
        new = bridge.flat_tensors({"params": new_p})
        for name in new:
            exact = exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
            check(pub.dirty[name] == exact, f"{tag} {name}: kernel dirty set {pub.dirty[name]} "
                                            f"!= exact {exact}")
        n_dirty = sum(len(v) for v in pub.dirty.values())
        check(n_dirty == pub.stats["blocks_written"] and n_dirty > 0,
              f"{tag}: dirty {n_dirty} != blocks_written {pub.stats['blocks_written']}")
    check({k: v for k, v in pub2.dirty.items() if v} == {"params/layers/attn/wo": [5]},
          f"v2: dirty blocks {pub2.dirty}, want block 5 of attn/wo alone")
    served = sl.device_params()
    host = dict(flatten_with_names(sl.server.params))
    dev = bridge.flat_tensors({"params": served})
    for name, want in bridge.flat_tensors({"params": params_v2}).items():
        check(torch.equal(dev[name].view(torch.int32), want.view(torch.int32)),
              f"{name}: served device params differ from the published v2")
        check(host[name].tobytes() == want.cpu().numpy().tobytes(),
              f"{name}: served snapshot bytes differ from the published v2")
    check(sl.snapshot.stats.last_blocks == pub2.dirty,
          "device refresh of v2 moved other blocks than the dirty one")
    phase("serve", f"delta publishes: kernel dirty set == exact byte compare == "
                   f"blocks_written: v1 {run.publish_v1.stats['blocks_written']} blocks "
                   f"({', '.join(f'{k}:{len(v)}' for k, v in run.publish_v1.dirty.items() if v)}) "
                   f"of {run.publish_v0.stats['blocks_written']}; v2 block 5 of attn/wo alone, "
                   f"detection {pub2.detect_seconds:.4f} s of the {pub2.seconds:.3f} s publish; "
                   f"served v2 bit-identical on card and host, the device refresh moved that "
                   f"block alone")

    # int8 against bf16 cache, both fed v2's greedy tokens after one prefill
    cast = M.cast_params(served, torch.bfloat16)
    pixels = serve.request_pixel_embeds(cfg, B, 0, "cuda")
    forced = out2[1][:, :T]
    l16, _ = forced_decode(torch, serve, M, cfg, cast, run.prompts, pixels, forced, None,
                           torch.bfloat16)
    l8, _ = forced_decode(torch, serve, M, cfg, cast, run.prompts, pixels, forced, torch.int8,
                          torch.bfloat16)
    check(torch.equal(l16.argmax(-1), out2[1][:, 1:]),
          "the bf16 decode fed the greedy tokens does not give them back")
    diff = float((l16 - l8).abs().max())
    agree = float((l16.argmax(-1) == l8.argmax(-1)).float().mean())
    check(diff < INT8_LOGIT_BOUND and agree >= INT8_ARGMAX_AGREE,
          f"int8 vs bf16 cache: max |logit diff| {diff} (bound {INT8_LOGIT_BOUND}), argmax "
          f"agreement {agree} (bound {INT8_ARGMAX_AGREE})")
    phase("serve", f"int8 KV cache vs bf16 over {T} decode steps fed the same tokens after "
                   f"{P} pixel embeds + {S} tokens: max |logit diff| {diff:.4f} (bound "
                   f"{INT8_LOGIT_BOUND}; largest |logit| {float(l16.abs().max()):.3f}), argmax "
                   f"agreement {agree:.4f} (bound {INT8_ARGMAX_AGREE}); greedy tokens of the two "
                   f"served requests agree at {greedy_agree:.4f}")

    # prefill, kernel path vs plain path, with the vision prefix
    plain_impls = dict(attn_impl="plain")
    kern, _ = M.prefill(cfg, cast, run.prompts, pixel_embeds=pixels)
    check(torch.equal(kern, out2[0]), "the kernel prefill differs from the served one")
    plain, _ = M.prefill(cfg, cast, run.prompts, pixel_embeds=pixels, **plain_impls)
    k32, _ = M.prefill(cfg, served, run.prompts, pixel_embeds=pixels,
                       compute_dtype=torch.float32)
    p32, _ = M.prefill(cfg, served, run.prompts, pixel_embeds=pixels,
                       compute_dtype=torch.float32, **plain_impls)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    r_bf16, r_f32 = rel(kern, plain), rel(k32, p32)
    bound = PREFILL_REL_BOUND[cfg.name]
    check(r_bf16 <= bound and r_f32 <= PREFILL_F32_REL_BOUND,
          f"prefill logits, kernel vs plain: bf16 rel err {r_bf16} (bound {bound}), float32 "
          f"{r_f32} (bound {PREFILL_F32_REL_BOUND})")
    agree_p = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    phase("serve", f"prefill logits of {P} pixel embeds + {S} tokens, kernel path vs plain: "
                   f"float32 rel err {r_f32:.3e} (bound {PREFILL_F32_REL_BOUND}); bf16 "
                   f"{r_bf16:.3e} (bound {bound}, argmax agreement {agree_p:.2f}); bf16 paths "
                   f"vs float32: kernel {rel(kern, p32):.3e}, plain {rel(plain, p32):.3e}")
    del cast, kern, plain, k32, p32, l16, l8
    secs = dict(run.seconds, serve_v1_int8=int8_s, publish_v2=pub2.seconds,
                refresh_v2=refresh2_s, serve_v2=serve2_s, device_update=sl.snapshot.stats.seconds)
    phase("serve", "times (s): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; peak host RSS {rss.stop():.1f} GiB; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


def _loss_and_gnorm(torch, M, cfg, params, batch, **kw):
    """The loss and the global gradient norm of ``loss_fn`` at ``params``
    (bf16 compute, remat), gradients freed on return."""
    flat = _flat(params)
    ps = {k: t.detach().requires_grad_(True) for k, t in flat.items()}
    total, metrics = M.loss_fn(cfg, _unflat(ps), batch, ce_chunk=512, **kw)
    grads = torch.autograd.grad(total, list(ps.values()))
    gnorm = math.sqrt(sum(float(g.float().square().sum()) for g in grads))
    return float(metrics["loss"].detach()), gnorm, float(metrics["tokens"])


def vlm_train_phase(torch, M, runtime, synth, counters, cfg):
    """internvl2-76b at full width, depth cut: one loss-and-gradient pass
    (bf16, remat) on the kernel path and one on the plain attention, from
    the same params and batch (4 x (256 pixel embeds + 512 tokens))."""
    B, S = 4, 512
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = runtime.batch_to_device(synth(cfg, B, S), "cuda")
    fa, fb = counters["flash_attention"], counters["flash_attention_bwd"]

    def split():
        return (fa.launches_sm90, fa.launches_simt, fb.launches_sm90, fb.launches_simt)

    _reset(counters)
    t0 = time.perf_counter()
    loss_k, gn_k, n_tok = _loss_and_gnorm(torch, M, cfg, params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    got = split()
    check(got == (2 * L, 0, L, 0), f"{cfg.name} loss and gradients: flash launches (forward "
                                   f"sm90, simt, backward sm90, simt) {got}, want "
                                   f"{(2 * L, 0, L, 0)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    loss_p, gn_p, _ = _loss_and_gnorm(torch, M, cfg, params, batch, attn_impl="plain")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(split() == got, "the plain pass launched a flash kernel")
    r_loss, r_norm = abs(loss_k - loss_p) / abs(loss_p), abs(gn_k - gn_p) / abs(gn_p)
    check(math.isfinite(loss_k) and math.isfinite(gn_k) and r_loss <= TRAIN_LOSS_REL
          and r_norm <= TRAIN_GNORM_REL,
          f"{cfg.name} loss and gradients, kernel vs plain: loss {loss_k} vs {loss_p}, grad "
          f"norm {gn_k} vs {gn_p}")
    del params, batch
    phase("train", f"{cfg.name} full width, {L} layer(s) ({cfg.param_count()} params), "
                   f"B{B} x ({cfg.vision_prefix} pixel embeds + {S} tokens), bf16, remat: one "
                   f"loss and gradient pass {secs:.3f} s, peak device memory {peak:.1f} GiB; "
                   f"flash {got[0]} forward on fa_fwd_sm90, {got[2]} backward on the "
                   f"tensor-core route; kernel vs plain attention: loss {loss_k:.6f} vs "
                   f"{loss_p:.6f} over {n_tok:.0f} text tokens (rel {r_loss:.2e}, bound "
                   f"{TRAIN_LOSS_REL}), grad norm {gn_k:.6f} vs {gn_p:.6f} (rel {r_norm:.2e}, "
                   f"bound {TRAIN_GNORM_REL}); plain pass {plain_s:.3f} s")
    return launches


def train_dots_phase(torch, M, runtime, adamw, synth, counters, cfg):
    """One train step with ``remat_policy="dots"`` beside one with the
    default remat, from the same state and batch, twice in turn: seconds,
    peak device memory and launches of each; loss, grad norm and the new
    params compared. Then the peak device memory of the loss and gradients
    alone under each policy: the step's peak is AdamW's, after the backward
    has freed what the policy keeps."""
    B, S = 4, 512
    L = cfg.num_layers
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    batch = synth(cfg, B, S, step=0)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=2, decay_steps=100)
    fa, fb = counters["flash_attention"], counters["flash_attention_bwd"]
    steps = {p: runtime.make_train_step(runtime.CellPlan(
        cfg, runtime.ShapeCell("t", "train", S, B), ce_chunk=512, remat_policy=p), opt_cfg)
        for p in (None, "dots")}
    _reset(counters)
    res = {}
    for policy in (None, "dots", None, "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = (fa.launches_sm90, fa.launches_simt, fb.launches_sm90, fb.launches_simt)
        t0 = time.perf_counter()
        new, m = steps[policy](state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = tuple(a - b for a, b in zip((fa.launches_sm90, fa.launches_simt, fb.launches_sm90,
                                           fb.launches_simt), before))
        check(got == (2 * L, 0, L, 0), f"remat {policy}: flash launches {got}, want "
                                       f"{(2 * L, 0, L, 0)}")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        kept = res.get(policy, {}).get("params")
        res.setdefault(policy, {"secs": [], "peak": [], "m": m,
                                "params": new["params"] if kept is None else kept})
        res[policy]["secs"].append(sec)
        res[policy]["peak"].append(peak)
        del new
    launches = {name: fn.launches for name, fn in counters.items()}
    grad_peak = {}
    dev_batch = runtime.batch_to_device(batch, "cuda")
    for policy in (None, "dots"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _loss_and_gnorm(torch, M, cfg, state["params"], dev_batch, remat_policy=policy)
        grad_peak[policy] = (torch.cuda.max_memory_allocated() - base) / 2**30
    md, mp = res[None]["m"], res["dots"]["m"]
    r_loss = abs(md["loss"] - mp["loss"]) / abs(md["loss"])
    r_norm = abs(md["grad_norm"] - mp["grad_norm"]) / abs(md["grad_norm"])
    check(r_loss <= TRAIN_LOSS_REL and r_norm <= TRAIN_GNORM_REL,
          f"dots vs default remat: loss rel {r_loss}, grad norm rel {r_norm}")
    a, b = _flat(res[None]["params"]), _flat(res["dots"]["params"])
    same = md["loss"] == mp["loss"] and md["grad_norm"] == mp["grad_norm"] and all(
        torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)) for k in a)
    del res[None]["params"], res["dots"]["params"], state, dev_batch, a, b
    phase("train", f"{cfg.name} full width, {L} layers, B{B} x S{S}, one step from the same "
                   f"state, default remat / dots, twice in turn: seconds "
                   + " / ".join(_join(res[p]["secs"], ".3f") for p in (None, "dots"))
                   + "; peak device memory above the state, GiB "
                   + " / ".join(_join(res[p]["peak"], ".2f") for p in (None, "dots"))
                   + f" (of the loss and gradients alone {grad_peak[None]:.2f} / "
                     f"{grad_peak['dots']:.2f})"
                   + f"; loss {md['loss']:.6f} / {mp['loss']:.6f} (rel {r_loss:.2e}), grad norm "
                     f"{md['grad_norm']:.6f} / {mp['grad_norm']:.6f} (rel {r_norm:.2e}; bounds "
                     f"{TRAIN_LOSS_REL}, {TRAIN_GNORM_REL}); loss, grad norm and new params "
                     f"{'bit-identical' if same else 'NOT bit-identical'}; flash per step "
                     f"{2 * L} forward, {L} backward in both")
    return launches


DIST_BUDGET_S = 60           # the dist phase's seconds, printed beside its time


def dist_phase(torch, M, runtime, adamw, synth, counters, moe_mod, cfg, moe_cfg):
    """The distribution plan on a 1-rank NCCL group over the card
    (``make_host_mesh``): one train step of ``cfg`` at full width and depth
    through ``plan_cell`` (DTensor state and batch) against the unsharded
    step from the same state; the dry run of the same cell (fake tensors)
    against the card's peak memory, FLOPs and times; ``moe_ffn_a2a`` at
    ``moe_cfg``'s width against ``moe_ffn``. Returns the planned step's
    kernel launches."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, perf, roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import attention_flops

    t_start = time.perf_counter()
    B, S = 4, 512
    shape = runtime.ShapeCell("t", "train", S, B)
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=2, decay_steps=100)
    fa, fb = counters["flash_attention"], counters["flash_attention_bwd"]
    mesh = make_host_mesh("cuda")
    try:
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        state = {"params": params, "opt": adamw.init_opt_state(params)}
        del params
        batch = synth(cfg, B, S, step=0)
        plan = runtime.plan_cell(cfg, shape, mesh)
        step = runtime.make_train_step(plan, opt_cfg)
        # the DTensor state's local tensors are views of the state's
        sstate, sbatch = runtime.shard_state(plan, mesh, state), runtime.shard_batch(
            plan, mesh, batch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset(counters)
        with FlopCounterMode(display=False) as fc:
            planned, m_plan = step(sstate, sbatch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        path_launches = {name: fn.launches for name, fn in counters.items()}
        launches = (fa.launches_sm90, fa.launches_simt, fb.launches_sm90, fb.launches_simt)
        L = cfg.num_layers
        check(launches == (2 * L, 0, L, 0),
              f"dist step: flash launches (forward sm90, simt, backward sm90, simt) "
              f"{launches}, want {(2 * L, 0, L, 0)}")
        q = torch.empty(B, S, cfg.num_heads, cfg.head_dim, device="meta")
        f_fwd, f_bwd = attention_flops(q, q, q, window=cfg.sliding_window)
        n_fwd, n_bwd = fa.launches, fb.launches
        real_flops = fc.get_total_flops() + n_fwd * f_fwd + n_bwd * f_bwd
        planned = {k: t.full_tensor() for k, t in _flat(planned["params"]).items()}
        t0 = time.perf_counter()
        new, _ = step(sstate, sbatch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        del new
        trace = ROOT / "build" / "profile" / "dist_trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            new, _ = step(sstate, sbatch)
            torch.cuda.synchronize()
        del new, sstate, sbatch
        prof.export_chrome_trace(str(trace))
        busy_s = sum(perf.device_time(json.loads(trace.read_text())["traceEvents"])
                     ["kernel"].values()) / 1e3
        new, m_one = runtime.make_train_step(
            runtime.CellPlan(cfg, shape, ce_chunk=512), opt_cfg)(state, batch)
        same = all(torch.equal(t, planned[k]) for k, t in _flat(new["params"]).items())
        del new, planned, state
        gc.collect()
        torch.cuda.empty_cache()
        r_loss = abs(m_plan["loss"] - m_one["loss"]) / abs(m_one["loss"])
        r_norm = abs(m_plan["grad_norm"] - m_one["grad_norm"]) / abs(m_one["grad_norm"])
        check(r_loss <= TRAIN_LOSS_REL and r_norm <= TRAIN_GNORM_REL,
              f"dist step vs unsharded: loss rel {r_loss}, grad norm rel {r_norm}")
        phase("dist", f"{cfg.name} full width, {L} layers, B{B} x S{S}, bf16, one AdamW step "
                      f"through plan_cell on a 1-rank NCCL group vs the unsharded step from the "
                      f"same state: loss {m_plan['loss']:.6f} vs {m_one['loss']:.6f} (rel "
                      f"{r_loss:.2e}, bound {TRAIN_LOSS_REL}), grad norm "
                      f"{m_plan['grad_norm']:.6f} vs {m_one['grad_norm']:.6f} (rel {r_norm:.2e}, "
                      f"bound {TRAIN_GNORM_REL}); new params bit-identical: {same}; flash "
                      f"launches {launches[0]} forward, {launches[2]} backward (sm90)")

        t0 = time.perf_counter()
        rec = dryrun.trace_record(cfg, shape, mesh)
        trace_s = time.perf_counter() - t0
        a = rec["analysis"]
        check(a["flops_per_device"] == real_flops,
              f"dry-run FLOPs {a['flops_per_device']} != the card step's {real_flops} "
              f"(FlopCounterMode {fc.get_total_flops()} + flash formula)")
        roof = roofline.analyze(dict(rec, ok=True, shape=shape.name, mesh="host"))
        pred_peak = rec["memory"]["peak_bytes_est"]
        phase("dist", f"dry run of the same cell (1x1 mesh, fake tensors, {trace_s:.1f} s): "
                      f"FLOPs predicted {a['flops_per_device']} == card {real_flops} "
                      f"(FlopCounterMode {fc.get_total_flops()} + flash {n_fwd} x "
                      f"{f_fwd} + {n_bwd} x {f_bwd}); peak device memory predicted "
                      f"{pred_peak / 2**30:.2f} GiB vs max_memory_allocated "
                      f"{peak / 2**30:.2f} GiB (card / predicted {peak / pred_peak:.3f}); "
                      f"roofline step {roof['step_s'] * 1e3:.2f} ms ({roof['dominant']}; "
                      f"compute {roof['compute_s'] * 1e3:.2f}, memory "
                      f"{roof['memory_s'] * 1e3:.2f} ms, datasheet constants) vs device busy "
                      f"{busy_s * 1e3:.2f} ms (ratio {busy_s / roof['step_s']:.2f}) and wall "
                      f"{wall_s * 1e3:.2f} ms (ratio {wall_s / roof['step_s']:.2f})")

        g = torch.Generator(device="cuda").manual_seed(0)
        D, E, F = moe_cfg.d_model, moe_cfg.num_experts, moe_cfg.moe_d_ff

        def rnd(*shape, scale=0.02):
            return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

        x, router = rnd(B, S, D, scale=1.0), rnd(D, E)
        wi, wg, wo = rnd(E, D, F), rnd(E, D, F), rnd(E, F, D)
        kw = dict(num_experts=E, top_k=moe_cfg.num_experts_per_tok,
                  capacity_factor=moe_cfg.capacity_factor)
        with torch.no_grad():
            with _routing_recorded(moe_mod) as ids_one:
                y_one, aux_one = moe_mod.moe_ffn(x, router, wi, wg, wo, groups=1, **kw)
            with _routing_recorded(moe_mod) as ids_a2a:
                y_a2a, aux_a2a = moe_mod.moe_ffn_a2a(x, router, wi, wg, wo, mesh=mesh,
                                                     batch_axes=("data",), model_axis="model",
                                                     seq_axis="model", **kw)
        torch.cuda.synchronize()
        flips = _routing_flips(ids_one, ids_a2a)
        check(torch.equal(y_one, y_a2a) and flips[0] == 0 and len(ids_one) == len(ids_a2a),
              f"moe_ffn_a2a on one rank vs moe_ffn: max |dy| "
              f"{(y_one.float() - y_a2a.float()).abs().max().item()}, routing flips {flips}")
        dist_s = time.perf_counter() - t_start
        phase("dist", f"moe_ffn_a2a at {moe_cfg.name}'s width (d {D}, {E} experts of {F}, "
                      f"top-{kw['top_k']}, cf {kw['capacity_factor']}), B{B} x S{S} bf16 on "
                      f"the 1-rank NCCL group vs moe_ffn: outputs bit-identical, routing "
                      f"identical ({flips[1]} slots), aux loss {float(aux_a2a):.6f} vs "
                      f"{float(aux_one):.6f}; phase {dist_s:.1f} s (budget {DIST_BUDGET_S} s)")
        del x, router, wi, wg, wo, y_one, y_a2a
    finally:
        dist.destroy_process_group()
    return path_launches


def _start_script(args):
    """A Python script or module of the checkout started in a subprocess
    (``PYTHONPATH=src``), its output piped."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)


def _finish_script(proc, what: str, timeout: float) -> str:
    """The standard output of ``proc`` run to its end; fails on a non-zero
    exit, or after ``timeout`` seconds (the process killed)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise Failed(f"{what}: no end after {timeout} s")
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}: {err[-2000:]}")
    return out


def dist_ranks_start(mesh: str):
    """``python -m repro_torch.launch.ranks --mesh MESH`` started in the
    background (four or eight CPU processes, at ``RANKS_NICE``);
    ``dist_ranks_phase`` reads it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.ranks", "--mesh", mesh],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=env, start_new_session=True,
                            preexec_fn=lambda: os.nice(RANKS_NICE))
    return proc, time.perf_counter(), mesh


def dist_ranks_stop(proc) -> None:
    """Kill the launcher and its rank processes (its session) where any
    is left."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _ranks_faults(c: dict) -> list:
    """The bounds of ``RANKS_TOL`` a rank's case report breaks."""
    t, out = RANKS_TOL, []
    if c["strided"]:
        out.append("_StridedShard")
    if "loss" in c:
        (wl, gl), (wn, gn) = c["loss"], c["grad_norm"]
        if abs(gl - wl) > t["loss"] * abs(wl) or abs(gn - wn) > t["grad_norm"] * abs(wn):
            out.append("loss/grad norm")
        if c["param_err"] > t["param"] or not c["placements_kept"]:
            out.append("params")
        if c["case"] == "a2a" and c["dropped"]:
            out.append("dropped slots")
    elif "err" in c:
        if c["err"] > t["prefill"]:
            out.append("prefill logits")
    else:
        bf16 = t["bf16_logit_rel"] * c["logit_max"]
        if c["case"] == "decode_f32":
            ok = c["logit_err"] <= t["decode_f32"] and c["cache_err"] <= t["decode_f32"]
        elif c["case"] == "decode_int8":
            at = bf16 if c["arch"] in RANKS_INT8_AT_BF16 else t["int8_logits"]
            ok = c["int8_off"] == 0 and c["scale_rel"] <= t["int8_scale"] and c["logit_err"] <= at
        else:
            ok = c["logit_err"] <= bf16
        if not ok:
            out.append("decode")
    return out


def dist_ranks_phase(proc, t0: float, mesh: str) -> None:
    """Every rank's reports held to ``RANKS_TOL``, and no
    ``_StridedShard`` placement made."""
    budget = RANKS_BUDGET_S[mesh]
    try:
        out = _finish_script(proc, f"dist_ranks {mesh}",
                             max(1.0, budget * 3 - (time.perf_counter() - t0)))
    finally:
        dist_ranks_stop(proc)
    rep = json.loads(out.strip().splitlines()[-1])
    check(rep["mesh"] == mesh, f"dist_ranks: ran on {rep['mesh']}, not {mesh}")
    for r in rep["ranks"]:
        check("error" not in r, f"dist_ranks {mesh}: rank {r['rank']}: {r.get('error')} "
                                f"{r.get('trace', '')[-1500:]}")
        errors = [f"{c['arch']} {c['case']}: {c['error'][:600]} at {' < '.join(c['where'][::-1])}"
                  for c in r["cells"] if "error" in c]
        check(not errors, f"dist_ranks {mesh}: rank {r['rank']}: " + " | ".join(errors))
        for c in r["cells"]:
            faults = _ranks_faults(c)
            check(not faults, f"dist_ranks {mesh}: rank {r['rank']} {c['arch']} {c['case']}: "
                              f"{', '.join(faults)}: {c}")
    wall = time.perf_counter() - t0

    def line(c):
        if "loss" in c:
            return (f"{c['case']} loss {c['loss'][1]:.6f} vs {c['loss'][0]:.6f}, params "
                    f"{c['param_err']:.1e}" + (f", dropped {c['dropped']}"
                                                 if c["case"] == "a2a" else ""))
        if "err" in c:
            return f"prefill {c['err']:.1e}"
        return (f"{c['case']} logits {c['logit_err']:.1e} (max {c['logit_max']:.3f})"
                + (f", int8 off {c['int8_off']}, scales {c['scale_rel']:.1e}"
                   if c["case"] == "decode_int8" else f", cache {c['cache_err']:.1e}"))
    cells = rep["ranks"][0]["cells"]
    for arch in dict.fromkeys(c["arch"] for c in cells):
        phase("dist_ranks", f"{mesh} {arch}: " + "; ".join(line(c) for c in cells
                                                           if c["arch"] == arch))
    phase("dist_ranks", f"torch {rep['torch']}: {len(rep['ranks'])} gloo ranks, CPU processes "
                        f"(the card is not used), {tuple(rep['mesh_shape'])} mesh {mesh}; "
                        f"{len(cells)} cases a rank within {RANKS_TOL} (int8 logits of "
                        f"{RANKS_INT8_AT_BF16} at the bf16 bound); _StridedShard placements "
                        f"made: 0 on every rank; ranks {rep['seconds']:.1f} s, phase {wall:.1f} s "
                        f"wall (budget {budget} s; nice {RANKS_NICE}, beside the card phases)")


def example_train_cfg():
    """``examples/torch_train_100m.py``'s model at its default width and
    depth (d_model 768, 12 layers), and its FaaSFS block size: its
    checkpoints and transactions hold each float32 leaf of at least one
    block against the block-delta kernel in rows of that size."""
    import argparse
    import importlib.util

    path = ROOT / "examples" / "torch_train_100m.py"
    spec = importlib.util.spec_from_file_location("torch_train_100m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_cfg(argparse.Namespace(d_model=768, layers=12)), mod.BLOCK_BYTES


def examples_phase() -> dict:
    """The port's examples on the card, each as a subprocess, all at once:
    the ~100M-parameter transactional training run at its full default
    width (``EXAMPLE_ARGS``) and the others of ``EXAMPLE_CHECKS``. Returns
    the training run's kernel launches."""
    t0 = time.perf_counter()
    procs = {"torch_train_100m.py": _start_script(["examples/torch_train_100m.py",
                                                   *EXAMPLE_ARGS])}
    procs.update({name: _start_script([f"examples/{name}"]) for name in EXAMPLE_CHECKS})
    try:
        outs = {name: _finish_script(p, name, EXAMPLE_TIMEOUT_S) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    out = outs.pop("torch_train_100m.py")
    losses = [float(m) for m in re.findall(r"^step +\d+ loss=(\S+)", out, re.M)]
    ckpts = re.findall(r"checkpoint @ (\d+): ([\d,]+) bytes \((\d+) blocks, (\w+)\)", out)
    k = re.search(r"^kernels on cuda: flash_attention (\d+) \(sm90 (\d+)\), "
                  r"flash_attention_bwd (\d+) \(sm90 (\d+)\), block_delta (\d+)$", out, re.M)
    check(losses and all(math.isfinite(x) for x in losses), f"torch_train_100m: losses {losses}")
    check(len(ckpts) == 2 and ckpts[0][3] == "full" and ckpts[1][3] == "delta",
          f"torch_train_100m: checkpoints {ckpts}")
    check(k is not None, f"torch_train_100m: no kernels line in {out[-1500:]}")
    fa, fa90, fb, fb90, bd = (int(x) for x in k.groups())
    check(fa > 0 and fa == fa90 and fb > 0 and fb == fb90 and bd > 0,
          f"torch_train_100m: launches flash {fa} (sm90 {fa90}), backward {fb} (sm90 {fb90}), "
          f"block delta {bd}")
    model = re.search(r"^model: .*$", out, re.M).group(0)
    done = re.search(r"^done: .*$", out, re.M).group(0)
    phase("examples", f"torch_train_100m.py {' '.join(EXAMPLE_ARGS)} on the card ({model}; "
                      f"B 8 x S 256, bf16): losses {', '.join(f'{x:.4f}' for x in losses)} "
                      f"(printed every 10 steps); checkpoints "
                      + ", ".join(f"@{s} {kind} {blocks} blocks {b} B" for s, b, blocks, kind
                                  in ckpts)
                      + f"; {done}; launches flash {fa} forward, {fb} backward (all sm90), "
                        f"block delta {bd}")
    for name, want in EXAMPLE_CHECKS.items():
        check(re.search(want, outs[name], re.M) is not None,
              f"{name}: no line matching {want!r} in {outs[name][-1500:]}")
        phase("examples", f"{name}: {outs[name].strip().splitlines()[-1][:200]}")
    phase("examples", f"five examples at once, {wall:.1f} s")
    return {"flash_attention": fa, "flash_attention_bwd": fb, "block_delta": bd,
            "ssm_scan": 0, "ssm_scan_bwd": 0}


def _free_host_and_device(torch) -> None:
    """Collect the previous phase's trees (a ServeSlice holds reference
    cycles), give freed heap pages back to the OS and empty the caching
    allocator, so the next full-width run starts from a clean card."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass
    torch.cuda.empty_cache()
    phase("free", f"host RSS {_rss_gib():.1f} GiB, device memory allocated "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import bridge
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.core.tensorstate import flatten_with_names
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_delta import ops as bd_ops
    from repro_torch.kernels.block_delta.ref import block_delta_flat_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import (selective_scan_bwd_ref, selective_scan_ref,
                                                  ssm_scan_ref)
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import runtime
    from repro_torch.optim import adamw
    from repro_torch.state.checkpoint import exact_dirty_blocks

    def synth(cfg, B, S, step=0):
        """synth_batch, with a vlm config's pixel embeds before the S tokens."""
        return train.train_batch(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                                 global_batch=B), step)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "unknown"
    print(card, flush=True)
    phase("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
                 f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    counters = {"flash_attention": fa_ops.flash_attention,
                "flash_attention_bwd": fa_ops.flash_attention_bwd,
                "block_delta": bd_ops.block_delta, "ssm_scan": scan_ops.selective_scan_fwd,
                "ssm_scan_bwd": scan_ops.selective_scan_bwd}
    paths = [get_config("qwen2-1.5b"), get_config("hymba-1.5b")]
    moe = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=MOE_LAYERS)
    moe_tag = f"{moe.name} ({MOE_LAYERS} layer)"
    vlm = dataclasses.replace(get_config("internvl2-76b"), num_layers=VLM_LAYERS)
    vlm_tag = f"{vlm.name} ({VLM_LAYERS} layer)"
    ranks = None
    try:
        t0 = time.perf_counter()
        built = _build.build()
        phase("build", f"{len(built)} kernels built in {time.perf_counter() - t0:.1f} s "
                       f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
        check(sorted(_build.SOURCES) == sorted(counters), "a kernel source has no counter")
        for name in _build.SOURCES:
            for entry, regs, spill in ptxas_entries(_build.build_log(name)):
                phase("build", f"{name}: {entry}: {regs} registers, {spill} B spill stores")

        block_elems = serve.BLOCK_BYTES // 4
        entries = {"flash_attention": flash_phase(torch, fa_ops, attention_ref),
                   "flash_attention_bwd": flash_bwd_phase(torch, fa_ops, attention_lse_ref,
                                                          attention_bwd_ref)}
        block_delta_special_check(torch, bd_ops, block_delta_flat_ref)
        example, example_block_bytes = example_train_cfg()
        for cfg, tag, be in ([(c, c.name, block_elems) for c in paths]
                             + [(moe, moe_tag, block_elems), (vlm, vlm_tag, block_elems),
                                (example, "torch_train_100m.py", example_block_bytes // 4)]):
            leaf_numels = [math.prod(d.shape) for d in M.param_defs(cfg)
                           if math.prod(d.shape) >= be]
            delta = block_delta_phase(torch, bd_ops, block_delta_flat_ref, leaf_numels, be, tag)
            entries.setdefault("block_delta", delta)
        entries["ssm_scan"] = scan_phase(torch, scan_ops, ssm_scan_ref, selective_scan_ref)
        entries["ssm_scan_bwd"] = scan_bwd_phase(torch, scan_ops, selective_scan_ref,
                                                 selective_scan_bwd_ref)
        small = [reduced_config(get_config(name)) for name in (
            "qwen2-1.5b", "hymba-1.5b", "falcon-mamba-7b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
            "internvl2-76b", "musicgen-large")]
        # the four CPU ranks start after the kernels' timed phases, so that
        # no eager time above shares the host with them, and run beside the
        # small checks, which time nothing
        ranks = dist_ranks_start("pod")
        for cfg in small:
            small_input_phase(torch, serve, M, cfg)
        for cfg in small:
            small_train_phase(torch, M, runtime, adamw, synth, counters, cfg)
        dist_ranks_phase(*ranks)
        # the eight ranks run beside the card phases below, read after them
        ranks = dist_ranks_start("multipod")
        by_path = {}
        # the largest host footprint first, from the lowest host RSS
        _free_host_and_device(torch)
        by_path["serve " + vlm_tag] = vlm_serve_phase(
            torch, serve, M, counters, bridge, exact_dirty_blocks, flatten_with_names, vlm)
        runs = [(c, c.name) for c in paths] + [(moe, moe_tag)]
        for cfg, tag in runs:
            _free_host_and_device(torch)
            by_path[tag] = full_width_phase(torch, serve, M, counters, bridge,
                                            exact_dirty_blocks, flatten_with_names, moe_mod,
                                            cfg)
        for cfg, tag in runs:
            _free_host_and_device(torch)
            by_path["train " + tag] = train_full_phase(
                torch, M, runtime, adamw, synth, counters, moe_mod, cfg)
        _free_host_and_device(torch)
        by_path["train " + vlm_tag] = vlm_train_phase(torch, M, runtime, synth, counters, vlm)
        _free_host_and_device(torch)
        by_path[f"train dots {paths[0].name}"] = train_dots_phase(
            torch, M, runtime, adamw, synth, counters, paths[0])
        _free_host_and_device(torch)
        cut = dataclasses.replace(paths[0], num_layers=TXN_LAYERS)
        by_path[f"train_txn {paths[0].name} ({TXN_LAYERS} layer)"] = train_txn_phase(
            torch, M, train, bridge, exact_dirty_blocks, flatten_with_names, counters, cut)
        _free_host_and_device(torch)
        by_path[f"dist {paths[0].name}"] = dist_phase(
            torch, M, runtime, adamw, synth, counters, moe_mod, paths[0],
            get_config("qwen3-moe-30b-a3b"))
        dist_ranks_phase(*ranks)
        _free_host_and_device(torch)
        by_path["example torch_train_100m"] = examples_phase()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if ranks is not None:
            dist_ranks_stop(ranks[0])

    for name, e in entries.items():
        e["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
    keys = ["name", "route", "route_detail", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "launches_by_path", "by_shape"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys if k in e}
                                  for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
