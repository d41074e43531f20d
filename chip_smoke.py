#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from a checkout of the repository, on a machine with a CUDA card,
``nvcc`` and PyTorch built for CUDA. It prints one line per phase and exits
non-zero at the first failure:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels, one ``nvcc`` per source, all at once;
  3. flash attention: the kernel against its plain version at the serving
     shape (B 4, S 512, H 12, KV 2, hd 128, causal, bf16) and at the JAX
     kernel tests' cases in float32 and bf16; kernel, plain and
     ``scaled_dot_product_attention`` times;
  4. block delta: the kernel against its plain version at the shapes of
     the 8 float32 leaves it sees on the serving path; times;
  5. a small input: the reduced qwen2-1.5b serving computation in float32
     on the card (flash kernel) against the same on the CPU;
  6. the serving slice at full width (qwen2-1.5b, 28 layers, 1.54 G float32
     parameters): publish, refresh, serve 4 x 512-token prompts plus 32
     greedy tokens, in-place delta publish, refresh, serve; launch counts
     read around this phase alone, and its results checked;
  7. one JSON line of per-kernel numbers, then the result line
     ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout, it exits 1 and prints no
result line. The kernels build into ``build/kernels`` of the checkout.
"""
from __future__ import annotations

import json
import math
import re
import resource
import subprocess
import sys
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
# Prefill logits of the served request (bf16, flash kernel) against the same
# prefill with the plain attention math (bf16, which rounds scores and
# probabilities to bf16 as the JAX model does): max |diff| over max |logit|.
# The bf16 matmuls of the other layers dominate: at seed 0 on the H100 both
# paths lie 4.4-4.5e-2 from a float32 prefill and 4.357e-2 from each other,
# with every argmax equal. The sharp check is in float32, where the two
# paths differ only in the attention core.
PREFILL_REL_BOUND = 5e-2
PREFILL_F32_REL_BOUND = 1e-4


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
                   f"(worst err/tol {worst:.3f})")

    B, S, H, KV, hd = 4, 512, 12, 2, 128
    q, k, v = inputs(B, S, H, KV, hd, torch.bfloat16, 7)
    got = fa_ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    check(err < FLASH_TOL["bfloat16"], f"flash serving shape err {err}")
    ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True))
    ke, ve = k.repeat_interleave(H // KV, dim=1), v.repeat_interleave(H // KV, dim=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
    flops = 4 * hd * B * H * attended_pairs(S, True, 0)
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:104",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
    }
    phase("flash", f"B{B} S{S} H{H} KV{KV} hd{hd} causal bf16: err {err:.3e}; kernel "
                   f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                   f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; {flops / 1e9:.2f} GFLOP, "
                   f"{nbytes / 1e6:.1f} MB)")
    del q, k, v, ke, ve, got, want
    torch.cuda.empty_cache()
    return entry


def block_delta_phase(torch, bd_ops, block_delta_ref, leaf_numels, block_elems):
    total_ms = total_plain = total_bytes = total_ops = 0.0
    worst_norm = worst_abs = 0.0
    for i, n in enumerate(leaf_numels):
        nb = n // block_elems
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        new = torch.randn(nb, block_elems, generator=g, device="cuda")
        old = new + 0.01 * torch.randn(nb, block_elems, generator=g, device="cuda")
        old[:: max(1, nb // 3)] = new[:: max(1, nb // 3)]      # some clean blocks
        qk, nk, sk = bd_ops.block_delta(new, old)
        qr, nr, sr = block_delta_ref(new, old)
        check(torch.equal(qk, qr), f"block_delta leaf {i}: int8 q differs")
        check(torch.equal(sk, sr), f"block_delta leaf {i}: scale differs")
        rel = float(((nk - nr).abs() / nr.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5, f"block_delta leaf {i}: norm2 rel err {rel}")
        worst_norm = max(worst_norm, rel)
        # largest absolute difference over all three outputs of the kernel
        worst_abs = max(worst_abs, float((qk.int() - qr.int()).abs().max()),
                        float((sk - sr).abs().max()), float((nk - nr).abs().max()))
        del qk, nk, sk, qr, nr, sr
        total_ms += time_ms(lambda: bd_ops.block_delta(new, old), iters=5, warmup=1)
        total_plain += time_ms(lambda: block_delta_ref(new, old), iters=3, warmup=1)
        total_bytes += 9 * nb * block_elems + 8 * nb
        total_ops += 6 * nb * block_elems
        del new, old
        torch.cuda.empty_cache()
    t_bytes, t_ops = total_bytes / PEAK_BYTES, total_ops / PEAK_F32_FLOPS
    entry = {
        "name": "block_delta", "route": "cuda",
        "source": "src/repro_torch/kernels/block_delta/csrc/block_delta.cu",
        "replaces": "src/repro/kernels/block_delta/kernel.py:36",
        "max_abs_err": worst_abs, "ms": total_ms, "plain_ms": total_plain,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    phase("block_delta", f"{len(leaf_numels)} leaves, {sum(leaf_numels) / 1e9:.3f} G float32 "
                         f"in {block_elems}-element rows: q and scale equal, norm2 rel err "
                         f"{worst_norm:.2e}, max abs err {worst_abs:.3e}; kernel "
                         f"{total_ms:.3f} ms, plain "
                         f"{total_plain:.3f} ms, bound {entry['bound_ms']:.3f} ms "
                         f"({total_bytes / 1e9:.2f} GB)")
    return entry


def small_input_phase(torch, serve, M, cfg):
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = _tree(params, lambda t: t * 20 if t.dim() >= 2 else t)
    prompts = torch.randint(0, cfg.vocab_size, (4, 40), generator=torch.Generator().manual_seed(1))
    lc, tc = serve.generate(cfg, params, prompts, 8, compute_dtype=torch.float32)
    lg, tg = serve.generate(cfg, _tree(params, lambda t: t.cuda()), prompts.cuda(), 8,
                            compute_dtype=torch.float32)
    lg, tg = lg.cpu(), tg.cpu()
    check(bool(torch.isfinite(lg).all()) and lg.shape == lc.shape, "small input: bad logits")
    rel = float((lg - lc).abs().max() / lc.abs().max())
    check(rel <= 1e-4, f"small input: card vs CPU logits rel err {rel}")
    check(torch.equal(tg, tc), "small input: greedy tokens differ between card and CPU")
    phase("small", f"reduced qwen2-1.5b float32, 4x40 prompts + 8 tokens: card vs CPU logits "
                   f"rel err {rel:.2e}, tokens equal")


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def full_width_phase(torch, serve, M, fa_ops, bd_ops, bridge, exact_dirty_blocks,
                     flatten_with_names, cfg):
    B, S, T = 4, 512, 32
    torch.cuda.reset_peak_memory_stats()
    fa_ops.flash_attention.launches = 0
    bd_ops.block_delta.launches = 0
    t0 = time.perf_counter()
    run = serve.run(cfg, device="cuda", batch=B, prompt_len=S, tokens=T, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "block_delta": bd_ops.block_delta.launches}
    phase("serve", f"{cfg.name}: {cfg.param_count()} params, run {wall:.1f} s; launches "
                   f"{launches}")
    check(launches["flash_attention"] > 0, "flash kernel never launched on the serving path")
    check(launches["block_delta"] > 0, "block_delta kernel never launched on the serving path")

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
    plain, _ = M.prefill(cfg, cast, run.prompts, attn_impl="plain")
    k32, _ = M.prefill(cfg, served, run.prompts, compute_dtype=torch.float32)
    p32, _ = M.prefill(cfg, served, run.prompts, compute_dtype=torch.float32,
                       attn_impl="plain")
    kern = run.out_v1[0]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    r_bf16, r_f32 = rel(kern, plain), rel(k32, p32)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    check(r_bf16 <= PREFILL_REL_BOUND, f"prefill logits bf16: kernel vs plain rel err {r_bf16}")
    check(r_f32 <= PREFILL_F32_REL_BOUND, f"prefill logits f32: kernel vs plain rel err {r_f32}")
    phase("serve", f"prefill logits, flash kernel path vs plain attention path: bf16 rel err "
                   f"{r_bf16:.3e} (bound {PREFILL_REL_BOUND}, argmax agreement {agree:.2f}), "
                   f"float32 rel err {r_f32:.3e} (bound {PREFILL_F32_REL_BOUND}); bf16 paths "
                   f"vs float32: kernel {rel(kern, p32):.3e}, plain {rel(plain, p32):.3e}")
    del plain, k32, p32

    dirty = run.publish_v1.dirty
    old = bridge.flat_tensors({"params": run.params_v0})
    new = bridge.flat_tensors({"params": run.params_v1})
    for name in new:
        exact = exact_dirty_blocks(new[name], old[name], serve.BLOCK_BYTES)
        check(dirty[name] == exact, f"{name}: kernel dirty set {dirty[name]} != exact {exact}")
    n_dirty = sum(len(v) for v in dirty.values())
    written = run.publish_v1.stats["blocks_written"]
    check(n_dirty == written and n_dirty > 0, f"dirty {n_dirty} != blocks_written {written}")
    phase("serve", f"delta publish: kernel dirty set == exact byte compare == blocks_written "
                   f"({n_dirty} of {run.publish_v0.stats['blocks_written']} blocks; "
                   f"{', '.join(f'{k}:{len(v)}' for k, v in dirty.items() if v)})")

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
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    phase("serve", "times (s): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; peak host RSS {rss:.1f} GiB; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches


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
    from repro_torch.kernels.block_delta.ref import block_delta_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.state.checkpoint import exact_dirty_blocks

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else "unknown"
    print(card, flush=True)
    phase("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
                 f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    try:
        t0 = time.perf_counter()
        built = _build.build()
        phase("build", f"{len(built)} kernels built in {time.perf_counter() - t0:.1f} s "
                       f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
        for name in _build.SOURCES:
            log = _build.build_log(name)
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
            spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
            if regs:
                phase("build", f"{name}: {len(regs)} entry points, {min(regs)}-{max(regs)} "
                               f"registers, spill stores up to {max(spills, default=0)} B")

        cfg = get_config("qwen2-1.5b")
        block_elems = serve.BLOCK_BYTES // 4
        leaf_numels = [math.prod(d.shape) for d in M.param_defs(cfg)
                       if math.prod(d.shape) >= block_elems]
        flash = flash_phase(torch, fa_ops, attention_ref)
        delta = block_delta_phase(torch, bd_ops, block_delta_ref, leaf_numels, block_elems)
        small_input_phase(torch, serve, M, reduced_config(cfg))
        launches = full_width_phase(torch, serve, M, fa_ops, bd_ops, bridge,
                                    exact_dirty_blocks, flatten_with_names, cfg)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    flash["launches"] = launches["flash_attention"]
    delta["launches"] = launches["block_delta"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in (flash, delta)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
