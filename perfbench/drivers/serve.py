"""Snapshot serving: the port's ``ServeSlice`` over one in-process FaaSFS
backend, in a closed loop with one client.

Set-up makes the float32 weights from the seed, publishes them as v0
(every block, one transaction), drops the publisher's copies (a
deployment holds them on the trainer's card, not the replica's), pins v0
with ``refresh`` and serves the warm-up requests, the first of which moves the snapshot to the card and
builds the kernels. The window then serves a request at a time until
``seconds`` have passed; each request's time runs from the call to its
logits and tokens being on the host. The check, after the window: the
served float32 parameters against the weights made again from the seed
(bit for bit), and a
sample of the window's requests against the plain reference's logits at
each prompt's last position.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import trace as tr
from perfbench import traffic, weights
from perfbench.harness import (GcWatch, Outcome, Spec, checks, compute_dtype, port_config,
                               reference, unit_times)
from perfbench.tree import flatten, nest
from perfbench.seeds import substream


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def mismatched(served: Dict[str, torch.Tensor], made: Dict[str, torch.Tensor]) -> int:
    """Elements whose bits differ (a missing or reshaped leaf counts
    whole)."""
    bad = 0
    for name, want in made.items():
        got = served.get(name)
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            bad += want.numel()
            continue
        bad += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    return bad + sum(t.numel() for n, t in served.items() if n not in made)


def run(spec: Spec, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Outcome:
    from repro_torch.launch import serve as serve_mod

    c, mix, chk = spec.model, spec.mix, spec.cell["check"]
    ref = reference(spec)
    B, S = mix["batch"], mix["prompt_len"]
    cfg = port_config(spec)
    flat = weights.make(ref.layout(c), c, seed, device)
    sl = serve_mod.ServeSlice(cfg, device=device, tokens=mix["new_tokens"], seed=seed,
                              compute_dtype=compute_dtype(spec))
    pub = sl.publish(nest(flat))
    sl.published = None   # kept by the slice for a later delta publish; none comes
    del flat
    t = time.perf_counter()
    sl.refresh()
    refresh_wall = time.perf_counter() - t

    # window seconds outside the requests: making prompts, and from a
    # request's end to its caller (the request's tensors released)
    spent = {"prompts_s": 0.0, "release_s": 0.0}

    def request(i: int):
        t = time.perf_counter()
        prompts = traffic.request(c, mix, seed, i, device)
        spent["prompts_s"] += time.perf_counter() - t
        t = time.perf_counter()
        logits, toks = sl.serve(prompts)
        out = logits.cpu(), toks.cpu()
        t_end = time.perf_counter()
        return t_end - t, out, t_end

    for w in range(mix["warmup_requests"]):
        request(-1 - w)
    spent.update(prompts_s=0.0)
    counters = {"publish_s": pub.seconds,
                "refresh_s": refresh_wall + sl.snapshot.stats.seconds}
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    latencies: List[float] = []
    answers = []
    with GcWatch() as gcw:
        while True:
            dt, out, t_end = request(len(latencies))
            spent["release_s"] += time.perf_counter() - t_end
            latencies.append(dt)
            answers.append(out)
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    outside = dict(spent, rest_s=window_s - sum(latencies) - sum(spent.values()))
    failed = sum(not bool(torch.isfinite(logits).all()) for logits, _ in answers)

    traced = None
    if trace:
        n = len(latencies)

        def units():
            for j in range(mix["profile_requests"]):
                request(n + j)

        traced = tr.traced(units, lambda: _sync(device), f"{spec.name}-{seed}")

    t_check = time.perf_counter()
    flat = weights.make(ref.layout(c), c, seed, device)
    served = flatten(sl.device_params())
    bad = mismatched(served, flat)
    del served, sl
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the check: a sample of the window's requests against the reference
    ref.no_tf32()
    pick = random.Random(substream(seed, "sample")).sample(
        range(len(answers)), min(chk["requests"], len(answers)))
    gaps, errs = [], []
    for i in pick:
        want = ref.last_logits(c, flat, traffic.request(c, mix, seed, i, device), ref.FP32).cpu()
        got, toks = answers[i]
        gaps.append(float((want.max(-1).values - want.gather(-1, toks[:, :1]).squeeze(-1)).max()))
        errs.append(float((got - want).abs().max() / want.abs().max()))
    lat = np.asarray(latencies)
    readings = {"params_mismatch": float(bad), "token_gap": max(gaps), "logit_err": max(errs)}
    phases = {"publish_s": pub.seconds, "refresh_s": counters["refresh_s"],
              "window_s": window_s, "requests": len(lat), "request_s": unit_times(latencies),
              "outside_requests": outside,
              "gc_full": [gcw.count, gcw.seconds],
              "trace_s": t_check - t0 - window_s, "check_s": time.perf_counter() - t_check,
              "readings": readings}
    return Outcome(
        e2e={"setup_s": setup_s, "ttft_p95_s": float(np.percentile(lat, 95)),
             "prompt_tokens_per_s": len(lat) * B * S / window_s},
        attempted=len(lat), failed=failed, checks=checks(readings, chk["limits"]),
        memory_peak_bytes=peak, shape=(B, S), window_units=len(lat), window_s=window_s,
        counters=counters, trace=traced, phases=phases,
        traced_units=mix["profile_requests"] if trace else 0)
