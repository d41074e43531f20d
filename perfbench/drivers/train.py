"""Closed-loop training: the port's ``make_train_step`` on one device.

Set-up makes the float32 weights from the seed, builds one train step and
its AdamW state, and drives them through the first steps of the feed
(which build the kernels and warm the allocator); the window continues
the same state on new batches until ``seconds`` have passed. The first
steps are what the check compares with the plain reference after the
window: each step's loss and the global gradient norm the step reports,
each leaf's gradient norm at step 1 (worked out from the first moment
AdamW keeps, under the clip scale of the reference's global norm, so a
clip the program skips or takes wrong shows) and each leaf's change over
the checked steps.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Tuple

import torch

from perfbench import trace as tr
from perfbench import traffic, weights
from perfbench.harness import (GcWatch, Outcome, Spec, checks, compute_dtype, port_config,
                               reference, unit_times)
from perfbench.tree import flatten, nest


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _norms(flat: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {k: float(v.float().norm()) * scale for k, v in flat.items()}


def _gap(prog: Dict[str, float], want: Dict[str, float], keep) -> Tuple[float, str]:
    """Largest |program - reference| over the leaves in ``keep``, each over
    the larger of the reference's norm of that leaf and of the median
    leaf, and the leaf that gives it."""
    med = statistics.median(want[k] for k in keep)
    return max((abs(prog[k] - want[k]) / max(want[k], med), k) for k in keep)


def run(spec: Spec, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Outcome:
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import runtime
    from repro_torch.optim import adamw

    c, mix, chk = spec.model, spec.mix, spec.cell["check"]
    ref = reference(spec)
    B, S = mix["batch"], mix["seq_len"]
    cfg = port_config(spec)
    flat0 = weights.make(ref.layout(c), c, seed, device)
    params = nest(flat0)
    opt_cfg = adamw.AdamWConfig(**mix["optimizer"])
    plan = runtime.CellPlan(cfg, ShapeCell(spec.name, "train", S, B), ce_chunk=mix["ce_chunk"],
                            compute_dtype=compute_dtype(spec))
    step = runtime.make_train_step(plan, opt_cfg)
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params

    def feed(i: int):
        return traffic.train_batch(c, mix, seed, i, device)

    # set-up: the first steps, read for the check
    n_chk = chk["steps"]
    losses: List[float] = []
    gnorms: List[float] = []
    clipped: Dict[str, float] = {}
    change: Dict[str, float] = {}
    for i in range(max(mix["setup_steps"], n_chk)):
        state, met = step(state, feed(i))
        losses.append(met["loss"])
        gnorms.append(float(met["grad_norm"]))
        if i == 0:
            # m after one step is (1 - b1) * clip scale * gradient
            clipped = _norms(flatten(state["opt"]["m"]), 1.0 / (1 - opt_cfg.b1))
        if i == n_chk - 1:
            new = flatten(state["params"])
            change = {k: float((new[k].float() - flat0[k]).norm()) for k in flat0}
            del new
    k = max(mix["setup_steps"], n_chk)
    del flat0
    gc.collect()
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = failed = 0
    times: List[float] = []
    with GcWatch() as gcw:
        while True:
            t = time.perf_counter()
            state, met = step(state, feed(k))
            times.append(time.perf_counter() - t)
            k += 1
            steps += 1
            failed += not math.isfinite(met["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    traced = None
    if trace:
        box = {"state": state}

        def units():
            for _ in range(mix["profile_steps"]):
                nonlocal k
                box["state"], _ = step(box["state"], feed(k))
                k += 1

        traced = tr.traced(units, lambda: _sync(device), f"{spec.name}-{seed}")
        state = box["state"]
    t_check = time.perf_counter()
    del state, step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the check: the plain reference over the same first steps
    ref.no_tf32()
    flat0 = weights.make(ref.layout(c), c, seed, device)
    opt = {f: getattr(opt_cfg, f) for f in ("lr_peak", "lr_min", "warmup_steps", "decay_steps",
                                            "b1", "b2", "eps", "weight_decay", "clip_norm")}
    want = ref.train_steps(c, flat0, [feed(i) for i in range(n_chk)], opt, ref.FP32)
    got = {"losses": losses[:n_chk], "gnorms": gnorms[:n_chk], "clipped": clipped,
           "change": change}
    readings, worst = compare(got, want, opt["clip_norm"])
    phases = {"window_s": window_s, "steps": steps, "step_s": unit_times(times),
              "gc_full": [gcw.count, gcw.seconds], "trace_s": t_check - t0 - window_s,
              "check_s": time.perf_counter() - t_check, "readings": readings,
              "worst_leaves": worst, "gnorms": [gnorms[:n_chk], want["gnorms"]]}
    tokens = steps * B * S
    return Outcome(
        e2e={"setup_s": setup_s, "train_tokens_per_s": tokens / window_s},
        attempted=steps, failed=failed, checks=checks(readings, chk["limits"]),
        memory_peak_bytes=peak, shape=(B, S),
        window_units=steps, window_s=window_s, trace=traced,
        traced_units=mix["profile_steps"] if trace else 0, phases=phases)


def compare(got, want, clip_norm: float):
    """The numbers of a training cell, ``got`` (each step's loss and
    global gradient norm, each leaf's first-step gradient norm after the
    clip, each leaf's change) against ``want`` (the reference's
    ``train_steps``), and the leaves that give the two leaf gaps. The
    first step's leaf norms are unclipped with the reference's clip
    scale, so a program that clips by another norm, or not at all, reads
    its error. Beside the worst leaf's gradient gap, the steadier median
    leaf's. Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out of the
    change."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    gn = max(abs(a - b) / b for a, b in zip(got["gnorms"], want["gnorms"]))
    clip = min(1.0, clip_norm / max(want["gnorms"][0], 1e-9))
    g = want["grad_norms"]
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= 1e-3 * med]
    unclipped = {k: v / clip for k, v in got["clipped"].items()}
    grad, grad_leaf = _gap(unclipped, g, list(g))
    grad_med = statistics.median(abs(unclipped[k] - g[k]) / max(g[k], med) for k in g)
    moves, change_leaf = _gap(got["change"], want["change"], moved)
    return ({"loss_gap": rel, "gnorm_gap": gn, "grad_norm_gap": grad,
             "grad_med_gap": grad_med, "change_gap": moves},
            {"grad_norm_gap": grad_leaf, "change_gap": change_leaf,
             "left_out": sorted(set(g) - set(moved))})
