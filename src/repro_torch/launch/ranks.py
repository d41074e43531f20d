"""The distribution plan on several ranks: planned steps of reduced configs
on a mesh of gloo processes, each against the same step on one device.

  PYTHONPATH=src python -m repro_torch.launch.ranks [--mesh pod|multipod]
      [--arch NAME ...] [--case NAME ...]

``MESHES`` holds the reference's two mesh layouts at two ranks an axis:
``pod``, (2, 2) ``data`` x ``model`` on four processes, and ``multipod``,
(2, 2, 2) ``pod`` x ``data`` x ``model`` on eight. The train batch of each
(``TRAIN_BATCH``) is the one that every batch axis of ``batch_axes_for``
splits: 2 on ``pod`` (batch over ``data``), 4 on ``multipod`` (batch over
``("pod", "data")``). Every rank is a CPU process (one thread) and runs, for
each config, the cases of ``CASES`` that name it, each against the same
computation on plain tensors:

* ``train``: one float32 train step through ``plan_cell`` (batch over the
  batch axes, the residual's sequence over ``model``, the train rules);
* ``prefill``: one planned float32 prefill;
* ``decode_f32``, ``decode_int8``, ``decode_bf16``: ``DECODE_STEPS``
  planned decode steps over a cache of ``DECODE_SEQ`` positions, batch
  ``DECODE_BATCH`` (over the batch axes; the cache's positions over
  ``model``, so the steps cross from the first ``model`` rank's positions
  to the second's): float32 cache and compute; int8 cache at float32
  compute (the cache is dequantized to bf16 for the attention); bf16 cache
  and compute, the planned serving path;
* the hill-climb's overrides of ``experiments/hillclimb_torch.py``, each a
  train step: ``rules_v2`` (``train_rules_v2``), ``dots``
  (``remat_policy="dots"``), ``q_chunk`` (``Q_CHUNK`` < the sequence) and
  ``a2a`` (``moe_impl="a2a"``, at ``A2A_CF``, where no slot can drop: the
  a2a caps each rank's block of tokens and the unsharded step each group,
  so only without drops are they the same function).

The unsharded steps keep the plan's other fields (``q_chunk``, remat, the
cache's dtype) and route the MoE tokens in the plan's groups
(``moe_groups``, one a batch rank): the capacity of a group depends on its
size, so that is the function the plan computes. Each rank reports, per
(config, case), its numbers: for a train step, loss and grad norm of both
steps, the largest difference of the new params where the gradient is
above 1e-3 of its leaf's largest (the plain step's gradients), whether each
new param kept its placements, and the MoE slots dropped in the planned
step (``dropped_slots``); for prefill the largest difference of the
logits; for decode the largest difference of the logits over the steps
and, of the final caches, of the float entries (``cache_err``), the count
of int8 K/V values that differ (``int8_off``) and the largest relative
difference of the scales (``scale_rel``); for every case the
``_StridedShard`` placements DTensor made during the planned step (a
sequence split over one mesh axis folded into a batch split over another;
``strided_shards``) and its seconds. The command prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ShapeCell, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import runtime as R
from repro_torch.optim import adamw

ARCHS = ("qwen2-1.5b", "hymba-1.5b", "qwen3-moe-30b-a3b")
MESHES = {"pod": ((2, 2), ("data", "model")),
          "multipod": ((2, 2, 2), ("pod", "data", "model"))}
TRAIN_BATCH = {"pod": 2, "multipod": 4}
SEQ, CE_CHUNK, Q_CHUNK = 32, 16, 8
DECODE_BATCH, DECODE_SEQ, DECODE_STEPS = 4, 16, 10
# E / top_k of the reduced MoE (4 experts, top-2): a block's capacity,
# int(cf * t * k / E), is then its token count t, and an expert takes at
# most one slot a token
A2A_CF = 2.0
TIMEOUT_S = 300


# name -> (kind, plan overrides, configs); decode overrides carry the
# compute dtype too
CASES = {
    "train": ("train", {}, ARCHS),
    "prefill": ("prefill", {}, ARCHS),
    "decode_f32": ("decode", {"compute_dtype": torch.float32}, ARCHS),
    "decode_int8": ("decode", {"kv_dtype": torch.int8, "compute_dtype": torch.float32}, ARCHS),
    "decode_bf16": ("decode", {"compute_dtype": torch.bfloat16}, ARCHS),
    "rules_v2": ("train", {"rules": R.train_rules_v2()}, ARCHS),
    "dots": ("train", {"remat_policy": "dots"}, ("qwen2-1.5b",)),
    "q_chunk": ("train", {"q_chunk": Q_CHUNK}, ("qwen2-1.5b",)),
    "a2a": ("train", {"moe_impl": "a2a"}, ("qwen3-moe-30b-a3b",)),
}


@contextlib.contextmanager
def strided_shards():
    """A one-item list counting the ``_StridedShard`` placements made
    while the context holds (DTensor makes them to fold a dim split over
    one mesh axis into a dim split over another)."""
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    count = [0]
    if cls is None:
        yield count
        return
    orig = cls.__init__

    def init(self, *args, **kwargs):
        count[0] += 1
        orig(self, *args, **kwargs)

    cls.__init__ = init
    try:
        yield count
    finally:
        cls.__init__ = orig


@contextlib.contextmanager
def dropped_slots():
    """A one-item list counting the MoE slots dropped at the capacity
    while the context holds: slots routed at a weight above 0 whose
    combine weight ``moe._dispatch`` set to 0."""
    count = [0]
    orig = moe._dispatch

    def dispatch(xg, weights, ids, E, C):
        buf, src, w = orig(xg, weights, ids, E, C)
        count[0] += int(((w == 0) & (weights.reshape(w.shape) != 0)).sum())
        return buf, src, w

    moe._dispatch = dispatch
    try:
        yield count
    finally:
        moe._dispatch = orig


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def _grads(cfg, plan, params, batch):
    """The plain step's gradients of the loss, by leaf path."""
    leaves = _flat(params)
    ps = {k: t.detach().requires_grad_(True) for k, t in leaves.items()}
    tree: Dict = {}
    for path, t in ps.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    total, _ = M.loss_fn(cfg, tree, R.batch_to_device(batch, "cpu"), shardings=plan.act,
                         compute_dtype=plan.compute_dtype, q_chunk=plan.q_chunk,
                         ce_chunk=plan.ce_chunk, remat_policy=plan.remat_policy)
    return dict(zip(ps, torch.autograd.grad(total, list(ps.values()))))


def _plan(cfg, shape, mesh, overrides: Dict):
    """``plan_cell`` with the case's overrides, float32 compute unless the
    case names its dtype, ``CE_CHUNK``."""
    ov = dict(overrides)
    dtype = ov.pop("compute_dtype", torch.float32)
    return dataclasses.replace(R.plan_cell(cfg, shape, mesh, overrides=ov), ce_chunk=CE_CHUNK,
                               compute_dtype=dtype)


def _one_device(plan):
    """The plan without its batch axes, rules or activation specs: the
    same computation on plain tensors, the MoE tokens routed in the plan's
    groups."""
    return dataclasses.replace(plan, batch_axes=None, rules={},
                               act=M.ActSharding(moe_groups=plan.act.moe_groups))


def check_train(cfg, mesh, batch_size: int, overrides: Dict) -> Dict:
    """One planned train step against the plain one: the numbers of the
    module docstring."""
    shape = ShapeCell("t", "train", SEQ, batch_size)
    opt = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=batch_size), 0)
    plan = _plan(cfg, shape, mesh, overrides)
    one = _one_device(plan)
    want, wm = R.make_train_step(one, opt)(state, batch)
    state_d = R.shard_state(plan, mesh, state)
    with strided_shards() as n, dropped_slots() as dropped:
        got, gm = R.make_train_step(plan, opt)(state_d, R.shard_batch(plan, mesh, batch))
    grads = _grads(cfg, one, params, batch)
    err, kept = 0.0, True
    start = _flat(state_d["params"])
    for path, t in _flat(got["params"]).items():
        kept &= tuple(t.placements) == tuple(start[path].placements)
        g = grads[path].abs()
        big = g > 1e-3 * g.max()
        if big.any():
            d = (t.full_tensor() - _flat(want["params"])[path])[big].abs().max()
            err = max(err, float(d))
    return {"loss": [wm["loss"], gm["loss"]], "grad_norm": [wm["grad_norm"], gm["grad_norm"]],
            "param_err": err, "placements_kept": bool(kept), "dropped": dropped[0],
            "strided": n[0]}


def check_prefill(cfg, mesh, batch_size: int, overrides: Dict) -> Dict:
    """One planned prefill against the plain one: the largest difference
    of the logits."""
    shape = ShapeCell("p", "prefill", SEQ, batch_size)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = {"tokens": synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                               global_batch=batch_size), 0)["tokens"]}
    plan = _plan(cfg, shape, mesh, overrides)
    want, _ = R.make_prefill_step(_one_device(plan))(params, R.batch_to_device(tokens, "cpu"))
    specs = M.param_partition_specs(cfg, plan.rules, R.mesh_axis_sizes(mesh))
    params_d = R.shard_tree(params, specs, mesh)
    with strided_shards() as n:
        got, _ = R.make_prefill_step(plan)(params_d, R.shard_batch(plan, mesh, tokens))
    return {"err": float((got.full_tensor() - want).abs().max()), "strided": n[0]}


def check_decode(cfg, mesh, overrides: Dict) -> Dict:
    """``DECODE_STEPS`` planned decode steps from a zero cache against the
    plain ones, the same random token a sequence at each step: the largest
    difference of the logits, and of the final caches."""
    shape = ShapeCell("d", "decode", DECODE_SEQ, DECODE_BATCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_STEPS),
                           generator=torch.Generator().manual_seed(1))
    plan = _plan(cfg, shape, mesh, overrides)
    one = _one_device(plan)
    cache = R.make_decode_cache(one, "cpu")
    cache_d = R.shard_tree(R.make_decode_cache(one, "cpu"), R.cache_partition_specs(plan), mesh)
    specs = M.param_partition_specs(cfg, plan.rules, R.mesh_axis_sizes(mesh))
    params_d = R.shard_tree(params, specs, mesh)
    step, step_d = R.make_decode_step(one), R.make_decode_step(plan)
    logit_err = logit_max = 0.0
    with strided_shards() as n:
        for i in range(DECODE_STEPS):
            tok = tokens[:, i:i + 1]
            want, cache = step(params, cache, {"tokens": tok, "cur_index": i})
            got, cache_d = step_d(params_d, cache_d, {"tokens": R.shard_tree(
                tok, (plan.batch_axes, None), mesh), "cur_index": i})
            logit_err = max(logit_err, float((got.full_tensor() - want).abs().max()))
            logit_max = max(logit_max, float(want.abs().max()))
    out = {"logit_err": logit_err, "logit_max": logit_max, "cache_err": 0.0, "int8_off": 0,
           "scale_rel": 0.0, "strided": n[0]}
    for key, want in cache.items():
        got = cache_d[key].full_tensor()
        if want.dtype == torch.int8:
            out["int8_off"] += int((got != want).sum())
        elif key.endswith("_scale"):
            rel = float(((got - want).abs() / want.abs()).max())
            out["scale_rel"] = max(out["scale_rel"], rel)
        else:
            out["cache_err"] = max(out["cache_err"],
                                   float((got.float() - want.float()).abs().max()))
    return out


def check_case(arch: str, case: str, mesh, mesh_name: str) -> Dict:
    """The case ``case`` of the reduced ``arch`` over ``mesh``."""
    kind, overrides, _ = CASES[case]
    cfg = reduced_config(get_config(arch))
    if overrides.get("moe_impl") == "a2a":
        cfg = dataclasses.replace(cfg, capacity_factor=A2A_CF)
    t0 = time.perf_counter()
    if kind == "train":
        out = check_train(cfg, mesh, TRAIN_BATCH[mesh_name], overrides)
    elif kind == "prefill":
        out = check_prefill(cfg, mesh, TRAIN_BATCH[mesh_name], overrides)
    else:
        out = check_decode(cfg, mesh, overrides)
    return {"arch": arch, "case": case, **out, "seconds": time.perf_counter() - t0}


def _where(e: BaseException) -> List[str]:
    """The frames of this package in ``e``'s traceback, innermost last."""
    import traceback

    return [f"{f.filename.rsplit('repro_torch/', 1)[-1]}:{f.lineno} {f.name}"
            for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]


def _rank(rank: int, mesh_name: str, store: str, archs: Sequence[str], cases: Sequence[str],
          out) -> None:
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    shape, axes = MESHES[mesh_name]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        res = {"rank": rank, "cells": []}
        for a in archs:
            for case in cases:
                if a not in CASES[case][2]:
                    continue
                try:    # a failing case does not hide the others'
                    res["cells"].append(check_case(a, case, mesh, mesh_name))
                except Exception as e:
                    res["cells"].append({"arch": a, "case": case,
                                         "error": f"{type(e).__name__}: {e}"[:2000],
                                         "trace": traceback.format_exc()[-3000:],
                                         "where": _where(e)})
    except Exception as e:  # reported, so that the caller sees which rank failed how
        res = {"rank": rank, "error": f"{type(e).__name__}: {e}"[:2000],
               "trace": traceback.format_exc()[-4000:]}
    finally:
        dist.destroy_process_group()
    out.put(res)


def run_ranks(archs: Sequence[str] = ARCHS, timeout: float = TIMEOUT_S, *,
              mesh: str = "pod", cases: Optional[Sequence[str]] = None) -> List[Dict]:
    """Every rank's report (``_rank``) of ``cases`` (default: all of
    ``CASES``) over the mesh ``mesh`` of ``MESHES``, rank order; processes
    still alive after ``timeout`` seconds are killed, and their ranks
    report {"error": "timeout"}."""
    import multiprocessing

    world = math.prod(MESHES[mesh][0])
    cases = tuple(cases or CASES)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")     # a file rendezvous: no port to race for
        procs = [ctx.Process(target=_rank, args=(r, mesh, store, tuple(archs), cases, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results: Dict[int, Dict] = {}
        try:
            while len(results) < world and time.monotonic() < deadline:
                try:
                    res = out.get(timeout=max(0.1, deadline - time.monotonic()))
                except Exception:
                    break
                results[res["rank"]] = res
        finally:
            for p in procs:
                p.join(max(0.1, min(10.0, deadline - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [results.get(r, {"rank": r, "error": "timeout"}) for r in range(world)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=sorted(MESHES), default="pod")
    ap.add_argument("--arch", action="append", default=None, help=f"default: {ARCHS}")
    ap.add_argument("--case", action="append", default=None, choices=list(CASES),
                    help="default: all")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    args = ap.parse_args()
    t0 = time.perf_counter()
    ranks = run_ranks(tuple(args.arch or ARCHS), args.timeout, mesh=args.mesh, cases=args.case)
    print(json.dumps({"torch": torch.__version__, "mesh": args.mesh,
                      "mesh_shape": list(MESHES[args.mesh][0]),
                      "seconds": time.perf_counter() - t0, "ranks": ranks}))


if __name__ == "__main__":
    main()
