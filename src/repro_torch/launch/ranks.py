"""The distribution plan on several ranks: planned steps of reduced configs
on a (2, 2) ``data`` x ``model`` mesh of four gloo processes, each against
the same step on one device.

  PYTHONPATH=src python -m repro_torch.launch.ranks [--arch NAME ...]

Every rank is a CPU process (one thread) and runs, for each config, one
float32 train step through ``plan_cell`` (batch over ``data``, the
residual's sequence over ``model``, the train rules) and one planned
prefill, and the same two steps on plain tensors. The unsharded steps route
the MoE tokens in the plan's groups (``moe_groups``, one a ``data`` rank):
the capacity of a group depends on its size, so that is the function the
plan computes. Each rank reports its numbers: loss and grad norm of both
train steps, the largest difference of the new params where the gradient is
above 1e-3 of its leaf's largest (the plain step's gradients), whether each
new param kept its placements, the largest difference of the prefill
logits, and the ``_StridedShard`` placements DTensor made during each
planned step (a sequence split over one mesh axis folded into a batch split
over another; ``strided_shards``). The command prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Sequence

import torch

ARCHS = ("qwen2-1.5b", "hymba-1.5b", "qwen3-moe-30b-a3b")
SEQ, BATCH, CE_CHUNK = 32, 2, 16
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
TIMEOUT_S = 300


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


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def _grads(cfg, plan, params, batch):
    """The plain step's gradients of the loss, by leaf path."""
    from repro_torch.models import model as M
    from repro_torch.models import runtime as R

    leaves = _flat(params)
    ps = {k: t.detach().requires_grad_(True) for k, t in leaves.items()}
    tree: Dict = {}
    for path, t in ps.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    total, _ = M.loss_fn(cfg, tree, R.batch_to_device(batch, "cpu"), shardings=plan.act,
                         compute_dtype=plan.compute_dtype, ce_chunk=plan.ce_chunk)
    return dict(zip(ps, torch.autograd.grad(total, list(ps.values()))))


def check_cell(arch: str, mesh) -> Dict:
    """One planned train step and one planned prefill of the reduced
    ``arch`` over ``mesh`` against the plain steps: the numbers of the
    module docstring."""
    from repro_torch.configs.base import ShapeCell, get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import model as M
    from repro_torch.models import runtime as R
    from repro_torch.optim import adamw

    cfg = reduced_config(get_config(arch))
    shape = ShapeCell("t", "train", SEQ, BATCH)
    opt = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=BATCH), 0)
    plan = dataclasses.replace(R.plan_cell(cfg, shape, mesh), ce_chunk=CE_CHUNK,
                               compute_dtype=torch.float32)
    one = R.CellPlan(cfg, shape, ce_chunk=CE_CHUNK, compute_dtype=torch.float32,
                     act=M.ActSharding(moe_groups=plan.act.moe_groups))
    out: Dict = {"arch": arch}

    t0 = time.perf_counter()
    want, wm = R.make_train_step(one, opt)(state, batch)
    state_d = R.shard_state(plan, mesh, state)
    with strided_shards() as n:
        got, gm = R.make_train_step(plan, opt)(state_d, R.shard_batch(plan, mesh, batch))
    out["train_strided"] = n[0]
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
    out.update(loss=[wm["loss"], gm["loss"]], grad_norm=[wm["grad_norm"], gm["grad_norm"]],
               param_err=err, placements_kept=bool(kept),
               train_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    tokens = {"tokens": batch["tokens"]}
    pwant, _ = R.make_prefill_step(one)(params, R.batch_to_device(tokens, "cpu"))
    specs = M.param_partition_specs(cfg, plan.rules, R.mesh_axis_sizes(mesh))
    params_d = R.shard_tree(params, specs, mesh)
    with strided_shards() as n:
        pgot, _ = R.make_prefill_step(plan)(params_d, R.shard_batch(plan, mesh, tokens))
    out.update(prefill_strided=n[0],
               prefill_err=float((pgot.full_tensor() - pwant).abs().max()),
               prefill_s=time.perf_counter() - t0)
    return out


def _where(e: BaseException) -> List[str]:
    """The frames of this package in ``e``'s traceback, innermost last."""
    import traceback

    return [f"{f.filename.rsplit('repro_torch/', 1)[-1]}:{f.lineno} {f.name}"
            for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]


def _rank(rank: int, world: int, store: str, archs: Sequence[str], out) -> None:
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_AXES)
        res = {"rank": rank, "cells": []}
        for a in archs:     # a failing config does not hide the others'
            try:
                res["cells"].append(check_cell(a, mesh))
            except Exception as e:
                res["cells"].append({"arch": a, "error": f"{type(e).__name__}: {e}"[:2000],
                                     "trace": traceback.format_exc()[-3000:],
                                     "where": _where(e)})
    except Exception as e:  # reported, so that the caller sees which rank failed how
        res = {"rank": rank, "error": f"{type(e).__name__}: {e}"[:2000],
               "trace": traceback.format_exc()[-4000:]}
    finally:
        dist.destroy_process_group()
    out.put(res)


def run_ranks(archs: Sequence[str] = ARCHS, timeout: float = TIMEOUT_S) -> List[Dict]:
    """Every rank's report (``_rank``), rank order; processes still alive
    after ``timeout`` seconds are killed, and their ranks report
    {"error": "timeout"}."""
    import multiprocessing

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")     # a file rendezvous: no port to race for
        procs = [ctx.Process(target=_rank, args=(r, world, store, tuple(archs), out))
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
    ap.add_argument("--arch", action="append", default=None, help=f"default: {ARCHS}")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    args = ap.parse_args()
    t0 = time.perf_counter()
    ranks = run_ranks(tuple(args.arch or ARCHS), args.timeout)
    print(json.dumps({"torch": torch.__version__, "seconds": time.perf_counter() - t0,
                      "ranks": ranks}))


if __name__ == "__main__":
    main()
