"""Dry run: trace every (arch x shape x mesh) cell of the production meshes.

The port of ``repro.launch.dryrun``. For each cell it builds the plan
(``runtime.plan_cell``), then runs the cell's real ``train_step`` /
``prefill_step`` / ``decode_step`` once as rank 0 of the production mesh's
world, on the ``fake`` process group and on fake tensors
(``runtime.trace_cell``: nothing is allocated, no collective moves), and
records:

  * memory: the argument bytes (params, optimizer state, cache, batch: one
    rank's shards) and the peak of live bytes on the device through the
    step (``MemTracker``), arguments included;
  * cost: one rank's FLOPs, HBM bytes and collective wire bytes and counts
    by kind (``launch.cost_analysis.CostMode``), and its scopes, which
    ``launch.perf`` reads;
  * ``model_params`` and ``model_params_active``, and the wall seconds.

The attention and scan run their plain versions (CPU tensors), counted by
the kernels' formulas, as the reference's dry run lowers ``attention_xla``
and the XLA scan. Results are written as one JSON per cell under
``experiments/dryrun_torch/`` (ignored by git), so a sweep resumes where
it stopped; a failure is recorded with its error and trace.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh pod
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
TOP_SCOPES = 40      # scopes kept in a record, by bytes


def cell_id(arch: str, shape: str, mesh_name: str) -> str:
    return f"{arch}__{shape}__{mesh_name}"


def _tree_bytes(tree) -> int:
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def _locals(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if hasattr(tree, "untyped_storage") else []


def trace_record(cfg, shape, mesh, *, overrides: Optional[Dict] = None) -> Dict[str, Any]:
    """Plan and trace one cell over ``mesh``; the record's measured keys."""
    from repro_torch.launch.cost_analysis import CostMode
    from repro_torch.models import runtime

    plan = runtime.plan_cell(cfg, shape, mesh, overrides=overrides)
    cost = CostMode()
    mem = _ArgsTracker(skip=lambda: cost.propagating)
    t0 = time.perf_counter()
    trace = runtime.trace_cell(plan, mesh, modes=(mem, cost))
    wall = time.perf_counter() - t0
    arg_bytes = _tree_bytes(trace["args"])
    scopes = sorted(cost.by_scope.items(), key=lambda kv: -kv[1]["bytes"])
    return {
        "devices": mesh.size(),
        "mesh_shape": list(mesh.shape),
        "trace_s": round(wall, 2),
        "plan": {"batch_axes": plan.batch_axes, "q_chunk": plan.q_chunk,
                 "ce_chunk": plan.ce_chunk,
                 "moe": "a2a" if plan.act.moe_a2a is not None else "global"},
        "memory": {"argument_bytes": arg_bytes, "peak_bytes_est": mem.peak},
        "analysis": cost.summary(),
        "scopes": {k: v for k, v in scopes[:TOP_SCOPES]},
        "collective_scopes": [[k, s, b] for (k, s), b in sorted(
            cost.coll_by_scope.items(), key=lambda kv: -kv[1])[:TOP_SCOPES]],
        "bytes_by_elems": {str(e): b for e, b in sorted(cost.bytes_by_elems.items())},
        "model_params": cfg.param_count(),
        "model_params_active": cfg.active_param_count(),
    }


class _ArgsTracker:
    """``MemTracker`` around the step with the step's arguments (already
    made when it is entered) counted as live: ``peak`` is the most bytes
    live on rank 0's device at once. It skips what runs while ``skip()``
    holds: DTensor's sharding propagation, whose global-shape fake tensors
    no rank allocates."""

    def __init__(self, skip):
        from torch.distributed._tools.mem_tracker import MemTracker

        class Tracker(MemTracker):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if skip():
                    return func(*args, **(kwargs or {}))
                return super().__torch_dispatch__(func, types, args, kwargs)

        self.tracker = Tracker()
        self.peak = 0

    def track(self, args) -> None:
        self.tracker.track_external(*_locals(args))

    def __enter__(self):
        self.tracker.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.tracker.__exit__(*exc)
        snap = self.tracker.get_tracker_snapshot("peak")
        self.peak = max((v["Total"] for v in snap.values()), default=0)
        return out


def run_cell(arch: str, shape_name: str, mesh_name: str, *, overrides=None,
             out_dir: Path = OUT_DIR, tag: str = "", force: bool = False) -> dict:
    """The cell's record, from ``out_dir`` when it is there and not
    ``force``, else traced and written there."""
    from repro_torch.configs.base import SHAPES, cell_applicable, get_config
    from repro_torch.launch.mesh import make_production_mesh

    out_dir.mkdir(parents=True, exist_ok=True)
    cid = cell_id(arch, shape_name, mesh_name) + (f"__{tag}" if tag else "")
    jpath = out_dir / f"{cid}.json"
    if jpath.exists() and not force:
        return json.loads(jpath.read_text())

    cfg = get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    ok, why = cell_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
                           "applicable": ok}
    if not ok:
        rec["skip_reason"] = why
        jpath.write_text(json.dumps(rec, indent=2))
        return rec
    try:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
        rec.update(ok=True, **trace_record(cfg, shape, mesh, overrides=overrides))
    except Exception as e:  # record failures: they are bugs to fix
        rec.update(ok=False, error=f"{type(e).__name__}: {e}"[:2000],
                   trace=traceback.format_exc()[-4000:])
    jpath.write_text(json.dumps(rec, indent=2))
    return rec


def main() -> None:
    from repro_torch.configs.base import SHAPES, list_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=OUT_DIR, help="where the records go")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list_configs()
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]

    results = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                t0 = time.time()
                rec = run_cell(a, s, m, out_dir=args.out, force=args.force)
                status = ("SKIP" if not rec.get("applicable", True)
                          else ("OK" if rec.get("ok") else "FAIL"))
                peak = rec.get("memory", {}).get("peak_bytes_est", 0)
                print(f"[{status:4s}] {a:22s} {s:12s} {m:8s} "
                      f"peak={peak / 2**30:7.2f}GiB wall={time.time() - t0:6.1f}s", flush=True)
                if not rec.get("ok", True) and rec.get("applicable", True):
                    print("       ", rec.get("error", ""), flush=True)
                results.append(rec)
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if not r.get("applicable", True))
    n_fail = len(results) - n_ok - n_skip
    print(f"\ndone: {n_ok} ok, {n_skip} skip, {n_fail} fail / {len(results)}")


if __name__ == "__main__":
    main()
