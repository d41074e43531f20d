"""Attribution: where a step's bytes, FLOPs, collectives and device time go.

The port of ``repro.launch.perf``, in two halves.

From a dry-run record (``launch.dryrun``, no device): HBM bytes and FLOPs
by scope (``launch.cost_analysis``: the two innermost ``repro_torch``
functions that issued the ops, ``bwd:``/``remat:`` for the backward and
the remat recompute, and the ``record_function`` range around them),
collective wire bytes by kind and scope, and the reference's
``whatif_fuse``: the bytes of the ops whose largest output has an element
count in a range, which a fused kernel would keep on chip.

On the card (``--card``): one training step of an arch at full width
(``--layers`` cuts the depth) under ``torch.profiler``, its device time by
kernel group (flash forward and backward, scan forward and backward, matrix
products, the rest) and by ``record_function`` range (``moe_ffn``'s
routing, dispatch and expert parts; a kernel launched by the backward of
an op belongs to the op's range, matched by autograd sequence number), and
the share of the wall time the device was busy. ``tools/train_profile.py``
prints the same groups beside its timing of the step's halves.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen2-1.5b__train_4k__pod --top 25
  PYTHONPATH=src python -m repro_torch.launch.perf --card --arch qwen3-moe-30b-a3b --layers 2
"""
from __future__ import annotations

import argparse
import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Tuple

# the dry run's records (``launch.dryrun.OUT_DIR``); this module imports
# nothing of the package at load, so ``tools/train_profile.py`` can load it
# beside another checkout's ``src``
OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
GROUPS = (("flash backward", ("fa_bwd",)), ("flash forward", ("fa_fwd",)),
          ("scan backward", ("ssm_scan_bwd",)), ("scan forward", ("ssm_scan_kernel",)),
          ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")))
MOE_PARTS = {"moe_routing": "MoE routing", "moe_dispatch": "MoE dispatch scatter/gather",
             "moe_experts": "MoE expert products"}
BLOCK_RANGE = "decoder_block"   # the range ``ranged_blocks`` puts around each block


# --------------------------------------------------------------------------- #
# From a dry-run record
# --------------------------------------------------------------------------- #
class Attribution:
    """A dry-run record's scopes: ``by_bytes`` {scope: bytes}, ``by_flops``
    {scope: FLOPs}, ``by_coll`` {(kind, scope): wire bytes}."""

    def __init__(self, rec: dict):
        self.rec = rec
        self.by_bytes = {k: v["bytes"] for k, v in rec["scopes"].items()}
        self.by_flops = {k: v["flops"] for k, v in rec["scopes"].items()}
        self.by_coll = {(k, s): b for k, s, b in rec["collective_scopes"]}
        self.by_elems = {int(e): b for e, b in rec.get("bytes_by_elems", {}).items()}

    def whatif_fuse(self, min_elems: int, max_elems: Optional[int] = None) -> Tuple[float, float]:
        """(total bytes, bytes of the ops whose largest output has between
        ``min_elems`` and ``max_elems`` elements): a fusion kernel that keeps
        those intermediates on chip removes the second."""
        total = self.rec["analysis"]["bytes_per_device"]
        hit = sum(b for e, b in self.by_elems.items()
                  if e >= min_elems and (max_elems is None or e <= max_elems))
        return total, hit


def load_cell(cell: str, root: Path = OUT_DIR) -> Attribution:
    return Attribution(json.loads((root / f"{cell}.json").read_text()))


def report(att: Attribution, top: int = 20, fuse_min_elems: int = 0) -> str:
    a = att.rec["analysis"]
    total = a["bytes_per_device"]
    lines = [f"== HBM bytes by scope (total {total / 1e12:.3f} TB/device/step; "
             f"{a['flops_per_device'] / 1e12:.2f} TFLOP) =="]
    for scope, b in sorted(att.by_bytes.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {b / 1e9:10.2f} GB  {b / max(total, 1) * 100:5.1f}%  "
                     f"{att.by_flops[scope] / 1e12:8.3f} TFLOP  {scope}")
    ctot = a["collective_bytes_per_device"]
    lines.append(f"\n== collective wire bytes (total {ctot / 1e9:.2f} GB/device/step) ==")
    for (kind, scope), b in sorted(att.by_coll.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {b / 1e9:10.2f} GB  {b / max(ctot, 1) * 100:5.1f}%  {kind:15s} {scope}")
    if fuse_min_elems:
        tot, hit = att.whatif_fuse(fuse_min_elems)
        lines.append(f"\nwhat-if fuse(elems>={fuse_min_elems:,}): removes {hit / 1e12:.3f} TB "
                     f"of {tot / 1e12:.3f} TB ({hit / max(tot, 1) * 100:.1f}%)")
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, reductions, copies)"


def moe_parts(events):
    """{External id of an op: MoE part} from a chrome trace's events, for
    the ops that launch kernels. A forward op (inside a ``decoder_block``
    range: the forward pass and the remat recompute inside the backward)
    belongs to the ``moe_ffn`` range around it, if any. A backward op
    belongs to the part of the forward op that made the autograd node
    whose evaluation runs it, matched by sequence number."""
    ops, spans, evals = {}, defaultdict(list), defaultdict(list)
    for ev in events:
        args, name = ev.get("args") or {}, ev.get("name", "")
        if ev.get("ph") != "X":
            continue
        if name in MOE_PARTS or name == BLOCK_RANGE:
            spans[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], name))
        elif name.startswith("autograd::engine::evaluate_function"):
            evals[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"],
                                     args.get("Sequence number")))
        if ev.get("cat") == "cpu_op" and "External id" in args:
            ops[args["External id"]] = ev
    for v in evals.values():
        v.sort()

    def enclosing(ev, names):
        return next((n for a, b, n in spans.get(ev["tid"], ())
                     if n in names and a <= ev["ts"] <= b), None)

    def evaluation(ev):
        """Sequence number of the node whose evaluation runs ``ev``."""
        runs = evals.get(ev["tid"], [])
        i = bisect.bisect_right(runs, (ev["ts"], float("inf"), 0)) - 1
        return runs[i][2] if i >= 0 and runs[i][1] >= ev["ts"] else None

    by_seq, out = {}, {}
    for ev in ops.values():
        if enclosing(ev, (BLOCK_RANGE,)) is None:
            continue
        part = enclosing(ev, MOE_PARTS)
        seq = ev["args"].get("Sequence number")
        if part and seq is not None and evaluation(ev) is None:   # the first forward
            by_seq[seq] = part
    for ext, ev in ops.items():
        if enclosing(ev, (BLOCK_RANGE,)) is not None:
            part = enclosing(ev, MOE_PARTS)
        else:
            part = by_seq.get(evaluation(ev))
        if part:
            out[ext] = MOE_PARTS[part]
    return out


def ranged_blocks(M, record_function):
    """Wrap ``M.block_fwd`` (which ``forward_hidden`` looks up at each
    call, the remat recompute too) in a ``decoder_block`` range."""
    block_fwd = M.block_fwd

    def ranged(*args, **kwargs):
        with record_function(BLOCK_RANGE):
            return block_fwd(*args, **kwargs)

    M.block_fwd = ranged


def device_time(events) -> Dict[str, Dict[str, float]]:
    """Device milliseconds of a chrome trace's kernels and copies:
    {"kernel": {name: ms}, "count": {name: launches}, "group": {group: ms},
    "part": {attention / MoE part / group: ms}}."""
    parts = moe_parts(events)
    out = {"kernel": defaultdict(float), "count": defaultdict(float),
           "group": defaultdict(float), "part": defaultdict(float)}
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ms = ev.get("dur", 0) / 1e3
        group = group_of(ev["name"])
        out["kernel"][ev["name"]] += ms
        out["count"][ev["name"]] += 1
        out["group"][group] += ms
        part = ("attention (flash forward and backward)" if group.startswith("flash")
                else parts.get((ev.get("args") or {}).get("External id"), group))
        out["part"][part] += ms
    return out


def card_report(arch: str, layers: int, trace_path: Path) -> str:
    """One training step of ``arch`` on the card under the profiler (B 4 x
    S 512 from ``synth_batch``, bf16 compute, remat, as ``chip_smoke.py``'s
    training phase), after two warm-up steps."""
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.models import model as M
    from repro_torch.models.runtime import CellPlan, make_train_step
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        raise SystemExit("perf --card: no CUDA device")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, S = 4, 512
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", S, B), ce_chunk=512),
                           adamw.AdamWConfig(lr_peak=1e-4, warmup_steps=2, decay_steps=100))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    for i in range(2):
        state, _ = step(state, synth_batch(dcfg, i))
    ranged_blocks(M, record_function)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, synth_batch(dcfg, 2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    dev = device_time(json.loads(trace_path.read_text())["traceEvents"])
    busy = sum(dev["kernel"].values())
    lines = [f"{torch.cuda.get_device_name(0)}: {cfg.name}, {cfg.num_layers} layers, "
             f"B{B} x S{S}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
             f"({busy / (wall * 1e3):.1%}; profiler on)"]
    for title, key in (("by kernel group", "group"), ("by range", "part")):
        lines.append(f"  {title}:")
        for name, ms in sorted(dev[key].items(), key=lambda kv: -kv[1]):
            lines.append(f"    {ms:9.2f} ms ({ms / max(busy, 1e-9):.1%})  {name}")
    lines.append("  longest kernels:")
    for name, ms in sorted(dev["kernel"].items(), key=lambda kv: -kv[1])[:10]:
        lines.append(f"    {ms:9.2f} ms  x{int(dev['count'][name]):<5d} {name[:110]}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, help="a dry-run record, arch__shape__mesh")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--fuse-min-elems", type=int, default=0)
    ap.add_argument("--card", action="store_true", help="profile a train step on the card")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--root", type=Path, default=OUT_DIR, help="the dry run's records")
    args = ap.parse_args()
    if args.card:
        root = Path(__file__).resolve().parents[3]
        print(card_report(args.arch, args.layers, root / "build" / "profile" / "perf_trace.json"))
        return
    if not args.cell:
        ap.error("--cell or --card")
    print(report(load_cell(args.cell, args.root), args.top, args.fuse_min_elems))


if __name__ == "__main__":
    main()
