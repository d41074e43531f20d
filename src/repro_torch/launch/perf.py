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
products, the rest) and by the program's innermost range
(``repro_torch.tracing``'s train, model, block and serve ranges and
``moe_ffn``'s; ``range_of``: a kernel launched by the backward of an op
belongs to the op's ranges, matched by autograd sequence number), and the
share of the wall time the device was busy. ``tools/train_profile.py``
prints the same split beside its timing of the step's halves. ``--trace``
gives the split, and the longest idle gaps with the ranges open in each,
for a chrome trace written elsewhere, such as a benchmark cell's traced
window.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen2-1.5b__train_4k__pod --top 25
  PYTHONPATH=src python -m repro_torch.launch.perf --card --arch qwen3-moe-30b-a3b --layers 2
  PYTHONPATH=src python -m repro_torch.launch.perf --trace $TMPDIR/perfbench-qwen2-1.5b.train-4k-7.json
"""
from __future__ import annotations

import argparse
import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# the dry run's records (``launch.dryrun.OUT_DIR``); this module imports
# nothing of the package at load, so ``tools/train_profile.py`` can load it
# beside another checkout's ``src``
OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
GROUPS = (("flash backward", ("fa_bwd",)), ("flash forward", ("fa_fwd",)),
          ("scan backward", ("ssm_scan_bwd",)), ("scan forward", ("ssm_scan_kernel",)),
          ("matrix products", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")))
# the program's ranges (``repro_torch.tracing``; ``models/moe.py``'s own),
# the range the fallback rule gives a backward op with no forward op, and
# the ranges that hold a whole step or request (a kernel attributed to one
# of them and to none of its children is the program's unranged work)
PREFIXES = ("train.", "model.", "block.", "serve.", "moe_")
BACKWARD = "train.backward"
ROOTS = ("train.step", "train.forward", "serve.request")
EVAL = "autograd::engine::evaluate_function"
OUTSIDE = "outside every program range"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the range around a benchmark cell's traced units (``perfbench/trace.py``)
BENCH_WINDOW = "perfbench.window"


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


def range_of(events) -> Dict[int, Tuple[Tuple[str, ...], str]]:
    """{External id of a host event: (the program ranges it belongs to,
    outermost first; how: "range", "seq", "fallback" or "none")} from a
    chrome trace's events. A kernel, copy or set belongs to the host event
    with its ``External id`` (an op, or a range that launched it directly).
    A forward op belongs to the ranges around it on its thread (the remat
    recompute re-enters the block ranges inside the backward). A backward
    op, run by the evaluation of an autograd node, belongs to the ranges of
    the forward op that made the node: the last op that took the node's
    sequence number outside any evaluation. One with no such op goes to the
    ``train.backward`` range around it in time; ops on the backward's own
    thread (the card's autograd thread) are put under that range too.
    The benchmark's ``perfbench/ranges.py`` reads through this rule."""
    by_tid = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat == "user_annotation" and name.startswith(PREFIXES):
            by_tid[ev["tid"]].append((ev["ts"], -ev["dur"], 0, ev))
        elif cat == "cpu_op" and name.startswith(EVAL):
            by_tid[ev["tid"]].append((ev["ts"], -ev["dur"], 1, ev))
        elif cat in ("cpu_op", "user_annotation") and "External id" in (ev.get("args") or {}):
            by_tid[ev["tid"]].append((ev["ts"], -ev["dur"], 2, ev))

    seen = []        # (External id, start, own ranges, seq of the evaluation running it, in one)
    backward = []    # (start, end, ranges to and with a ``train.backward``)
    forward = {}     # sequence number -> (start, ranges) of the last first-forward op
    for items in by_tid.values():
        items.sort(key=lambda it: it[:3])
        open_ = []   # (end, kind, range name or sequence number)
        for ts, neg, kind, ev in items:
            while open_ and open_[-1][0] <= ts:
                open_.pop()
            own = tuple(x for _, k, x in open_ if k == 0)
            in_eval = kind == 1 or any(k == 1 for _, k, _ in open_)
            args = ev.get("args") or {}
            # an evaluation is a backward op, and so is an op run directly
            # by one; an op inside a range inside one (the recompute) is not
            seq = None
            if kind == 1:
                seq = args.get("Sequence number")
            elif kind == 2 and open_ and open_[-1][1] == 1:
                seq = open_[-1][2]
            elif kind == 0:
                own = own + (ev["name"],)
                if ev["name"] == BACKWARD:
                    backward.append((ts, ts - neg, own))
            if "External id" in args:
                seen.append((args["External id"], ts, own, seq, in_eval))
            if not in_eval and kind == 2 and "Sequence number" in args:
                n = args["Sequence number"]
                if n not in forward or forward[n][0] <= ts:
                    forward[n] = (ts, own)
            if kind in (0, 1):
                open_.append((ts - neg, kind, ev["name"] if kind == 0 else
                              args.get("Sequence number")))
    backward.sort()

    def around(ts):
        """The ranges of the innermost ``train.backward`` open at ``ts``."""
        i = bisect.bisect_right(backward, (ts, float("inf"))) - 1
        while i >= 0:
            a, b, stack = backward[i]
            if a <= ts < b:
                return stack
            i -= 1
        return ()

    out = {}
    for ext, ts, own, seq, in_eval in seen:
        if seq is None:
            stack = own
            if in_eval and BACKWARD not in own:
                stack = around(ts) + own
            out[ext] = (stack, "range" if stack else "none")
            continue
        fw = forward.get(seq, (0, ()))[1]
        if fw:
            out[ext] = (fw, "seq")
        else:
            stack = around(ts)
            out[ext] = (stack, "fallback" if stack else "none")
    return out


def window_of(events, name: str) -> Optional[Tuple[float, float]]:
    """(start, end) in microseconds of the first range ``name`` in a chrome
    trace's events, or None."""
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" and ev.get("name") == name:
            return ev["ts"], ev["ts"] + ev["dur"]
    return None


def _device_events(events, window=None):
    """(event, start, end) in microseconds of each kernel, copy and set,
    clipped to ``window``."""
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        a, b = ev["ts"], ev["ts"] + ev["dur"]
        if window is not None:
            a, b = max(a, window[0]), min(b, window[1])
        if b > a:
            yield ev, a, b


def device_time(events, window=None) -> Dict[str, Dict[str, float]]:
    """Device milliseconds of a chrome trace's kernels, copies and sets,
    clipped to ``window`` (microseconds, the trace's clock; None: all):
    {"kernel": {name: ms}, "count": {name: launches}, "group": {group: ms},
    "range": {innermost program range: ms}, "how": {how the range was
    found: ms}, "root": {root range a kernel reaches with no child: ms},
    "launches": {outermost program range: kernels}} (``range_of``)."""
    ranges = range_of(events)
    out = {k: defaultdict(float)
           for k in ("kernel", "count", "group", "range", "how", "root", "launches")}
    for ev, a, b in _device_events(events, window):
        ms = (b - a) / 1e3
        out["kernel"][ev["name"]] += ms
        out["count"][ev["name"]] += 1
        out["group"][group_of(ev["name"])] += ms
        stack, how = ranges.get((ev.get("args") or {}).get("External id"), ((), "none"))
        out["range"][stack[-1] if stack else OUTSIDE] += ms
        out["how"][how] += ms
        if stack and stack[-1] in ROOTS:
            out["root"][stack[-1]] += ms
        if ev["cat"] == "kernel":
            out["launches"][stack[0] if stack else OUTSIDE] += 1
    return out


def idle_gaps(events, window, n: int = 5) -> List[Tuple[float, float, Dict[str, Tuple[str, ...]], str]]:
    """The ``n`` longest stretches of ``window`` (microseconds) with no
    kernel, copy or set, longest first: (start in the window, length, in
    ms; {thread: the program ranges open at the gap's middle, outermost
    first}; the innermost op or runtime call open there)."""
    busy: List[List[float]] = []
    for _, a, b in sorted(_device_events(events, window), key=lambda x: x[1]):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [window[0]] + [t for iv in busy for t in iv] + [window[1]]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev
                 and ev["ts"] <= mid < ev["ts"] + ev["dur"]]
        by_tid = defaultdict(list)
        for ev in sorted(open_, key=lambda ev: ev["ts"]):
            if ev.get("cat") == "user_annotation" and ev["name"].startswith(PREFIXES):
                by_tid[str(ev["tid"])].append(ev["name"])
        host = [(ev["dur"], ev["name"]) for ev in open_
                if ev.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
        out.append(((a - window[0]) / 1e3, (b - a) / 1e3,
                    {t: tuple(s) for t, s in by_tid.items()},
                    min(host)[1] if host else "no host event"))
    return out


def range_lines(dev: Dict[str, Dict[str, float]]) -> List[str]:
    """``device_time``'s split by program range, each with its share of
    the device time, the shares in a root range alone, by the fallback
    rule and outside every range, and the kernels launched in each
    outermost range."""
    busy = max(sum(dev["kernel"].values()), 1e-9)
    lines = ["  by program range (innermost):"]
    for name, ms in sorted(dev["range"].items(), key=lambda kv: -kv[1]):
        lines.append(f"    {ms:9.2f} ms ({ms / busy:.2%})  {name}")
    root = sum(dev["root"].values())
    lines.append(f"  in a root range alone {root / busy:.4%} ({', '.join(sorted(dev['root']))}); "
                 f"by the fallback rule {dev['how']['fallback'] / busy:.4%}; "
                 f"outside every range {dev['range'][OUTSIDE] / busy:.4%}")
    lines.append("  kernels launched: " + ", ".join(
        f"{name} {int(k)}" for name, k in sorted(dev["launches"].items(), key=lambda kv: -kv[1])))
    return lines


def trace_report(path: Path) -> str:
    """A chrome trace written elsewhere (a benchmark cell's traced run,
    ``$TMPDIR/perfbench-<cell>-<seed>.json``): its device time by kernel
    group and by program range, clipped to the cell's window where the
    trace has one, and its five longest idle gaps with the program ranges
    open in each."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    win = window_of(events, BENCH_WINDOW)
    dev = device_time(events, win)
    busy = sum(dev["kernel"].values())
    where = (f"window {BENCH_WINDOW} {(win[1] - win[0]) / 1e3:.2f} ms" if win
             else "whole trace (no window range)")
    lines = [f"{path}: {where}, device time {busy:.2f} ms"]
    lines.append("  by kernel group:")
    for name, ms in sorted(dev["group"].items(), key=lambda kv: -kv[1]):
        lines.append(f"    {ms:9.2f} ms ({ms / max(busy, 1e-9):.2%})  {name}")
    lines += range_lines(dev)
    if win:
        lines.append("  longest idle gaps (at ms into the window: length; ranges by thread; host):")
        for at, ms, stacks, host in idle_gaps(events, win):
            open_ = "; ".join(f"{t}: {' > '.join(s)}" for t, s in sorted(stacks.items())) or "none"
            lines.append(f"    at {at:9.2f}: {ms:7.2f} ms  {open_}  [{host[:60]}]")
    return "\n".join(lines)


def card_report(arch: str, layers: int, trace_path: Path) -> str:
    """One training step of ``arch`` on the card under the profiler (B 4 x
    S 512 from ``synth_batch``, bf16 compute, remat, as ``chip_smoke.py``'s
    training phase), after two warm-up steps."""
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

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
    lines.append("  by kernel group:")
    for name, ms in sorted(dev["group"].items(), key=lambda kv: -kv[1]):
        lines.append(f"    {ms:9.2f} ms ({ms / max(busy, 1e-9):.1%})  {name}")
    lines += range_lines(dev)
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
    ap.add_argument("--trace", type=Path, default=None,
                    help="a chrome trace to split by program range (a benchmark cell's)")
    args = ap.parse_args()
    if args.trace:
        print(trace_report(args.trace))
        return
    if args.card:
        root = Path(__file__).resolve().parents[3]
        print(card_report(args.arch, args.layers, root / "build" / "profile" / "perf_trace.json"))
        return
    if not args.cell:
        ap.error("--cell, --card or --trace")
    print(report(load_cell(args.cell, args.root), args.top, args.fuse_min_elems))


if __name__ == "__main__":
    main()
