"""The traced window: ``torch.profiler`` over a few units of the timed
work, its chrome trace written under ``TMPDIR``, and the reduction of that
trace to device intervals, busy time, idle gaps and the top device ops.

The window is the benchmark's own ``perfbench.window`` range, which ends
after a device synchronize. Device work is every kernel, copy and set
event; busy time is the union of their intervals inside the window.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window: Tuple[float, float]                       # seconds, host clock of the trace
    ops: List[Tuple[str, float, float]]               # (name, start s, end s), clipped
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    path: str = ""

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, sorted."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def time_in(self, patterns) -> float:
        """Device seconds of the ops whose name holds any of ``patterns``."""
        return sum(b - a for n, a, b in self.ops if any(p in n for p in patterns))

    def device_s(self) -> float:
        return sum(b - a for _, a, b in self.ops)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the window with no device op,
        each named by the innermost host event running at its middle."""
        edges = [self.window[0]] + [t for iv in self.busy() for t in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
            out.append([min(inner)[1][:160] if inner else "no host event", b - a])
        return out


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError(f"{path}: no {WINDOW} range")
    w0 = win[0]["ts"] * 1e-6
    w1 = w0 + win[0]["dur"] * 1e-6
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = e["ts"] * 1e-6
        b = a + e["dur"] * 1e-6
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((e.get("name", "?"), a, b))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW and b > w0 and a < w1:
            host.append((e.get("name", "?"), a, b))
    return Trace((w0, w1), ops, host, path)


def traced(fn: Callable[[], None], sync: Callable[[], None], tag: str) -> Trace:
    """Run ``fn`` under the profiler inside the window range, then write
    the chrome trace to ``$TMPDIR/perfbench-<tag>.json`` and read it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    path = os.path.join(tempfile.gettempdir(), f"perfbench-{tag}.json")
    prof.export_chrome_trace(path)
    return parse(path)
