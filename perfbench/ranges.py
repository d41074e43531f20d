"""The port's program ranges in a traced window: each kernel, copy and set
of the chrome trace attributed to the ranges of the op that launched it,
by the program's own rule, ``repro_torch.launch.perf.range_of`` (a
forward op's ranges on its thread; a backward op's forward twin's, by
autograd sequence number; else ``train.backward``). Anything outside
every range is the benchmark's own work, such as making prompts and
reading logits back. A program without that rule reads nothing.
"""
from __future__ import annotations

import functools
import json
from typing import List, Optional, Tuple


@functools.lru_cache(maxsize=1)
def read(path: str, window: Optional[Tuple[float, float]] = None) -> List[Tuple]:
    """The device events of the chrome trace at ``path``, clipped to
    ``window`` (seconds, the trace's clock): (cat, name, seconds, program
    ranges, how) each. Read once per path and window."""
    try:
        from repro_torch.launch.perf import DEVICE_CATS, range_of
    except ImportError:
        return []
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = range_of(events)
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        a = ev["ts"] * 1e-6
        b = a + ev["dur"] * 1e-6
        if window is not None:
            a, b = max(a, window[0]), min(b, window[1])
        if b <= a:
            continue
        stack, how = ranges.get((ev.get("args") or {}).get("External id"), ((), "none"))
        out.append((ev["cat"], ev.get("name", "?"), b - a, stack, how))
    return out


def any_ranges(records) -> bool:
    """Whether the program entered any range in the window (a program
    without ranges has none)."""
    return any(stack for _, _, _, stack, _ in records)
