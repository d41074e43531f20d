"""Run one cell of the benchmark once and make its result line.

A cell (``cells/<name>.json``) names a configuration (``configs/``), a
traffic mix (``mixes/``) and the chips it takes; the mix's ``kind`` names
the module (``drivers/<kind>.py``) that sets the port up, warms it, runs
the timed window and checks what the window produced. ``BENCHMARK.json``
says which metrics a cell reports; each per-layer metric's file under
``metrics/`` names its reader (``readers/<reader>.py``). A later cell,
mix, configuration or metric is a new file, found by its name.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class GcWatch:
    """Counts the interpreter's full (generation 2) collections and their
    seconds while it is entered: a pause of the host that the log shows
    beside the window's unit times."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, 0.0

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def unit_times(times: List[float]) -> List[float]:
    """[min, median, max] of the window's step or request times."""
    s = sorted(times)
    return [s[0], s[len(s) // 2], s[-1]] if s else []


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The readings the cell has a limit for, in the limits' order; the
    others go to the log only."""
    return [Check(k, readings[k], v) for k, v in limits.items()]


@dataclass
class Outcome:
    """What a driver hands back."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    shape: Tuple[int, int]
    window_units: int
    window_s: float
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Any = None
    traced_units: int = 0
    phases: Dict[str, float] = field(default_factory=dict)   # seconds, for the log


@dataclass
class Spec:
    """A cell with its configuration and mix, loaded."""
    name: str
    cell: Dict
    config: Dict
    mix: Dict

    @property
    def model(self) -> Dict:
        return self.config["model"]


@dataclass
class ReadContext:
    model: Dict
    shape: Tuple[int, int]
    window_units: int
    window_s: float
    traced_units: int
    trace: Any
    counters: Dict[str, float]
    peaks: Optional[Dict]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec(name: str, root: Path = HERE) -> Spec:
    cell = _json(root / "cells" / f"{name}.json")
    return Spec(name, cell, _json(root / "configs" / f"{cell['config']}.json"),
                _json(root / "mixes" / f"{cell['traffic']}.json"))


def load_metric(name: str, root: Path = HERE) -> Dict:
    return _json(root / "metrics" / f"{name}.json")


def cell_metrics(manifest: Dict, cell: str, traced: bool) -> List[Dict]:
    """The manifest's end-to-end metrics (or per-layer ones, when
    ``traced``) that the cell reports: those whose ``workloads`` name it,
    or that have none."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in manifest[key] if cell in m.get("workloads", [cell])]


def peaks_for(kind: str, root: Path = HERE) -> Optional[Dict]:
    return _json(root / "peaks.json").get(kind)


def reference(spec: Spec):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return importlib.import_module(f"perfbench.reference.{spec.config['reference']}")


def compute_dtype(spec: Spec):
    """The type the configuration states the port computes in."""
    import torch

    return getattr(torch, spec.config["compute_dtype"])


def port_config(spec: Spec):
    """The port's ``ModelConfig`` as the configuration file states it."""
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(name=spec.config["name"],
                       **{k: v for k, v in spec.model.items() if k in fields})


def jax_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(JAX_NAMES))


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, *, device: str,
             t_start: float, manifest: Dict, root: Path = HERE) -> Dict:
    """Run the cell once; returns the result object (without printing)."""
    driver = importlib.import_module(f"perfbench.drivers.{spec.mix['kind']}")
    out: Outcome = driver.run(spec, seed=seed, seconds=seconds, trace=trace, device=device,
                              t_start=t_start)
    kind, power = device_name(device)
    peaks = peaks_for(kind, root)
    metrics: Dict[str, Dict] = {}
    if trace:
        ctx = ReadContext(spec.model, out.shape, out.window_units, out.window_s,
                          out.traced_units, out.trace, out.counters, peaks)
        for m in cell_metrics(manifest, spec.name, True):
            meta = load_metric(m["name"], root)
            reader = importlib.import_module(f"perfbench.readers.{meta['reader']}")
            value = reader.read(meta, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(manifest, spec.name, False):
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": spec.cell["chips"], "memory_peak_bytes": out.memory_peak_bytes,
           "power_limit_w": power}
    result = {"correct": out.failed == 0 and all(c.ok for c in out.checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(),
                               "idle_gaps": out.trace.idle_gaps()}
    result["log"] = dict(out.phases, **out.e2e)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result


def device_name(device: str) -> Tuple[str, Optional[str]]:
    """The card's name as torch gives it and its power limit as
    ``nvidia-smi`` reads it (None where it cannot)."""
    if device != "cuda":
        return device, None
    import subprocess

    import torch

    power = None
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        power = got.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(0), power
