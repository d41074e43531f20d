"""Dependency-free observability for FaaSFS: metrics, tracing, logging.

Three small subsystems, shared by every layer of the stack:

**Metrics** — a `MetricsRegistry` of labeled counters / gauges /
fixed-bucket histograms. The hot-path contract is that label resolution
happens ONCE, at instrumentation-setup time: ``family.labels(...)``
returns a cached child object (identity-stable per label tuple, no
string joins), and the per-op work is a single ``child.inc()`` /
``child.observe()`` under a per-child lock. Name+label strings are only
materialized at ``snapshot()`` / ``render_prometheus()`` time, off the
hot path. Gauges may be callback-backed (sampled at snapshot time, zero
hot-path cost).

**Tracing** — an optional trace context ``(trace_id, span_id)`` carried
in a thread-local and propagated over the wire (see ``wire.FLAG_TRACE``).
Completed spans are recorded into a per-process ring buffer
(`SpanRecorder`) and export as Chrome trace-event JSON
(``chrome_trace``), so a whole `FunctionRuntime` invocation — client
RPCs, server queue/exec, WAL fsyncs, Conflict-restart chains — renders
as one timeline in Perfetto (https://ui.perfetto.dev, "Open trace
file"). Timestamps are CLOCK_MONOTONIC microseconds, comparable across
processes on one machine.

**Logging** — a tiny leveled logger emitting structured ``key=value``
lines to stderr (never stdout: the ``LISTENING`` / ``SHUTDOWN clean``
protocol lines that tests and benches parse live there), plus a
`SlowOpLog` ring of ops that blew a latency threshold, tagged with
their trace ids.

Everything here is stdlib-only and cheap enough to leave on; see
docs/observability.md for the metric catalog and overhead numbers.
"""
from __future__ import annotations

import bisect
import json
import random
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "MetricsRegistry", "SpanRecorder", "SlowOpLog", "Logger",
    "REGISTRY", "SPANS", "SLOW_OPS", "LOG",
    "now_us", "new_trace_id", "new_span_id",
    "current_trace", "set_trace", "span",
    "chrome_trace", "render_prometheus", "serve_metrics",
    "LATENCY_BUCKETS_US", "PUSH_BUCKETS_US", "SIZE_BUCKETS",
]


def now_us() -> int:
    """Monotonic microseconds (comparable across threads/processes on
    one machine — CLOCK_MONOTONIC is boot-anchored on Linux)."""
    return time.monotonic_ns() // 1000


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #

#: default histogram bucket edges for latencies, in microseconds
#: (10us .. 10s, roughly 1-2-5 per decade)
LATENCY_BUCKETS_US: Tuple[float, ...] = (
    10, 20, 50, 100, 200, 500,
    1_000, 2_000, 5_000, 10_000, 20_000, 50_000,
    100_000, 200_000, 500_000, 1_000_000, 10_000_000,
)

#: bucket edges for commit-to-holder push-invalidation latency: finer
#: below 1ms than the generic latency buckets — a push crosses one
#: machine-local socket, so the interesting regime is 10us-1ms, and the
#: long tail only needs enough resolution to flag a wedged event loop
PUSH_BUCKETS_US: Tuple[float, ...] = (
    10, 25, 50, 75, 100, 150, 250, 400, 650,
    1_000, 2_500, 5_000, 10_000, 50_000, 250_000, 1_000_000,
)

#: default bucket edges for sizes/counts (batch sizes, fan-outs, bytes)
SIZE_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 16384, 65536,
)


class Counter:
    """Monotonic counter child. ``inc`` is the whole hot-path API."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-value gauge child; optionally callback-backed (the callback
    is invoked at snapshot time, so tracking live state costs nothing
    on the hot path)."""

    __slots__ = ("_value", "_lock", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._value = 0
        self._lock = threading.Lock()
        self._fn = fn

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return 0
        return self._value


class Histogram:
    """Fixed-bucket histogram child (cumulative counts rendered at
    snapshot time; stored counts are per-bucket)."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        if list(bounds) != sorted(bounds) or not bounds:
            raise ValueError("histogram bounds must be sorted and non-empty")
        self._bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        i = bisect.bisect_left(self._bounds, v)   # v <= bounds[i] lands in i
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buckets": list(self._bounds),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> float:
        """Approximate quantile (upper bucket bound); for bench output."""
        snap = self.snapshot()
        if not snap["count"]:
            return 0.0
        target = q * snap["count"]
        acc = 0
        for i, c in enumerate(snap["counts"]):
            acc += c
            if acc >= target:
                return float(snap["buckets"][i]) if i < len(snap["buckets"]) \
                    else float(snap["buckets"][-1])
        return float(snap["buckets"][-1])


class Family:
    """A named metric with a fixed label-name tuple. ``labels(...)``
    returns the identity-stable child for a label-value tuple; the
    child is the object hot paths hold on to."""

    __slots__ = ("name", "kind", "unit", "help", "label_names",
                 "_children", "_lock", "_make")

    def __init__(self, name: str, kind: str, label_names: Tuple[str, ...],
                 make: Callable[[], Any], unit: str = "", help: str = ""):
        self.name = name
        self.kind = kind
        self.unit = unit
        self.help = help
        self.label_names = label_names
        self._children: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()
        self._make = make

    def labels(self, *values) -> Any:
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"value(s), got {len(values)}"
            )
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._make()
                    self._children[values] = child
        return child

    def children(self) -> List[Tuple[Tuple, Any]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """All metric families for one process (or one server, if plumbed
    explicitly). ``snapshot()`` returns a plain value tree that the wire
    codec can carry verbatim (T_STATS)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _family(self, name, kind, labels, make, unit, help) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, tuple(labels), make, unit, help)
                self._families[name] = fam
            elif fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(f"metric {name!r} re-registered with a "
                                 f"different kind/labels")
            return fam

    def counter(self, name: str, labels=(), unit: str = "",
                help: str = "") -> Family:
        return self._family(name, "counter", labels, Counter, unit, help)

    def gauge(self, name: str, labels=(), unit: str = "",
              help: str = "") -> Family:
        return self._family(name, "gauge", labels, Gauge, unit, help)

    def gauge_fn(self, name: str, fn: Callable[[], float], unit: str = "",
                 help: str = "", labels=(), label_values=()) -> Gauge:
        """Register (or rebind) a callback gauge. With ``labels`` /
        ``label_values`` the callback binds to that label child, so
        several processes' gauges (e.g. per-listen-address server
        gauges) can land in one scraped registry without colliding."""
        fam = self._family(name, "gauge", labels, Gauge, unit, help)
        key = tuple(label_values)
        if len(key) != len(fam.label_names):
            raise ValueError(
                f"{name}: expected {len(fam.label_names)} label "
                f"value(s), got {len(key)}"
            )
        with fam._lock:
            g = fam._children.get(key)
            if g is None:
                g = Gauge(fn)
                fam._children[key] = g
            else:
                g._fn = fn
        return g

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> Dict[str, Any]:
        """{name: {"type","unit","values":{label_str: value_or_hist}}}.
        Label strings (``op=begin``) are built HERE, not on the hot
        path."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            values: Dict[str, Any] = {}
            for lv, child in fam.children():
                key = ",".join(
                    f"{n}={v}" for n, v in zip(fam.label_names, lv)
                )
                if fam.kind == "histogram":
                    values[key] = child.snapshot()
                else:
                    values[key] = child.value
            out[fam.name] = {
                "type": fam.kind, "unit": fam.unit, "values": values,
            }
        return out

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_US, labels=(),
                  unit: str = "", help: str = "") -> Family:
        bounds = tuple(buckets)
        return self._family(
            name, "histogram", labels, lambda: Histogram(bounds), unit, help
        )


def render_prometheus(snapshot: Dict[str, Any]) -> str:
    """Prometheus text exposition (v0.0.4) from a registry snapshot."""
    lines: List[str] = []
    for name, fam in sorted(snapshot.items()):
        kind = fam["type"]
        lines.append(f"# TYPE {name} {kind}")
        for label_str, val in sorted(fam["values"].items()):
            pairs = []
            if label_str:
                for kv in label_str.split(","):
                    k, _, v = kv.partition("=")
                    pairs.append(f'{k}="{v}"')
            base = ",".join(pairs)
            if kind == "histogram":
                acc = 0
                for bound, c in zip(val["buckets"], val["counts"]):
                    acc += c
                    le = ",".join(pairs + [f'le="{bound:g}"'])
                    lines.append(f"{name}_bucket{{{le}}} {acc}")
                acc += val["counts"][-1]
                le = ",".join(pairs + ['le="+Inf"'])
                lines.append(f"{name}_bucket{{{le}}} {acc}")
                sfx = f"{{{base}}}" if base else ""
                lines.append(f"{name}_sum{sfx} {val['sum']:g}")
                lines.append(f"{name}_count{sfx} {val['count']}")
            else:
                sfx = f"{{{base}}}" if base else ""
                lines.append(f"{name}{sfx} {val}")
    return "\n".join(lines) + "\n"


def serve_metrics(port: int, registry: "MetricsRegistry",
                  host: str = "127.0.0.1"):
    """Start a daemon-thread HTTP server exposing ``registry`` as
    Prometheus text on every GET. Returns the http.server instance
    (``.server_port`` for port 0 binds; ``.shutdown()`` to stop)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            body = render_prometheus(registry.snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # stderr silence: scrapes are periodic
            pass

    srv = ThreadingHTTPServer((host, port), _Handler)
    t = threading.Thread(target=srv.serve_forever, name="faasfs-metrics",
                         daemon=True)
    t.start()
    return srv


# --------------------------------------------------------------------------- #
# crash points (failpoints for durability tests)
# --------------------------------------------------------------------------- #
#: names armed via ``--crash-at``: when execution passes a matching
#: ``crash_point(name)`` the process SIGKILLs itself — no atexit, no
#: flush, exactly the failure the WAL recovery path must survive
CRASH_POINTS: set = set()


def crash_point(name: str) -> None:
    """Die (SIGKILL, not an exception) if ``name`` is armed. Placed at
    2PC marker boundaries and migration steps so recovery tests can
    prove exactly-once application across every torn state."""
    if name in CRASH_POINTS:
        import os
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


# --------------------------------------------------------------------------- #
# tracing
# --------------------------------------------------------------------------- #
_tls = threading.local()


def new_trace_id() -> int:
    return random.getrandbits(63) | 1


def new_span_id() -> int:
    return random.getrandbits(63) | 1


def current_trace() -> Optional[Tuple[int, int]]:
    """The thread's active ``(trace_id, span_id)``, or None. One
    thread-local getattr — cheap enough for RPC hot paths."""
    return getattr(_tls, "trace", None)


def set_trace(ctx: Optional[Tuple[int, int]]) -> Optional[Tuple[int, int]]:
    """Install (or clear, with None) the thread's trace context.
    Returns the previous context so callers can restore it."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = ctx
    return prev


class SpanRecorder:
    """Per-process ring buffer of completed spans (plain dicts, wire-
    codec-safe). Bounded: old spans fall off; tracing can stay on."""

    def __init__(self, capacity: int = 8192) -> None:
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, name: str, cat: str, trace_id: int, span_id: int,
               t0_us: int, dur_us: int, parent_id: int = 0,
               tid: str = "", args: Optional[Dict[str, Any]] = None) -> None:
        rec = {
            "n": name, "c": cat, "tr": trace_id, "sp": span_id,
            "pa": parent_id, "ts": t0_us, "du": dur_us,
            "ti": tid or threading.current_thread().name,
        }
        if args:
            rec["ar"] = args
        with self._lock:
            self._buf.append(rec)

    def spans(self, trace_id: Optional[int] = None,
              clear: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._buf)
            if clear:
                self._buf.clear()
        if trace_id is not None:
            out = [s for s in out if s["tr"] == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


class span:
    """Context manager recording one span into a recorder:

        with obs.span("rpc.commit", "client"):
            ...

    Uses the thread's current trace context; records nothing when no
    trace is active (the off path is one getattr + one branch). Child
    spans get a fresh span id with the enclosing span as parent, and
    install themselves as the thread context for the duration."""

    __slots__ = ("name", "cat", "args", "recorder", "_t0", "_ctx", "_prev")

    def __init__(self, name: str, cat: str = "",
                 args: Optional[Dict[str, Any]] = None,
                 recorder: Optional[SpanRecorder] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self.recorder = recorder

    def __enter__(self):
        cur = current_trace()
        if cur is None:
            self._ctx = None
            return self
        tid, parent = cur
        self._ctx = (tid, new_span_id(), parent)
        self._prev = set_trace(self._ctx[:2])
        self._t0 = now_us()
        return self

    def __exit__(self, *exc):
        ctx = self._ctx
        if ctx is None:
            return False
        set_trace(self._prev)
        tid, sid, parent = ctx
        (self.recorder or SPANS).record(
            self.name, self.cat, tid, sid, self._t0, now_us() - self._t0,
            parent_id=parent, args=self.args,
        )
        return False


def chrome_trace(spans: List[Dict[str, Any]], pid_of=None) -> Dict[str, Any]:
    """Convert recorded spans (ours + any dumped from a server) to the
    Chrome trace-event JSON format Perfetto/chrome://tracing load.
    ``pid_of(span)`` may map spans to display processes; default groups
    by category."""
    events = []
    for s in spans:
        events.append({
            "name": s["n"],
            "cat": s["c"] or "span",
            "ph": "X",
            "ts": s["ts"],
            "dur": max(s["du"], 1),
            "pid": pid_of(s) if pid_of else (s["c"] or "span"),
            "tid": s.get("ti", ""),
            "args": dict(s.get("ar") or {},
                         trace_id=f"{s['tr']:016x}",
                         span_id=f"{s['sp']:016x}"),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[Dict[str, Any]]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f, indent=1)


# --------------------------------------------------------------------------- #
# logging + slow-op ring
# --------------------------------------------------------------------------- #
_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "off": 99}


class Logger:
    """Leveled ``key=value`` structured logger on stderr. The active
    trace id is appended automatically so log lines correlate with
    Perfetto timelines."""

    def __init__(self, level: str = "info", stream=None) -> None:
        self.level = _LEVELS[level]
        self.stream = stream

    def set_level(self, name: str) -> None:
        self.level = _LEVELS[name]

    def _emit(self, lvl: str, event: str, fields: Dict[str, Any]) -> None:
        if _LEVELS[lvl] < self.level:
            return
        parts = [f"ts={time.time():.6f}", f"level={lvl}", f"event={event}"]
        for k, v in fields.items():
            if isinstance(v, float):
                v = f"{v:.6g}"
            v = str(v)
            if " " in v or "=" in v:
                v = repr(v)
            parts.append(f"{k}={v}")
        ctx = current_trace()
        if ctx is not None:
            parts.append(f"trace={ctx[0]:016x}")
        print(" ".join(parts), file=self.stream or sys.stderr, flush=True)

    def debug(self, event: str, **fields) -> None:
        self._emit("debug", event, fields)

    def info(self, event: str, **fields) -> None:
        self._emit("info", event, fields)

    def warn(self, event: str, **fields) -> None:
        self._emit("warn", event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit("error", event, fields)


class SlowOpLog:
    """Bounded ring of ops that exceeded a latency threshold (and of
    aborted commits), each tagged with its trace id when one was
    active. Dumped alongside spans by T_TRACE_DUMP."""

    def __init__(self, capacity: int = 512) -> None:
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, op: str, dur_us: int, detail: str = "",
               trace_id: int = 0) -> None:
        if not trace_id:
            ctx = current_trace()
            trace_id = ctx[0] if ctx else 0
        rec = {"op": op, "dur_us": dur_us, "detail": detail,
               "trace": trace_id, "ts": now_us()}
        with self._lock:
            self._buf.append(rec)

    def entries(self, clear: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._buf)
            if clear:
                self._buf.clear()
        return out


# --------------------------------------------------------------------------- #
# process-wide defaults
# --------------------------------------------------------------------------- #
REGISTRY = MetricsRegistry()
SPANS = SpanRecorder()
SLOW_OPS = SlowOpLog()
LOG = Logger()


def get_registry() -> MetricsRegistry:
    return REGISTRY
