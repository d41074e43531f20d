"""Function-first programming model: the FaaS invocation runtime.

The paper's core promise (§3.3) is that a cloud function body written
against POSIX just works: BEGIN is implicit at function entry, COMMIT at
return, an OCC ``Conflict`` transparently restarts the function, and the
warm container's block cache survives between invocations. This module
is that promise as an API:

    runtime = FunctionRuntime(LocalServer(backend))

    @runtime.function
    def deliver(fs, mailbox, body):
        fd = fs.open(f"/mnt/tsfs/mail/{mailbox}", O_CREAT | O_APPEND)
        fs.write(fd, body)
        fs.close(fd)

    deliver("alice", b"hi")          # an invocation == one transaction

Semantics:

* **Implicit transaction boundaries.** Each invocation begins a
  transaction on the runtime's ``LocalServer`` and commits at return.
  Exceptions abort (rollback is free: writes are buffered client-side).
* **Automatic restart on Conflict** with capped, jittered exponential
  backoff. The function must be retry-safe — exactly the idempotence
  contract cloud platforms already impose — and atomic commit upgrades
  that to exactly-once *visible* effects (paper §3.3, citing AFT).
* **Warm-container cache semantics.** The ``LocalServer`` (and its block
  cache) is shared across invocations; every retry gets a **fresh**
  ``FaaSFS`` (fresh fd table, fresh transaction) over the warm cache.
* **Read-only fast path.** ``read_only=True`` invocations take snapshot
  reads and skip commit validation entirely (they serialize at their
  read timestamp and burn no commit timestamps). With
  ``read_only=None`` (the default for decorated functions) the runtime
  *infers* it: once an invocation commits with zero effects, later
  invocations run read-only; if an inferred-read-only run then attempts
  a write, the runtime transparently restarts it read-write and pins the
  function as a writer.
* **Stats.** Pass ``stats=InvocationStats()`` for one invocation's
  numbers; ``runtime.stats`` aggregates across all invocations.

``repro.core.retry.run_function`` survives as a thin deprecated shim
over ``FunctionRuntime.invoke``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import obs
from repro_torch.core.blockstore import SnapshotTooOld
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.types import Conflict, TxnStateError

# warm-container cache health, sampled per invocation epilogue (not hot)
_CACHE_GAUGES = {
    k: obs.REGISTRY.gauge(
        f"faasfs_client_cache_{k}",
        help=f"LocalServer block cache {k} (latest runtime sample)",
    ).labels()
    for k in ("hits", "misses", "evictions", "size")
}


def _abort_reasons_of(c: Conflict) -> List[Dict[str, Any]]:
    """Structured explanation of one Conflict: prefer the server-side
    ``detail`` (tag/key/shard/winner); fall back to the legacy keys."""
    if getattr(c, "detail", None):
        return [dict(d) for d in c.detail]
    return [{"tag": tag, "key": key} for tag, key in (c.keys or [])]


@dataclass
class InvocationStats:
    """One invocation's numbers (pass ``stats=`` to ``invoke``)."""

    attempts: int = 0
    aborts: int = 0
    commit_ts: int = 0
    wall_s: float = 0.0
    read_only: bool = False
    #: one entry per abort: {"tag", "key", "shard"?, "winner"?} dicts
    #: explaining WHAT conflicted (paper §3.3's restart loop, made visible)
    abort_reasons: List[Dict[str, Any]] = field(default_factory=list)
    #: trace id (nonzero when the runtime ran with tracing on)
    trace_id: int = 0


@dataclass
class RuntimeStats:
    """Aggregate across every invocation this runtime ran."""

    invocations: int = 0
    attempts: int = 0
    aborts: int = 0
    read_only_invocations: int = 0
    retries_exhausted: int = 0
    wall_s: float = 0.0
    #: abort count by conflicting item kind ("block"/"name"/"meta"/...)
    abort_reasons: Dict[str, int] = field(default_factory=dict)

    def _count_aborts(self, reasons: List[Dict[str, Any]]) -> None:
        for r in reasons:
            tag = str(r.get("tag", "unknown"))
            self.abort_reasons[tag] = self.abort_reasons.get(tag, 0) + 1


class FaaSFunction:
    """A function registered with a runtime; calling it invokes it.

    ``read_only=None`` means "infer": ``_effective_read_only`` starts
    read-write and flips to read-only after the first invocation that
    commits without effects; a read-only run that attempts a write flips
    it back permanently.
    """

    def __init__(
        self,
        runtime: "FunctionRuntime",
        fn: Callable[..., Any],
        read_only: Optional[bool] = None,
        max_retries: Optional[int] = None,
    ):
        self.runtime = runtime
        self.fn = fn
        self.declared_read_only = read_only
        self.max_retries = max_retries
        self._inferred_read_only: Optional[bool] = None
        self.__name__ = getattr(fn, "__name__", "faas_function")
        self.__doc__ = fn.__doc__

    def _effective_read_only(self) -> bool:
        if self.declared_read_only is not None:
            return self.declared_read_only
        return bool(self._inferred_read_only)

    def _observe(self, read_only: bool, had_effects: bool) -> None:
        if self.declared_read_only is not None:
            return
        if not read_only and self._inferred_read_only is None:
            self._inferred_read_only = not had_effects

    def _demote(self) -> None:
        self._inferred_read_only = False

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.runtime.invoke(self, *args, **kwargs)


class FunctionRuntime:
    """Executes functions as implicit transactions over one warm worker.

    One runtime wraps one ``LocalServer`` — the paper's per-instance
    Local Server whose cache makes warm invocations fast. Create one per
    simulated container/worker.
    """

    def __init__(
        self,
        local: LocalServer,
        mount: str = "/mnt/tsfs",
        max_retries: int = 64,
        backoff_s: float = 0.0005,
        max_backoff_s: float = 0.01,
        strict_paths: bool = False,
        seed: Optional[int] = None,
        trace: bool = False,
        max_staleness_s: Optional[float] = None,
    ):
        self.local = local
        self.mount = mount
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.strict_paths = strict_paths
        self.trace = trace
        self.stats = RuntimeStats()
        self._rng = random.Random(seed)
        # bounded-staleness reads: read-only invocations may be served
        # from the container-shared lease tier (core/leases.py) with NO
        # server round trips while the cached view is younger than this
        # bound and no commit-time invalidation ended it
        self.max_staleness_s = max_staleness_s
        if max_staleness_s is not None and local.lease_tier is None:
            from repro_torch.core import leases
            leases.attach_lease_tier(local, max_staleness_s=max_staleness_s)

    # ------------------------------------------------------------------ #
    def function(
        self,
        fn: Optional[Callable[..., Any]] = None,
        *,
        read_only: Optional[bool] = None,
        max_retries: Optional[int] = None,
    ) -> Any:
        """Decorator: register ``fn`` as a cloud function of this runtime.

        Usable bare (``@runtime.function``) or with options
        (``@runtime.function(read_only=True)``)."""
        def wrap(f: Callable[..., Any]) -> FaaSFunction:
            return FaaSFunction(self, f, read_only, max_retries)
        return wrap(fn) if fn is not None else wrap

    # ------------------------------------------------------------------ #
    def _sleep(self, attempt: int) -> None:
        if self.backoff_s <= 0:
            return
        cap = min(self.backoff_s * (2 ** min(attempt, 16)), self.max_backoff_s)
        time.sleep(cap * (0.5 + self._rng.random()))

    def invoke(
        self,
        fn: Callable[..., Any],
        *args: Any,
        read_only: Optional[bool] = None,
        max_retries: Optional[int] = None,
        stats: Optional[InvocationStats] = None,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn(fs, *args, **kwargs)`` as one FaaS invocation.

        ``fn`` may be a plain callable or a ``FaaSFunction``; explicit
        ``read_only=`` wins over the function's declaration/inference.
        """
        faas = fn if isinstance(fn, FaaSFunction) else None
        body = faas.fn if faas is not None else fn
        if max_retries is None:
            max_retries = (
                faas.max_retries if faas and faas.max_retries is not None
                else self.max_retries
            )
        ro = (
            read_only if read_only is not None
            else faas._effective_read_only() if faas is not None
            else False
        )
        inferred = read_only is None and faas is not None and ro \
            and faas.declared_read_only is None

        t0 = time.perf_counter()
        self.stats.invocations += 1
        # one trace id spans the WHOLE invocation, Conflict restarts
        # included — every retry attempt renders on the same Perfetto
        # timeline (see docs/observability.md)
        trace_prev: Any = None
        trace_ctx: Any = None
        inv_t0 = 0
        name = getattr(body, "__name__", "faas_function")
        if self.trace:
            trace_ctx = (obs.new_trace_id(), obs.new_span_id())
            trace_prev = obs.set_trace(trace_ctx)
            inv_t0 = obs.now_us()
            if stats:
                stats.trace_id = trace_ctx[0]
        try:
            return self._invoke_loop(
                body, faas, args, kwargs, ro, inferred, max_retries,
                stats, t0, name,
            )
        finally:
            if self.trace:
                obs.SPANS.record(
                    f"invoke.{name}", "runtime", trace_ctx[0], trace_ctx[1],
                    inv_t0, obs.now_us() - inv_t0,
                )
                obs.set_trace(trace_prev)
            # warm-container cache health: sampled once per invocation,
            # never on the block fetch path
            cs = self.local.cache_stats()
            for k, g in _CACHE_GAUGES.items():
                g.set(cs.get(k, 0))

    def _invoke_loop(
        self, body, faas, args, kwargs, ro, inferred, max_retries,
        stats, t0, name,
    ) -> Any:
        last: Optional[Conflict] = None
        attempt = 0
        while attempt < max_retries:
            with obs.span("invoke.attempt", "runtime", args={"n": attempt}):
                txn = self.local.begin(
                    read_only=ro, max_staleness_s=self.max_staleness_s,
                )
                fs = FaaSFS(txn, mount=self.mount, strict=self.strict_paths)
                self.stats.attempts += 1
                if stats:
                    stats.attempts += 1
                    stats.read_only = ro
                try:
                    result = body(fs, *args, **kwargs)
                except TxnStateError:
                    txn.abort()
                    if inferred:
                        # the read-only inference was wrong (the function
                        # wrote this time): restart read-write, pin writer
                        faas._demote()  # type: ignore[union-attr]
                        ro = inferred = False
                        continue
                    raise
                except Conflict as c:
                    # functions normally surface conflicts at commit, but a
                    # mid-body Conflict (e.g. a nested commit) retries too
                    txn.abort()
                    last = c
                    self._note_abort(c, stats, name)
                    attempt += 1
                    continue
                except SnapshotTooOld:
                    txn.abort()
                    if txn.lease_view and self.local.lease_tier is not None:
                        # the view outlived the retained history (a slot
                        # migration GC'd versions behind it): close it and
                        # restart against a fresh real begin
                        self.local.lease_tier.invalidate_view()
                        attempt += 1
                        continue
                    raise
                except BaseException:
                    txn.abort()
                    raise
                try:
                    ts = txn.commit()
                except Conflict as c:
                    last = c
                    self.stats.aborts += 1
                    if stats:
                        stats.aborts += 1
                    self._note_abort(c, stats, name)
                    attempt += 1
                    self._sleep(attempt)
                    continue
                wall = time.perf_counter() - t0
                self.stats.wall_s += wall
                if ro:
                    self.stats.read_only_invocations += 1
                if stats:
                    stats.commit_ts = ts
                    stats.wall_s = wall
                if faas is not None:
                    faas._observe(ro, txn.committed_payload.has_effects())
                return result
        self.stats.retries_exhausted += 1
        self.stats.wall_s += time.perf_counter() - t0
        raise Conflict(
            f"function failed to commit after {max_retries} attempts: {last}",
            last.keys if last else [],
            detail=getattr(last, "detail", None) if last else None,
        )

    def _note_abort(self, c: Conflict, stats: Optional[InvocationStats],
                    name: str) -> None:
        """Fold one Conflict's explanation into the per-invocation and
        aggregate stats, and log it against the active trace."""
        reasons = _abort_reasons_of(c)
        if stats:
            stats.abort_reasons.extend(reasons)
        self.stats._count_aborts(reasons)
        ctx = obs.current_trace()
        obs.SLOW_OPS.record(
            f"abort.{name}", 0,
            detail="; ".join(
                f"{r.get('tag')}:{r.get('key')}"
                + (f"@shard{r['shard']}" if "shard" in r else "")
                for r in reasons[:4]
            ),
            trace_id=ctx[0] if ctx else 0,
        )


def runtime_for(target, **kwargs) -> FunctionRuntime:
    """Coerce a ``LocalServer`` or ``FunctionRuntime`` to a runtime.

    The ML-state layers (``CheckpointManager``, ``PagedKVCache``,
    ``SnapshotServer``) accept either so legacy call sites that hold a
    bare ``LocalServer`` keep working after the ``run_function``
    deprecation; a runtime built here is cached on the server, so every
    layer sharing one worker shares one runtime (and its stats)."""
    if isinstance(target, FunctionRuntime):
        return target
    rt = getattr(target, "_default_runtime", None)
    if rt is None:
        rt = FunctionRuntime(target, **kwargs)
        target._default_runtime = rt
    return rt
