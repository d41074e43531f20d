"""Deprecated shim: function-grained execution moved to ``core/runtime``.

``run_function`` predates the function-first programming model
(``repro.core.runtime.FunctionRuntime``); it survives as a thin wrapper
so existing callers keep working unmodified. New code should do::

    runtime = FunctionRuntime(local)

    @runtime.function
    def fn(fs, ...): ...

    fn(...)

which adds read-only inference, capped jittered backoff, aggregate
stats, and per-function retry policy on top of the same BEGIN-at-entry /
COMMIT-at-return / restart-on-Conflict semantics.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.runtime import FunctionRuntime, InvocationStats

__all__ = ["run_function", "InvocationStats"]


def run_function(
    local: LocalServer,
    fn: Callable[[FaaSFS], Any],
    *,
    read_only: bool = False,
    max_retries: int = 64,
    backoff_s: float = 0.0005,
    mount: str = "/mnt/tsfs",
    stats: Optional[InvocationStats] = None,
) -> Any:
    """Invoke ``fn`` as a cloud function with an implicit transaction.

    .. deprecated:: PR4
        Use :class:`repro.core.runtime.FunctionRuntime` instead.
    """
    warnings.warn(
        "run_function is deprecated; use FunctionRuntime.invoke "
        "(repro.core.runtime)",
        DeprecationWarning,
        stacklevel=2,
    )
    runtime = FunctionRuntime(
        local, mount=mount, max_retries=max_retries, backoff_s=backoff_s
    )
    return runtime.invoke(fn, read_only=read_only, stats=stats)
