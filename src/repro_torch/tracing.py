"""Named program ranges for the port's hot paths, built on ``core/obs.py``.

``span(name)`` marks where the work happens: the train step and its
halves, the model's blocks and their parts, a served request and its
prefill and decode steps. While ``torch.profiler`` records, it enters a
``record_function`` range of that name, so the range sits in the
profiler's chrome trace beside the kernels it launched, on the
profiler's clock (``launch/perf.py`` ``range_of``, which the benchmark's
``perfbench/ranges.py`` reads through, attributes each kernel to the
ranges of the op that launched it). While an ``obs`` trace context is
active, it also records an ``obs`` span (category ``ml``) into
``obs.SPANS``, the operator's Perfetto view (``docs/torch_tracing.md``).

The off path is one check of the profiler's flag and one thread-local
read: no device sync, no host read of a tensor, nothing allocated on the
card. ``record_function`` itself costs microseconds of host time even
with the profiler off, and a train step enters hundreds of ranges.

The names are a contract (PERF.md, "Program ranges and counters"):

  train.step > train.forward, train.backward, train.adamw, train.readback
  model.cast, model.embed, model.block, model.head
  block.norm, block.qkv, block.attention, block.out, block.ssm, block.mix,
  block.ffn (``models/moe.py``'s ranges nest inside)
  serve.request > serve.snapshot, serve.cast, serve.prefill, serve.decode_step

``models/moe.py`` keeps its own ranges unconditional: the dry run
(``launch/cost_analysis.py``) reads them as scopes without a profiler.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core import obs

_profiling = torch._C._autograd._profiler_enabled


class span:
    """``with span("block.qkv"): ...``: a profiler range while the profiler
    records, an ``obs`` span while a trace context is active, else
    nothing."""

    __slots__ = ("name", "_range", "_span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = self._span = None
        if _profiling():
            self._range = record_function(self.name)
            self._range.__enter__()
        if obs.current_trace() is not None:
            self._span = obs.span(self.name, "ml")
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False
