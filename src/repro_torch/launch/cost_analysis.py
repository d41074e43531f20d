"""Per-device cost of one traced step: FLOPs, HBM bytes, collective wire
bytes, by scope.

The counterpart of the reference's ``repro.launch.hlo_analysis``, which
parses XLA's partitioned HLO. Eager PyTorch has no HLO: ``CostMode`` is a
dispatch mode that watches the step run (on fake tensors in the dry run,
``runtime.trace_cell``) and counts, for one rank:

* **FLOPs** of the matrix products (``torch.utils.flop_counter``'s
  formulas) on the *local* ops: the mode lets DTensor desugar each op into
  its local ops and collectives and counts those, since a count at the
  DTensor level is the global one. Elementwise ops are not counted (the
  reference's roofline compares its dot FLOPs the same way). The kernels
  behind ctypes run no aten product: ``layers.counted_kernel`` hands their
  calls to ``kernel_region``, which counts them by formula (the flash
  forward 4 hd FLOPs and backward 10 hd a kept (query, key) pair, the
  selective scan 7 forward and 19 backward a state element) in place of
  the ops inside, the plain attention and scan on the CPU or the kernels'
  wrappers on the card alike.
* **HBM bytes**: inputs plus outputs of every local aten op that is not a
  view, unfused. That is the eager port's own traffic, one read and write
  per op, not XLA's fused traffic; a kernel region counts its inputs and
  outputs, forward and twice that backward.
* **Collective wire bytes and counts by kind** of the functional
  collectives DTensor and ``moe_ffn_a2a`` issue, with the reference's
  formulas for a group of g ranks: all-gather result·(g-1)/g, all-reduce
  2·size·(g-1)/g, reduce-scatter result·(g-1), all-to-all
  result·(g-1)/g.

Every count also goes to its scope: the two innermost ``repro_torch``
functions that issued the op ("caller/callee"), ``bwd:`` before the
forward scope of a backward op (recorded on the autograd node), ``remat:``
before that of a forward op run again in the backward, and the
``record_function`` range around it where there is one. Peak memory is
``torch.distributed._tools.mem_tracker.MemTracker``'s, entered beside this
mode by the dry run.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

def _collective_ops() -> Dict[Any, str]:
    ops = {}
    for ns in ("_c10d_functional", "_c10d_functional_autograd"):
        space = getattr(torch.ops, ns)
        for name, kind in (("all_gather_into_tensor", "all-gather"),
                           ("all_reduce", "all-reduce"),
                           ("reduce_scatter_tensor", "reduce-scatter"),
                           ("all_to_all_single", "all-to-all")):
            if hasattr(space, name):
                ops[getattr(space, name)] = kind
    return ops


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes one rank sends for a collective whose result on that rank is
    ``result_bytes``, over a group of ``group`` ranks (the reference's
    formulas, ``hlo_analysis.HloCostModel``)."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes * (g - 1) / g           # all-gather, all-to-all


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and not rets[0].alias_info.is_write


_SKIP = ("repro_torch.launch.cost_analysis",)


def _scope() -> str:
    """The two innermost ``repro_torch`` functions on the Python stack."""
    names = []
    f = sys._getframe(2)
    while f is not None and len(names) < 2:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and mod not in _SKIP:
            names.append(f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names)) or "?"


def _propagation_entries():
    """DTensor's sharding-propagation methods present in this torch."""
    import importlib

    out = []
    for module, cls_name, names in (
            ("_sharding_prop", "ShardingPropagator",
             ("propagate", "_propagate_tensor_meta_non_cached")),
            ("_decompositions", "DecompShardingStrategy", ("propagate_strategy",))):
        try:
            cls = getattr(importlib.import_module(f"torch.distributed.tensor.{module}"),
                          cls_name, None)
        except ImportError:
            cls = None
        out += [(cls, n) for n in names if cls is not None and n in cls.__dict__]
    return out


_BACKWARD = (torch.autograd.grad, torch.autograd.backward, torch.Tensor.backward)


class _Scopes(TorchFunctionMode):
    """Names each torch call's scope, and stamps it on the autograd node of
    its output for the backward ops."""

    def __init__(self, owner: "CostMode"):
        super().__init__()
        self.owner = owner

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _BACKWARD:      # its ops are the backward's, scoped there
            return func(*args, **(kwargs or {}))
        outer = self.owner._fwd_scope
        scope = outer or _scope()
        self.owner._fwd_scope = scope
        try:
            out = func(*args, **(kwargs or {}))
        finally:
            self.owner._fwd_scope = outer
        if outer is None:
            todo = [t.grad_fn for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            while todo:      # the call's nodes: down to those of earlier calls
                node = todo.pop()
                if node is None or "scope" in node.metadata:
                    continue
                node.metadata["scope"] = scope
                todo.extend(f for f, _ in node.next_functions)
        return out


class CostMode(TorchDispatchMode):
    """Counts one rank's FLOPs, HBM bytes and collectives of what runs under
    it (module docstring). Totals in ``flops``, ``bytes``,
    ``collective_bytes``, ``collective_counts`` and ``collective_bytes_by_kind``;
    per scope in ``by_scope`` ({scope: {"flops", "bytes"}}) and
    ``coll_by_scope`` ({(kind, scope): wire bytes}); HBM bytes by the
    largest output's element count in ``bytes_by_elems`` (``perf.
    whatif_fuse``); kernel regions in
    ``kernels`` ({name: {"calls", "flops", "bytes"}})."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = 0.0
        self.collective_counts: Dict[str, int] = defaultdict(int)
        self.collective_bytes_by_kind: Dict[str, float] = defaultdict(float)
        self.by_scope: Dict[str, Dict[str, float]] = defaultdict(lambda: {"flops": 0, "bytes": 0})
        self.coll_by_scope: Dict[Tuple[str, str], float] = defaultdict(float)
        self.kernels: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0})
        self.bytes_by_elems: Dict[int, int] = defaultdict(int)
        self.plain_flops = 0     # the products inside kernel regions
        self._collectives = _collective_ops()
        self._suppress = 0       # inside DTensor's sharding propagation
        self._region = 0         # inside a kernel region's forward
        self._region_nodes: set = set()
        self._ranges: list = []
        self._fwd_scope: Optional[str] = None
        self._scopes = _Scopes(self)

    def __enter__(self):
        # DTensor infers an op's output sharding by running it on shapes
        # (meta or fake tensors): none of that is the rank's work
        self._patched = []
        for cls, name in _propagation_entries():
            orig = cls.__dict__[name]
            setattr(cls, name, self._uncounted(orig))
            self._patched.append((cls, name, orig))
        self._scopes.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._scopes.__exit__(*exc)
            for cls, name, orig in self._patched:
                setattr(cls, name, orig)

    @property
    def propagating(self) -> bool:
        """Inside DTensor's sharding propagation."""
        return self._suppress > 0

    def _uncounted(self, fn):
        def run(*args, **kwargs):
            self._suppress += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._suppress -= 1
        return run

    # ------------------------------------------------------------------ #
    def _where(self) -> str:
        node = torch._C._current_autograd_node()
        if self._fwd_scope is not None or node is None:
            scope = self._fwd_scope or "?"
        else:
            # a layer's forward run again in the backward (remat) has its
            # model code on the stack; the backward proper, only the step's
            inner = _scope()
            scope = ("remat:" + inner if not inner.startswith("runtime.") and inner != "?"
                     else "bwd:" + node.metadata.get("scope", node.name()))
        return f"{self._ranges[-1]}|{scope}" if self._ranges else scope

    def _in_region(self) -> bool:
        if self._region:
            return True
        node = torch._C._current_autograd_node()
        return node is not None and self._fwd_scope is None and \
            (node.name(), node._sequence_nr()) in self._region_nodes

    def _add(self, scope: str, flops: int = 0, nbytes: int = 0) -> None:
        self.flops += flops
        self.bytes += nbytes
        s = self.by_scope[scope]
        s["flops"] += flops
        s["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar into local ops
        packet = func._overloadpacket
        if packet is torch.ops.profiler._record_function_enter_new:
            self._ranges.append(args[0])
        elif packet is torch.ops.profiler._record_function_exit and self._ranges:
            self._ranges.pop()
        out = func(*args, **kwargs)
        if self._suppress or _is_view(func):
            return out
        if self._in_region():
            if packet in flop_registry:
                self.plain_flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
            return out
        scope = self._where()
        kind = self._collectives.get(packet)
        if kind is not None:
            rb = _nbytes(out)
            group = args[-1]
            wire = wire_bytes(kind, rb, _group_size(group))
            self.collective_bytes += wire
            self.collective_counts[kind] += 1
            self.collective_bytes_by_kind[kind] += wire
            self.coll_by_scope[(kind, scope)] += wire
        nbytes = sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0]) + \
            sum(_nbytes(t) for t in tree_flatten(out)[0])
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        self._add(scope, flops, nbytes)
        elems = [t.numel() for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.bytes_by_elems[max(elems, default=0)] += nbytes
        return out

    # ------------------------------------------------------------------ #
    def kernel_region(self, name: str, fn: Callable, args, flops: Tuple[int, int]):
        """Run a kernel's call ``fn(*args)`` and count it by formula:
        ``flops`` (forward, backward). The ops inside are not counted, in
        this run nor in the backward of the autograd nodes they make (their
        products go to ``plain_flops`` alone); the
        backward's formula is counted with the first forward (a recompute in
        the backward counts its forward again, as the kernel runs again)."""
        first = torch._C._current_autograd_node() is None
        self._region += 1
        try:
            out = fn(*args)
        finally:
            self._region -= 1
        outs = out if isinstance(out, tuple) else (out,)
        io = sum(_nbytes(t) for t in args) + sum(_nbytes(t) for t in outs)
        scope = f"{self._where()}/{name}"
        k = self.kernels[name]
        k["calls"] += 1
        k["flops"] += flops[0]
        k["bytes"] += io
        self._add(scope, flops[0], io)
        grads = [t for t in outs if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        if grads:
            self._mark(grads, args)
            if first:
                k["flops"] += flops[1]
                k["bytes"] += 2 * io
                self._add(f"bwd:{scope}", flops[1], 2 * io)
        return out

    def _mark(self, outs, args) -> None:
        """The autograd nodes between ``outs`` and ``args``."""
        stop = {a.grad_fn for a in args if isinstance(a, torch.Tensor) and a.grad_fn is not None}
        todo = [t.grad_fn for t in outs]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen or \
                    node.name() == "torch::autograd::AccumulateGrad":
                continue
            seen.add(node)
            self._region_nodes.add((node.name(), node._sequence_nr()))
            todo.extend(f for f, _ in node.next_functions)

    def summary(self) -> Dict[str, Any]:
        """The dry run's ``analysis`` record (the reference's
        ``analyze_text`` keys) plus the kernel regions and
        ``plain_flops_per_device``: the count with the products of the
        kernels' plain versions in place of the kernels' formulas, what the
        reference's count of ``attention_xla`` and its scan compares with."""
        formula = sum(k["flops"] for k in self.kernels.values())
        return {
            "flops_per_device": self.flops,
            "plain_flops_per_device": self.flops - formula + self.plain_flops,
            "bytes_per_device": self.bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_by_kind": dict(self.collective_bytes_by_kind),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }
