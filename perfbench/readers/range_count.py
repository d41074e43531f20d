"""Kernels launched in the program ranges ``ranges`` or in any range
inside them (the program's rule, ``perfbench/ranges.py``), a traced
unit. Copies and sets are not kernels. Nothing to read where the program
entered no range."""
from perfbench import ranges


def read(spec, ctx):
    if ctx.trace is None or not ctx.trace.path or not ctx.traced_units:
        return None
    recs = ranges.read(ctx.trace.path, ctx.trace.window)
    if not ranges.any_ranges(recs):
        return None
    want = set(spec["ranges"])
    return sum(cat == "kernel" and bool(want.intersection(stack))
               for cat, _, _, stack, _ in recs) / ctx.traced_units
