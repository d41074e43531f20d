"""Share of the traced window's device time in the program ranges
``ranges`` (a kernel, copy or set counts when any range it belongs to is
one of them, by the program's rule that ``perfbench/ranges.py`` reads),
less the events whose names hold any of ``exclude``, over the window's
device time (the denominator of ``kernel_share``). Nothing to read where
the program entered no range."""
from perfbench import ranges


def read(spec, ctx):
    if ctx.trace is None or not ctx.trace.path:
        return None
    recs = ranges.read(ctx.trace.path, ctx.trace.window)
    total = ctx.trace.device_s()
    if total <= 0 or not ranges.any_ranges(recs):
        return None
    want = set(spec["ranges"])
    exclude = spec.get("exclude", [])
    hit = sum(s for _, name, s, stack, _ in recs
              if want.intersection(stack) and not any(p in name for p in exclude))
    return 100.0 * hit / total
