"""Share of the traced window's device time in ops whose names hold none
of ``exclude`` (the kernel groups of the products, flash and the scan:
what is left is elementwise work, reductions and copies)."""


def read(spec, ctx):
    if ctx.trace is None:
        return None
    total = ctx.trace.device_s()
    if total <= 0:
        return None
    return 100.0 * (total - ctx.trace.time_in(spec["exclude"])) / total
