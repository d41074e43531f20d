"""A kernel's share of its roofline over the traced window: the least
time of the work the traced units need (each entry of ``work``, a
[kernel family, direction] pair of ``perfbench.work``, once a unit) over
the device time of the ops whose names hold one of ``kernels``. Nothing
to read where no such op ran."""
from perfbench import work

FAMILIES = {"flash": work.flash_work, "scan": work.scan_work, "experts": work.expert_work}


def read(spec, ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    spent = ctx.trace.time_in(spec["kernels"])
    if spent <= 0:
        return None
    need = sum(work.least_seconds(FAMILIES[fam](ctx.model, *ctx.shape, d), ctx.peaks)
               for fam, d in spec["work"]) * ctx.traced_units
    return 100.0 * need / spent
