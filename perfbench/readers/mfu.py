"""The window's model FLOPs over its wall time, as a share of the bf16
dense peak: ``flops`` names the count in ``work`` ("train_step" or
"prefill") made for each unit (a step or a request) of the timed window."""
from perfbench import work

COUNTS = {"train_step": work.train_step_flops, "prefill": work.prefill_flops}


def read(spec, ctx):
    if not ctx.window_units or ctx.peaks is None:
        return None
    flops = COUNTS[spec["flops"]](ctx.model, *ctx.shape) * ctx.window_units
    return 100.0 * flops / ctx.window_s / ctx.peaks["bf16_flops_per_s"]
