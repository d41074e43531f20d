"""A number the run counted or timed itself: ``counter`` names it among
the run's counters (set-up's publish and refresh seconds)."""


def read(spec, ctx):
    return ctx.counters.get(spec["counter"])
