"""A histogram of the port's ``obs.REGISTRY``: the child of ``family``
with ``labels``, its sum over its count, times ``scale``. Nothing to read
where the program has no such family or child, or counted nothing."""


def read(spec, ctx):
    from repro_torch.core import obs

    fam = obs.REGISTRY.snapshot().get(spec["family"])
    if fam is None:
        return None
    got = fam["values"].get(",".join(f"{k}={v}" for k, v in spec["labels"].items()))
    if not got or not got["count"]:
        return None
    return got["sum"] / got["count"] * spec["scale"]
