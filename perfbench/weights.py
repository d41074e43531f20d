"""The weights of a run, made from its seed on its device.

All leaves drawn from a normal come from one ``torch.randn`` call and the
dt biases from one ``torch.rand`` call, on a generator on the run's
device, in float32 (the type the port keeps its master weights and
publishes in); each leaf is a view of those buffers, scaled in place.
The same seed gives the same weights on the same device, so the
reference, run after the program, makes them again.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.seeds import substream


def make(leaves: List, c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{flat name: float32 tensor} for the configuration ``c``, whose
    reference gives ``leaves``: (name, shape, init kind) as its
    ``layout``."""
    gen = torch.Generator(device=device).manual_seed(substream(seed, "weights"))
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    normal = [i for i, (_, _, kind) in enumerate(leaves) if kind in ("normal", "out", "norm")]
    uniform = [i for i, (_, _, kind) in enumerate(leaves) if kind == "dt_bias"]
    buf_n = torch.randn(sum(sizes[i] for i in normal), generator=gen, device=device)
    buf_u = torch.rand(sum(sizes[i] for i in uniform), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    offs = {"n": 0, "u": 0}

    def take(buf, key, i):
        lo = offs[key]
        offs[key] += sizes[i]
        return buf[lo:lo + sizes[i]].view(leaves[i][1])

    L = c["num_layers"]
    for i, (name, shape, kind) in enumerate(leaves):
        if kind == "normal":
            t = take(buf_n, "n", i).mul_(0.02)
        elif kind == "out":
            t = take(buf_n, "n", i).mul_(0.02 / math.sqrt(2 * L))
        elif kind == "norm":
            t = take(buf_n, "n", i).mul_(0.02).add_(1.0)
        elif kind == "dt_bias":
            u = take(buf_u, "u", i)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            t = u.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif kind == "ssm_A":
            n = shape[-1]
            t = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)).expand(
                shape).contiguous()
        else:
            raise ValueError(kind)
        out[name] = t
    return out
