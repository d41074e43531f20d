"""The plain references against the port's CPU path at a tiny size of each
configuration family, in float32, and their pieces against plainer
forms of themselves."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import tiny, traffic, weights
from perfbench.harness import port_config, reference
from perfbench.reference import decoder as ref
from perfbench.reference import moe_decoder
from perfbench.tree import flatten, nest

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ["dense", "hybrid", "moe"]


def setup(family, S=48, seed=3):
    """The tiny spec, its model, its weights and the reference it names."""
    spec = tiny.spec(family, "train", S)
    c = spec.model
    family_ref = reference(spec)
    flat = weights.make(family_ref.layout(c), c, seed, "cpu")
    return spec, c, flat, family_ref


@pytest.mark.parametrize("family", FAMILIES)
def test_layout_is_the_ports(family):
    from repro_torch.models import model as M

    spec, c, flat, _ = setup(family)
    want = {k: tuple(v.shape) for k, v in flatten(M.abstract_params(port_config(spec))).items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_logits_match_the_port(family):
    from repro_torch.models import model as M

    spec, c, flat, family_ref = setup(family)
    tokens = traffic.request(c, dict(spec.mix, batch=2, prompt_len=48), 9, 0, "cpu")
    got, _ = M.prefill(port_config(spec), nest(flat), tokens, compute_dtype=torch.float32)
    want = family_ref.last_logits(c, flat, tokens)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_train_steps_match_the_port(family):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import runtime
    from repro_torch.optim import adamw

    spec, c, flat, family_ref = setup(family)
    mix = spec.mix
    opt = adamw.AdamWConfig(**dict(mix["optimizer"], warmup_steps=2))
    plan = runtime.CellPlan(port_config(spec), ShapeCell("t", "train", 48, 2),
                            compute_dtype=torch.float32)
    step = runtime.make_train_step(plan, opt)
    batches = [traffic.train_batch(c, mix, 4, i, "cpu") for i in range(3)]
    params = nest({k: v.clone() for k, v in flat.items()})
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    losses = []
    for i, b in enumerate(batches):
        state, met = step(state, b)
        losses.append(met["loss"])
        if i == 0:
            clip = min(1.0, opt.clip_norm / met["grad_norm"])
            g1 = {k: float(v.norm()) / ((1 - opt.b1) * clip)
                  for k, v in flatten(state["opt"]["m"]).items()}
    want = family_ref.train_steps(c, flat, batches, dataclasses.asdict(opt))
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    assert g1 == pytest.approx(want["grad_norms"], rel=1e-4, abs=1e-7)
    new = flatten(state["params"])
    change = {k: float((new[k] - flat[k]).norm()) for k in flat}
    assert change == pytest.approx(want["change"], rel=1e-3, abs=1e-9)


def sequential_scan(x, dt, Bm, Cm, A, D):
    h = torch.zeros(x.shape[1], A.shape[1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(dt[t, :, None] * A) * h + (dt[t] * x[t])[:, None] * Bm[t][None, :]
        ys.append(h @ Cm[t])
    return torch.stack(ys) + x * D


@pytest.mark.parametrize("S,dt_hi", [(5, 0.1), (64, 0.1), (100, 0.1), (100, 3.0)])
def test_chunked_scan_is_the_recurrence(S, dt_hi):
    g = torch.Generator().manual_seed(S)
    Di, N = 6, 4
    x = torch.randn(S, Di, generator=g)
    dt = torch.rand(S, Di, generator=g) * dt_hi
    Bm, Cm = torch.randn(S, N, generator=g), torch.randn(S, N, generator=g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(Di, N)
    D = torch.randn(Di, generator=g)
    got = ref.selective_scan(x, dt, Bm, Cm, A, D)
    want = sequential_scan(*(t.double() for t in (x, dt, Bm, Cm, A, D)))
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-5
    assert ref.scan_chunk_len(dt, A) * 4 * dt.max() <= 60


def test_fp8_products_round_their_operands():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 16, generator=g, requires_grad=True)
    b = torch.randn(16, 4, generator=g, requires_grad=True)
    q = ref.round_fp8(a.detach())
    big = a.detach().abs() > a.detach().abs().max() / 100   # normal numbers in e4m3
    assert float(((q - a.detach()) / a.detach())[big].abs().max()) <= 2 ** -4 + 1e-6
    assert torch.unique(q / q.abs().max() * 448).numel() <= 256
    out = ref.FP8.mm(a, b)
    out.sum().backward()
    assert a.grad is not None and b.grad is not None
    assert float((out.detach() - a.detach() @ b.detach()).abs().max()) > 0


def test_experts_compute_every_slot():
    """The MoE feed-forward equals each token's k experts, each weighted by
    its renormalised gate, taken a token and a slot at a time; a tie goes
    to the lower expert id."""
    _, c, flat, _ = setup("moe")
    mp = moe_decoder.layer_params(nest(flat)["layers"], 0)["moe"]
    h = torch.randn(2, 48, c["d_model"], generator=torch.Generator().manual_seed(5))
    got, _ = moe_decoder.moe_branch(c, mp, h, moe_decoder.FP32)
    hf = h.reshape(-1, c["d_model"])
    gates = torch.softmax(hf @ mp["router"], dim=-1)
    want = torch.zeros_like(hf)
    for t in range(hf.shape[0]):
        top = sorted(range(c["num_experts"]), key=lambda e: (-float(gates[t, e]), e))
        top = top[:c["num_experts_per_tok"]]
        norm = sum(float(gates[t, e]) for e in top)
        for e in top:
            act = torch.nn.functional.silu(hf[t] @ mp["wg"][e]) * (hf[t] @ mp["wi"][e])
            want[t] += float(gates[t, e]) / norm * (act @ mp["wo"][e])
    assert float((got.reshape_as(want) - want).abs().max() / want.abs().max()) < 1e-5
    weights, ids, _ = moe_decoder.route(torch.zeros(3, c["num_experts"]), 2)
    assert ids.tolist() == [[0, 1]] * 3 and weights.tolist() == [[0.5, 0.5]] * 3


def test_moe_reference_loads_no_jax_and_turns_tf32_off():
    """Importing the MoE reference in a fresh interpreter loads no JAX
    module and nothing of the program; its ``no_tf32`` turns TF32 off."""
    code = ("import sys, torch\n"
            "from perfbench.reference import moe_decoder\n"
            "from perfbench import harness\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "moe_decoder.no_tf32()\n"
            "print(harness.jax_modules(), 'repro_torch' in sys.modules,"
            " torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] False False False"
