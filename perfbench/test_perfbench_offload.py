"""``reference/moe_offload.py`` against ``reference/moe_decoder.py`` at the
tiny MoE size on the CPU: the same numbers from the same steps, its input
weights given back bit for bit, and a whole tiny run that names it read
correct."""
import dataclasses
import time

import pytest
import torch

from perfbench import harness, tiny, traffic, weights
from perfbench.reference import moe_decoder, moe_offload


def _setup(S=48, seed=5):
    spec = tiny.spec("moe", "train", S)
    c = spec.model
    flat = weights.make(moe_decoder.layout(c), c, seed, "cpu")
    batches = [traffic.train_batch(c, spec.mix, seed, i, "cpu") for i in range(3)]
    return spec, c, flat, batches


def _close(a, b, rel):
    return abs(a - b) <= rel * max(abs(b), 1e-12)


@pytest.mark.parametrize("control", ["fp32", "fp8", "half_batch", "no_clip"])
def test_train_steps_are_moe_decoders(control):
    spec, c, flat, batches = _setup()
    opt = dict(spec.mix["optimizer"], warmup_steps=2)
    kw = {}
    if control == "fp8":
        kw = dict(prec=moe_decoder.FP8)
    elif control == "half_batch":
        kw = dict(rows=range(spec.mix["batch"] // 2))
    elif control == "no_clip":
        opt["clip_norm"] = float("inf")
    before = {k: v.clone() for k, v in flat.items()}
    want = moe_decoder.train_steps(c, flat, batches, opt, **kw)
    got = moe_offload.train_steps(c, flat, batches, opt, **kw)
    assert all(torch.equal(flat[k], before[k]) for k in flat)
    assert got["losses"] == want["losses"]
    assert all(_close(a, b, 1e-6) for a, b in zip(got["gnorms"], want["gnorms"]))
    for key in ("grad_norms", "clipped", "change"):
        assert set(got[key]) == set(want[key])
        assert all(_close(got[key][k], want[key][k], 1e-5) for k in want[key]), key


def test_gradients_over_several_loss_chunks_are_moe_decoders():
    """Each leaf's gradient is written once, whole, also where the head
    takes its gradient from several checkpointed loss chunks."""
    _, c, flat, batches = _setup()
    host = {k: torch.full_like(v, float("nan")) for k, v in flat.items()}
    loss, sq = moe_offload.loss_and_grads(c, flat, batches[0], host, ce_chunk=16)
    want_loss, want = moe_decoder.loss_and_grads(c, flat, batches[0], ce_chunk=16)
    assert loss == want_loss
    for k, g in want.items():
        torch.testing.assert_close(host[k], g, rtol=0, atol=0)
        assert _close(sq[k], float(g.square().sum()), 1e-5)


def test_a_tiny_run_with_the_offload_reference_is_correct():
    spec = tiny.spec("moe", "train")
    spec = dataclasses.replace(spec, config=dict(spec.config, reference="moe_offload"))
    assert harness.reference(spec) is moe_offload
    r = harness.run_cell(spec, 2 ** 31 + 29, 0.3, False, device="cpu",
                         t_start=time.perf_counter(), manifest=tiny.MANIFEST)
    assert r["correct"] and r["failed"] == 0, r["checks"]
