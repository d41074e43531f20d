"""The control of the correctness check: the plain reference with float8
products in the program's place, and, for training, the reference with
half of each batch left out and the reference that skips the clip by the
global gradient norm. Each has to read above the sound program's
numbers, so that a limit between them fails the control.

On the CPU at a tiny size the control's readings are held against a
sound bf16 run's; on a card (``python -m pytest perfbench/
test_perfbench_control.py``) at each cell's own size, against the cell's
limits. The card tests skip without one; the fixture decides at run time.
"""
import json
import time

import pytest
import torch

from perfbench import control, harness, tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at a cell's size runs on the chip")
    return "cuda"


@pytest.mark.parametrize("family", ["dense", "hybrid", "moe"])
def test_serve_control_reads_above_the_program_on_the_cpu(family):
    spec = tiny.spec(family, "serve")
    sound = harness.run_cell(spec, 11, 0.2, False, device="cpu", t_start=time.perf_counter(),
                             manifest=tiny.MANIFEST)["checks"]
    got = control.serve_control(spec, 11, "cpu")
    assert got["logit_err"] > 3 * sound["logit_err"]["value"]


@pytest.mark.parametrize("family", ["dense", "hybrid", "moe"])
def test_train_control_and_fault_read_above_the_program_on_the_cpu(family):
    spec = tiny.spec(family, "train")
    sound = harness.run_cell(spec, 11, 0.2, False, device="cpu", t_start=time.perf_counter(),
                             manifest=tiny.MANIFEST)["checks"]
    for side, got in control.train_control(spec, 11, "cpu").items():
        assert max(got[k] / c["value"] for k, c in sound.items()) > 3, (side, got)


def _cells(kind):
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in manifest["workloads"]
            if harness.load_spec(w["name"]).mix["kind"] == kind]


SERVE = _cells("serve")
TRAIN = _cells("train")


@pytest.mark.parametrize("workload", SERVE)
def test_serve_control_fails_the_cell(card, workload):
    spec = harness.load_spec(workload)
    limits = spec.cell["check"]["limits"]
    got = control.serve_control(spec, 7, card)
    assert any(got[k] > v for k, v in limits.items() if k in got), got


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails_the_cell(card, workload):
    spec = harness.load_spec(workload)
    limits = spec.cell["check"]["limits"]
    for side, got in control.train_control(spec, 7, card).items():
        if side == "no_clip" and got["gnorm"] <= spec.mix["optimizer"]["clip_norm"]:
            continue   # the clip does not act at this seed's first step
        assert any(got[k] > v for k, v in limits.items()), (side, got)
