"""Whole runs of tiny cells on the CPU: the result line's keys, the
traced window's reduction, the no-JAX rule, and each fault the check has
to catch, planted in the program under a run that is otherwise whole."""
import ast
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, tiny, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(spec, *, trace_on=False, seconds=0.3, seed=2 ** 31 + 12345):
    """The result as the entry prints it: the phases' log goes to stderr."""
    r = harness.run_cell(spec, seed, seconds, trace_on, device="cpu",
                         t_start=time.perf_counter(), manifest=tiny.MANIFEST)
    assert r.pop("log")["window_s"] > 0
    return r


@pytest.mark.parametrize("family", ["dense", "hybrid", "moe"])
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_sound_run_is_correct_with_the_keys(family, kind):
    r = run(tiny.spec(family, kind))
    assert set(r) == KEYS and list(r)[-1] == "checks", r
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {"setup_s", "train_tokens_per_s"} if kind == "train" else \
        {"setup_s", "ttft_p95_s", "prompt_tokens_per_s"}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_traced_run_adds_breakdown_and_window():
    r = run(tiny.spec("dense", "serve"), trace_on=True)
    assert set(r) == KEYS | {"breakdown"} and list(r)[-1] == "checks"
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]


def test_trace_reduction_by_hand(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "fa_fwd_sm90", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "gemm_a", "ts": 25, "dur": 15},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = trace.parse(str(path))
    assert t.window_s == pytest.approx(1e-4)
    assert [x for iv in t.busy() for x in iv] == pytest.approx([1e-5, 4e-5, 7e-5, 8e-5,
                                                              9.5e-5, 1e-4])
    assert t.busy_s() == pytest.approx(4.5e-5)
    assert t.time_in(["fa_fwd"]) == pytest.approx(2e-5)
    assert t.device_s() == pytest.approx(5e-5)
    gaps = t.idle_gaps()
    assert gaps[0][0] == "aten::item" and gaps[0][1] == pytest.approx(3e-5)
    assert [g[1] for g in gaps] == pytest.approx([3e-5, 1.5e-5, 1e-5])
    top = t.top_ops()[0]
    assert top[0] == "fa_fwd_sm90" and top[1] == pytest.approx(2e-5)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_the_sources():
    """No file of the benchmark imports JAX or the JAX package, and the
    reference imports nothing of the program (top-level names whole)."""
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.JAX_NAMES), path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path


def test_no_jax_loaded_by_a_run():
    """A run's process loads no JAX module (a fresh interpreter: the test
    process has JAX from other tests)."""
    code = ("import time, sys; t = time.perf_counter()\n"
            "from perfbench import harness, tiny\n"
            "harness.run_cell(tiny.spec('hybrid', 'train'), 5, 0.1, False, device='cpu',"
            " t_start=t, manifest=tiny.MANIFEST)\n"
            "print(harness.jax_modules(), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                                        "PATH": "/usr/bin:/bin"}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_entry_refuses_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "qwen2-1.5b.train-4k", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


# --------------------------------------------------------------------------- #
# Faults planted in the program
# --------------------------------------------------------------------------- #
def _state_unchanged(monkeypatch):
    from repro_torch.models import runtime
    real = runtime.make_train_step

    def make(plan, opt_cfg):
        step = real(plan, opt_cfg)
        return lambda state, batch: (state, step(state, batch)[1])
    monkeypatch.setattr(runtime, "make_train_step", make)


def _half_batch(monkeypatch):
    from repro_torch.models import runtime
    real = runtime.make_train_step

    def make(plan, opt_cfg):
        step = real(plan, opt_cfg)

        def half(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    monkeypatch.setattr(runtime, "make_train_step", make)


def _clip_skipped(monkeypatch):
    from repro_torch.models import runtime
    real = runtime.make_train_step
    monkeypatch.setattr(runtime, "make_train_step", lambda plan, opt_cfg: real(
        plan, dataclasses.replace(opt_cfg, clip_norm=float("inf"))))


def _norm_partial(monkeypatch):
    """The global gradient norm reduced over all leaves but the first."""
    import torch
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "global_norm", lambda tree: torch.sqrt(
        sum(torch.sum(torch.square(g.float())) for g in adamw._leaves(tree)[1:])))


def _token_altered(monkeypatch):
    from repro_torch.launch import serve
    real = serve.generate

    def gen(*a, **kw):
        logits, toks = real(*a, **kw)
        toks = toks.clone()
        toks[0, 0] = logits[0].argmin()
        return logits, toks
    monkeypatch.setattr(serve, "generate", gen)


def _logits_altered(monkeypatch):
    from repro_torch.launch import serve
    real = serve.generate

    def gen(*a, **kw):
        logits, toks = real(*a, **kw)
        logits = logits.clone()
        logits[-1, 7] += 1.0
        return logits, toks
    monkeypatch.setattr(serve, "generate", gen)


def _weight_altered(monkeypatch):
    from repro_torch.launch import serve
    real = serve.params_to_numpy

    def to_numpy(tree):
        out = real(tree)
        leaf = out["params"]["final_norm"].copy()
        leaf[3] += 1e-3
        out["params"]["final_norm"] = leaf
        return out
    monkeypatch.setattr(serve, "params_to_numpy", to_numpy)


FAULTS = {"train": {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
                   "clip_skipped": _clip_skipped, "norm_partial": _norm_partial},
          "serve": {"token_altered": _token_altered, "logits_altered": _logits_altered,
                    "weight_altered": _weight_altered}}


@pytest.mark.parametrize("family", ["dense", "hybrid", "moe"])
@pytest.mark.parametrize("kind,fault", [(k, f) for k in FAULTS for f in FAULTS[k]])
def test_fault_is_not_correct(monkeypatch, family, kind, fault):
    FAULTS[kind][fault](monkeypatch)
    r = run(tiny.spec(family, kind))
    failing = [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]
    assert not r["correct"] and failing, r["checks"]


def _slot_dropped(monkeypatch):
    """Each token's last routed slot dropped at dispatch, as a full
    expert drops it."""
    from repro_torch.models import moe
    real = moe._dispatch

    def dispatch(xg, weights, ids, E, C):
        buf, src, w = real(xg, weights, ids, E, C)
        k = ids.shape[-1]
        return buf, src, w * (torch.arange(w.shape[-1], device=w.device) % k != k - 1)
    monkeypatch.setattr(moe, "_dispatch", dispatch)


def _weights_unnormalised(monkeypatch):
    """The top k gates taken as they are, not renormalised to sum 1."""
    from repro_torch.models import moe

    def routing(router_logits, k):
        gates = torch.softmax(router_logits.float(), dim=-1)
        weights, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
        return weights[..., :k], ids[..., :k]
    monkeypatch.setattr(moe, "top_k_routing", routing)


MOE_FAULTS = {"slot_dropped": _slot_dropped, "weights_unnormalised": _weights_unnormalised}


@pytest.mark.parametrize("fault", list(MOE_FAULTS))
def test_moe_fault_is_not_correct(monkeypatch, fault):
    """The routing faults under the training check. The tiny serve check
    cannot catch them: its one compared position reads ``logit_err``
    0.026-0.041 under either fault, and as much (0.017-0.034) in a sound
    bf16 run whose compared token the port routes to another expert than
    the float32 reference on a near tie, so no limit separates the two."""
    MOE_FAULTS[fault](monkeypatch)
    r = run(tiny.spec("moe", "train"))
    failing = [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]
    assert not r["correct"] and failing, r["checks"]
