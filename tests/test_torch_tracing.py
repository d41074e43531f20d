"""The port's program ranges and ML counters (``repro_torch.tracing``,
``models/runtime.py``, ``models/model.py``, ``launch/serve.py``) on the
CPU: each range of the contract is entered and nested as listed, under
the profiler only; the step's results do not depend on it; the serve,
train and publish counters count what they name; ``launch/perf.py``'s
attribution puts every op of a real step in the step."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.base import ShapeCell, get_config, reduced_config
from repro_torch.core import obs
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import perf
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model as M
from repro_torch.models.runtime import CellPlan, make_train_step
from repro_torch.optim import adamw

B, S = 2, 16
TRAIN_PARENTS = {
    "train.step": {None},
    "train.forward": {"train.step"}, "train.backward": {"train.step"},
    "train.adamw": {"train.step"}, "train.readback": {"train.step"},
    "model.cast": {"train.forward"}, "model.embed": {"train.forward"},
    "model.head": {"train.forward"},
    # the first forward, and the remat recompute inside the backward (on
    # the CPU the backward runs on the step's own thread)
    "model.block": {"train.forward", "train.backward"},
    **{f"block.{p}": {"model.block"} for p in ("norm", "qkv", "attention", "out", "ffn")},
}
HYBRID = {"block.ssm": {"model.block"}, "block.mix": {"model.block"}}
SERVE_PARENTS = {
    "serve.request": {None},
    **{f"serve.{p}": {"serve.request"} for p in ("snapshot", "cast", "prefill", "decode_step")},
    "model.cast": {"serve.prefill"}, "model.embed": {"serve.prefill"},
    "model.head": {"serve.prefill"}, "model.block": {"serve.prefill"},
    **{f"block.{p}": {"model.block"} for p in ("norm", "qkv", "attention", "out", "ffn")},
}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny steps: one thread each (several threads a tiny op on a shared
    machine take a hundred times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return reduced_config(get_config(arch))


def _step(arch, remat_policy=None):
    cfg = _cfg(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    plan = CellPlan(cfg, ShapeCell("t", "train", S, B), ce_chunk=S,
                    remat_policy=remat_policy)
    step = make_train_step(plan, adamw.AdamWConfig(warmup_steps=1))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    return step, state, [synth_batch(dcfg, i) for i in range(2)]


def _profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


def _parents(events):
    """{range name: the set of innermost program ranges around its entries
    (None for none)} on each thread."""
    rs = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and e["name"].startswith(perf.PREFIXES)), key=lambda e: (e["ts"], -e["dur"]))
    out = {}
    for i, e in enumerate(rs):
        around = [o for o in rs[:i] if o["tid"] == e["tid"]
                  and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        out.setdefault(e["name"], set()).add(around[-1]["name"] if around else None)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("remat_policy", [None, "dots"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b"])
def test_train_step_ranges_nest_as_listed(arch, remat_policy, tmp_path):
    step, state, batches = _step(arch, remat_policy)
    _, events = _profiled(lambda: step(state, batches[0]), tmp_path)
    want = dict(TRAIN_PARENTS, **(HYBRID if arch == "hymba-1.5b" else {}))
    assert _parents(events) == want
    # the recompute re-enters every block: as many blocks in the backward
    # as in the forward
    blocks = [e for e in events if e.get("name") == "model.block"]
    assert len(blocks) == 2 * _cfg(arch).num_layers

    # every op of the step lies in the step: the backward's by its forward
    # ops, the recompute by the ranges it re-enters
    got = perf.range_of(events)
    stacks = [stack for stack, _ in got.values()]
    assert all(s and s[0] == "train.step" for s in stacks)
    assert {how for _, how in got.values()} >= {"range", "seq"}
    assert any(s[:3] == ("train.step", "train.backward", "model.block") for s in stacks)


def test_serve_request_ranges_nest_as_listed(tmp_path):
    cfg = _cfg("qwen2-1.5b")
    sl = serve_mod.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, tokens=2)
    sl.publish(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    sl.refresh()
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    _, events = _profiled(lambda: sl.serve(prompts), tmp_path)
    assert _parents(events) == SERVE_PARENTS
    # a later request on the same version casts nothing
    _, events = _profiled(lambda: sl.serve(prompts), tmp_path)
    assert "serve.cast" not in _parents(events)


def test_profiler_off_enters_no_range_and_changes_nothing(monkeypatch, tmp_path):
    step, state, batches = _step("qwen2-1.5b")
    traced, _ = _profiled(lambda: step(state, batches[0]), tmp_path)
    entered = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    plain = step(state, batches[0])
    assert entered == []
    assert plain[1] == traced[1]
    for tree in ("params", "opt"):
        a, b = _flat(plain[0][tree]), _flat(traced[0][tree])
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), tree


def test_obs_trace_context_records_the_ranges():
    step, state, batches = _step("qwen2-1.5b")
    obs.SPANS.clear()
    prev = obs.set_trace((obs.new_trace_id(), 0))
    try:
        step(state, batches[0])
    finally:
        obs.set_trace(prev)
    spans = obs.SPANS.spans(clear=True)
    by_id = {s["sp"]: s for s in spans}
    names = {s["n"] for s in spans if s["c"] == "ml"}
    assert set(TRAIN_PARENTS) <= names
    step_span = next(s for s in spans if s["n"] == "train.step")
    assert by_id[next(s for s in spans if s["n"] == "train.adamw")["pa"]] is step_span


def _value(name, labels=""):
    fam = obs.REGISTRY.snapshot().get(name)
    return fam["values"].get(labels) if fam else None


def test_serve_and_train_counters():
    cfg = _cfg("qwen2-1.5b")
    sl = serve_mod.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32, tokens=3)
    sl.publish(M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    sl.refresh()
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    before = [_value("faasfs_ml_serve_requests_total"),
              _value("faasfs_ml_serve_tokens_total", "kind=prompt"),
              _value("faasfs_ml_serve_tokens_total", "kind=generated")]
    for _ in range(2):
        sl.serve(prompts)
    after = [_value("faasfs_ml_serve_requests_total"),
             _value("faasfs_ml_serve_tokens_total", "kind=prompt"),
             _value("faasfs_ml_serve_tokens_total", "kind=generated")]
    assert [a - b for a, b in zip(after, before)] == [2, 2 * B * S, 2 * B * (3 + 1)]

    step, state, batches = _step("qwen2-1.5b")
    steps, tokens = (_value("faasfs_ml_train_steps_total"),
                     _value("faasfs_ml_train_tokens_total"))
    _, met = step(state, batches[0])
    assert _value("faasfs_ml_train_steps_total") - steps == 1
    assert _value("faasfs_ml_train_tokens_total") - tokens == int(met["tokens"]) > 0


def test_publish_phases_sum_to_the_publish():
    cfg = _cfg("qwen2-1.5b")
    phases = ("detect", "to_host", "save", "commit")

    def sums():
        return {p: (_value("faasfs_ml_publish_us", f"phase={p}") or {"sum": 0.0, "count": 0})
                for p in phases}

    sl = serve_mod.ServeSlice(cfg, device="cpu", compute_dtype=torch.float32)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for new in (params, serve_mod.sparse_update(cfg, params, torch.Generator().manual_seed(2))):
        before, nbytes = sums(), _value("faasfs_ml_publish_bytes_total") or 0
        info = sl.publish(new)
        after = sums()
        assert all(after[p]["count"] - before[p]["count"] == 1 for p in phases)
        total = sum(after[p]["sum"] - before[p]["sum"] for p in phases) * 1e-6
        assert 0.95 * info.seconds <= total <= info.seconds
        assert _value("faasfs_ml_publish_bytes_total") - nbytes == info.stats["bytes_written"] > 0


def test_span_off_path_takes_no_profiler_and_no_obs_span(monkeypatch):
    monkeypatch.setattr(tracing, "record_function", None)   # would raise if called
    with tracing.span("train.step") as sp:
        pass
    assert sp._range is None and sp._span is None
