"""The program's attribution (``launch/perf.py`` ``range_of``,
``device_time``, ``idle_gaps``, ``perf --trace``) and the benchmark's
program-range readers (``ranges.py``, ``readers/range_share.py``,
``range_count.py``, ``registry.py``) on a chrome trace built by hand,
against values worked out by hand; a program with no ranges, no
attribution rule or no counters reads nothing."""
import json
import time

import pytest
import torch

from perfbench import harness, ranges, tiny, trace
from perfbench.readers import range_count, range_share, registry
from repro_torch.core import obs
from repro_torch.launch import perf

EXCLUDE = harness.load_metric("elementwise_share.train")["exclude"]
CHAIN = ["block.norm", "block.qkv", "block.mix", "block.ffn"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _op(name, ts, ext, seq=None, tid=1, dur=5):
    args = {"External id": ext}
    if seq is not None:
        args["Sequence number"] = seq
    return _x("cpu_op", name, ts, dur, tid, **args)


def _k(name, ts, dur, ext, cat="kernel"):
    return _x(cat, name, ts, dur, tid=7, **{"External id": ext})


def _eval(node, ts, dur, seq, ext):
    return _x("cpu_op", f"autograd::engine::evaluate_function: {node}", ts, dur, 2,
              **{"External id": ext, "Sequence number": seq})


# one step on thread 1, its backward on the card's autograd thread 2 (times in us)
EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 1000, **{"External id": 1}),
    _x("user_annotation", "train.step", 10, 890, **{"External id": 2}),
    _x("user_annotation", "train.forward", 20, 280, **{"External id": 3}),
    _x("user_annotation", "model.block", 30, 170, **{"External id": 4}),
    _x("user_annotation", "block.qkv", 40, 60, **{"External id": 5}),
    _op("aten::mm", 50, 101, seq=5), _k("nvjet_tst_gemm", 60, 30, 101),
    _op("aten::add", 70, 102, seq=6), _k("vectorized_elementwise_add", 95, 20, 102),
    _x("user_annotation", "block.norm", 110, 40, **{"External id": 6}),
    _op("aten::mul", 120, 103, seq=7), _k("vectorized_elementwise_mul", 125, 10, 103),
    # in a root range alone
    _op("aten::sum", 250, 104, seq=8), _k("reduce_kernel", 260, 5, 104),
    _x("user_annotation", "train.backward", 310, 290, **{"External id": 7}),
    # a backward op: the forward op that took sequence number 6 (block.qkv)
    _eval("AddBackward0", 320, 20, 6, 201), _op("aten::mul", 325, 202, tid=2),
    _k("bwd_mul", 345, 15, 202),
    # the remat recompute inside an evaluation (its own sequence numbers),
    # then the evaluation's own op: the forward op of sequence number 7
    _eval("MulBackward0", 350, 100, 7, 203),
    _x("user_annotation", "model.block", 355, 85, 2, **{"External id": 208}),
    _x("user_annotation", "block.norm", 360, 40, 2, **{"External id": 209}),
    _op("aten::mul", 365, 204, seq=50, tid=2), _k("recompute_mul", 460, 10, 204),
    _op("aten::mul", 445, 205, tid=2, dur=3), _k("bwd_norm_mul", 470, 10, 205),
    # a backward op with no forward op: the fallback, train.backward
    _eval("SomeBackward0", 480, 20, 99, 206), _op("aten::fill_", 485, 207, tid=2),
    _k("fill_kernel", 505, 5, 207),
    _x("user_annotation", "train.adamw", 610, 190, **{"External id": 8}),
    _op("aten::_foreach_mul", 620, 105), _k("adam_elementwise", 630, 100, 105),
    _k("Memcpy DtoH", 740, 10, 105, cat="gpu_memcpy"),
    # outside every range: the benchmark's own work; the last kernel runs
    # past the window's end
    _op("aten::randint", 910, 301), _k("randint_kernel", 920, 20, 301),
    _k("randint_kernel", 990, 20, 301),
]
TOTAL = 30 + 20 + 10 + 5 + 100 + 10 + 15 + 10 + 10 + 5 + 20 + 10
STEP = ("train.step",)
WANT = {
    101: (STEP + ("train.forward", "model.block", "block.qkv"), "range"),
    103: (STEP + ("train.forward", "model.block", "block.norm"), "range"),
    104: (STEP + ("train.forward",), "range"),
    202: (STEP + ("train.forward", "model.block", "block.qkv"), "seq"),
    204: (STEP + ("train.backward", "model.block", "block.norm"), "range"),
    205: (STEP + ("train.forward", "model.block", "block.norm"), "seq"),
    207: (STEP + ("train.backward",), "fallback"),
    105: (STEP + ("train.adamw",), "range"),
    301: ((), "none"),
}


@pytest.fixture
def ctx(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    t = trace.parse(str(path))
    return harness.ReadContext({}, (1, 1), 1, 1.0, 2, t, {}, None)


def test_attribution_by_hand_and_perf_agrees():
    got = perf.range_of(EVENTS)
    assert {k: got[k] for k in WANT} == WANT


@pytest.mark.parametrize("window", [None, (0, 1000)])
def test_device_time_by_range_by_hand(window):
    """Innermost range, how it was found, root alone and launches, in ms;
    the window clips the last kernel from 20 to 10 us."""
    dev = perf.device_time(EVENTS, window)
    tail = 10 if window else 20
    us = lambda d: {k: pytest.approx(v * 1e3) for k, v in d.items()}
    assert {k: pytest.approx(v) for k, v in us(dev["range"]).items()} == {
        "block.qkv": 65, "block.norm": 30, "train.forward": 5, "train.backward": 5,
        "train.adamw": 110, perf.OUTSIDE: 20 + tail}
    assert us(dev["how"]) == {"range": 185, "seq": 25, "fallback": 5, "none": 20 + tail}
    assert us(dev["root"]) == {"train.forward": 5}
    assert dev["launches"] == {"train.step": 9, perf.OUTSIDE: 2}
    assert sum(dev["kernel"].values()) == pytest.approx((TOTAL - 10 + tail) / 1e3)
    lines = "\n".join(perf.range_lines(dev))
    assert f"in a root range alone {5 / (TOTAL - 10 + tail):.4%}" in lines
    assert "by the fallback rule " + f"{5 / (TOTAL - 10 + tail):.4%}" in lines


def test_idle_gaps_by_hand():
    """The four longest stretches with no device work, the ranges open at
    their middles on each thread and the innermost host op there."""
    got = perf.idle_gaps(EVENTS, (0, 1000), 4)
    assert [(at, ms) for at, ms, _, _ in got] == [
        (0.75, 0.17), (0.135, 0.125), (0.51, 0.12), (0.36, 0.1)]
    assert [stacks for _, _, stacks, _ in got] == [
        {"1": STEP}, {"1": STEP + ("train.forward", "model.block")},
        {"1": STEP + ("train.backward",)},
        {"1": STEP + ("train.backward",), "2": ("model.block",)}]
    assert [host for _, _, _, host in got] == [
        "no host event", "no host event", "no host event",
        "autograd::engine::evaluate_function: MulBackward0"]


def test_perf_trace_reports_a_cell_trace(tmp_path, capsys, monkeypatch):
    path = tmp_path / "perfbench-cell-7.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    monkeypatch.setattr("sys.argv", ["perf", "--trace", str(path)])
    perf.main()
    out = capsys.readouterr().out
    assert f"window {trace.WINDOW} 1.00 ms, device time {TOTAL / 1e3:.2f} ms" in out
    assert f"outside every range {30 / TOTAL:.4%}" in out
    assert "kernels launched: train.step 9, " in out
    assert "at      0.75:    0.17 ms  1: train.step  [no host event]" in out


def test_a_program_without_the_rule_reads_nothing(ctx, monkeypatch):
    monkeypatch.delattr(perf, "range_of")
    ranges.read.cache_clear()
    try:
        assert range_share.read({"ranges": ["train.adamw"]}, ctx) is None
        assert range_count.read({"ranges": ["train.step"]}, ctx) is None
    finally:
        ranges.read.cache_clear()


def test_range_readers_by_hand(ctx):
    assert ctx.trace.device_s() == pytest.approx(TOTAL * 1e-6)
    adamw = {"ranges": ["train.adamw"]}
    assert range_share.read(adamw, ctx) == pytest.approx(100 * 110 / TOTAL)
    chain = {"ranges": CHAIN, "exclude": EXCLUDE}
    assert range_share.read(chain, ctx) == pytest.approx(100 * (20 + 10 + 15 + 10 + 10) / TOTAL)
    # kernels (not the copy) in the step or a range inside it, over 2 units
    assert range_count.read({"ranges": ["train.step"]}, ctx) == pytest.approx(9 / 2)


def test_no_ranges_reads_nothing(tmp_path):
    bare = [e for e in EVENTS if not e["name"].startswith(perf.PREFIXES)]
    path = tmp_path / "bare.json"
    path.write_text(json.dumps({"traceEvents": bare}))
    c = harness.ReadContext({}, (1, 1), 1, 1.0, 2, trace.parse(str(path)), {}, None)
    assert range_share.read({"ranges": ["train.adamw"]}, c) is None
    assert range_count.read({"ranges": ["train.step"]}, c) is None


def test_registry_reader(monkeypatch):
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "REGISTRY", reg)
    spec = {"family": "faasfs_ml_publish_us", "labels": {"phase": "save"}, "scale": 1e-6}
    assert registry.read(spec, None) is None
    fam = reg.histogram("faasfs_ml_publish_us", labels=("phase",))
    assert registry.read(spec, None) is None
    fam.labels("save").observe(2_000_000)
    fam.labels("save").observe(4_000_000)
    fam.labels("commit").observe(9)
    assert registry.read(spec, None) == pytest.approx(3.0)


def test_traced_tiny_serve_reports_the_publish_phases():
    """A whole traced run reads the new metrics without raising; the CPU
    trace has no device events, so only the publish phases read."""
    spec = tiny.spec("dense", "serve")
    names = {"publish_to_host_s.serve", "publish_save_s.serve", "publish_commit_s.serve",
             "chain_share.serve"}
    manifest = dict(tiny.MANIFEST, per_layer=[
        dict(harness.load_metric(n), workloads=[spec.name]) for n in sorted(names)])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run_cell(spec, 2 ** 31 + 7, 0.3, True, device="cpu",
                             t_start=time.perf_counter(), manifest=manifest)
    finally:
        torch.set_num_threads(threads)
    got = r["metrics"]
    # the registry is the process's: other publishes of the test process
    # may be in its means
    assert set(got) == names - {"chain_share.serve"}
    assert all(m["value"] > 0 for m in got.values())
