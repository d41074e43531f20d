"""BENCHMARK.json and the benchmark's data files: names, units, keys and
cross references, and that a new configuration, mix, cell or metric is
found by its name with no file that exists edited."""
import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["perfbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in manifest["command"])
    assert (ROOT / manifest["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


# a configuration file's model key -> the published config.json key it is
PUBLISHED = {"num_layers": "num_hidden_layers", "d_model": "hidden_size",
             "num_heads": "num_attention_heads", "num_kv_heads": "num_key_value_heads",
             "d_ff": "intermediate_size", "vocab_size": "vocab_size", "rope_theta": "rope_theta",
             "norm_eps": "rms_norm_eps", "tie_embeddings": "tie_word_embeddings",
             "ssm_state": "mamba_d_state", "ssm_conv": "mamba_d_conv",
             "dt_rank": "mamba_dt_rank"}
NOT_PUBLISHED = {"family", "qkv_bias"}   # architecture, not a key of config.json


def published_value(pub, key):
    if key == "sliding_window":
        return pub["sliding_window"] if pub.get("use_sliding_window", True) else 0
    if key == "d_inner":
        return pub["mamba_expand"] * pub["hidden_size"]
    if key == "head_dim":
        return pub.get("head_dim", pub["hidden_size"] // pub["num_attention_heads"])
    return pub[PUBLISHED[key]]


def test_model_keys_are_the_published_ones(manifest):
    """Every size the port is given equals its published key, unless the
    manifest lists it as reduced."""
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key, value in cfg["model"].items():
            if key not in NOT_PUBLISHED and key not in c["reduced"]:
                assert value == published_value(cfg["published_keys"], key), (c["name"], key)


def test_per_layer_metrics_report_what_they_move(manifest):
    """Each per-layer metric lists its cells, and each of them reports the
    end-to-end metric it moves; every cell reports set-up, another
    end-to-end metric and a per-layer one."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["workloads"] and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [n for n, m in e2e.items() if w in m.get("workloads", [w])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in manifest["per_layer"])


def test_files_behind_every_name(manifest):
    """Each cell, its configuration, mix and driver, and each per-layer
    metric's file and reader exist and agree with the manifest."""
    for w in manifest["workloads"]:
        spec = harness.load_spec(w["name"])
        assert spec.cell["config"] == w["config"] and spec.cell["traffic"] == w["traffic"]
        assert spec.cell["chips"] == w["chips"]
        importlib.import_module(f"perfbench.drivers.{spec.mix['kind']}")
        harness.reference(spec).layout(spec.model)
    by_name = {c["name"]: c for c in manifest["configs"]}
    for name, c in by_name.items():
        assert json.loads((ROOT / c["file"]).read_text())["name"] == name
    for m in manifest["per_layer"]:
        meta = harness.load_metric(m["name"])
        for k in ("name", "unit", "layer", "moves", "workloads", "source", "better"):
            assert meta[k] == m[k], (m["name"], k)
        assert hasattr(importlib.import_module(f"perfbench.readers.{meta['reader']}"), "read")


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, mix, cell and metric added as new files are found,
    with no file that exists edited."""
    root = tmp_path / "perfbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "qwen2-1.5b.json").read_text())
    cfg["name"] = "qwen2-1.5b-x"
    (root / "configs" / "qwen2-1.5b-x.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "mixes" / "serve-doc16k.json").read_text())
    mix["prompt_len"] = 4096
    (root / "mixes" / "serve-doc4k.json").write_text(json.dumps(mix))
    (root / "cells" / "qwen2-1.5b-x.serve-doc4k.json").write_text(json.dumps(
        {"config": "qwen2-1.5b-x", "traffic": "serve-doc4k", "chips": 1,
         "check": {"requests": 2, "limits": {"params_mismatch": 0, "token_gap": 1,
                                             "logit_err": 1}}}))
    (root / "metrics" / "x_share.serve.json").write_text(json.dumps(
        {"name": "x_share.serve", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "ttft_p95_s", "workloads": ["qwen2-1.5b-x.serve-doc4k"],
         "reader": "idle"}))
    spec = harness.load_spec("qwen2-1.5b-x.serve-doc4k", root)
    assert spec.mix["prompt_len"] == 4096 and spec.config["name"] == "qwen2-1.5b-x"
    assert harness.load_metric("x_share.serve", root)["reader"] == "idle"
    manifest = {"per_layer": [{"name": "x_share.serve", "workloads": [spec.name]}],
                "end_to_end": [{"name": "setup_s"}]}
    assert [m["name"] for m in harness.cell_metrics(manifest, spec.name, True)] == ["x_share.serve"]
    assert all(p.read_bytes() == b for p, b in before.items())
