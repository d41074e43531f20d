"""BENCHMARK.json and the benchmark's data files: names, units, keys and
cross references, and that a new configuration, mix, cell or metric is
found by its name with no file that exists edited."""
import importlib
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.reference import moe_decoder

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
             "dt_rank": "mamba_dt_rank", "num_experts": "num_experts",
             "num_experts_per_tok": "num_experts_per_tok", "moe_d_ff": "moe_intermediate_size",
             "router_aux_loss_coef": "router_aux_loss_coef"}
# model keys worked out from published ones (``published_value``)
DERIVED = {"sliding_window", "d_inner", "head_dim"}
# architecture, and a routing rule the file states under ``assumed``: not
# keys of config.json
NOT_PUBLISHED = {"family", "qkv_bias", "qk_norm", "capacity_factor"}


def published_value(pub, key):
    if key == "sliding_window":
        return pub["sliding_window"] if pub.get("use_sliding_window", True) else 0
    if key == "d_inner":
        return pub["mamba_expand"] * pub["hidden_size"]
    if key == "head_dim":
        return pub.get("head_dim", pub["hidden_size"] // pub["num_attention_heads"])
    if key == "d_ff" and pub.get("num_experts"):
        # a MoE model's dense FFN width: none where every layer is sparse
        dense = pub.get("mlp_only_layers") or pub.get("decoder_sparse_step", 1) > 1
        return pub["intermediate_size"] if dense else 0
    return pub[PUBLISHED[key]]


def check_published_keys(entries, root=ROOT):
    """Each configuration's model keys against its ``published_keys``:
    every key not reduced is mapped or worked out, and equals its
    published value."""
    for c in entries:
        cfg = json.loads((root / c["file"]).read_text())
        pub = cfg["published_keys"]
        for key, value in cfg["model"].items():
            if key in NOT_PUBLISHED or key in c["reduced"]:
                continue
            assert key in PUBLISHED or key in DERIVED, \
                f"{c['name']}: model key {key!r} is not published, derived or reduced"
            assert key in DERIVED or PUBLISHED[key] in pub, \
                f"{c['name']}: {key!r}'s published key {PUBLISHED[key]!r} is missing"
            assert value == published_value(pub, key), (c["name"], key)


def test_model_keys_are_the_published_ones(manifest):
    """Every size the port is given equals its published key, unless the
    manifest lists it as reduced."""
    check_published_keys(manifest["configs"])


# Qwen3-30B-A3B's config.json as recalled (hf Qwen/Qwen3-30B-A3B), and a
# configuration of it cut to one chip in depth: all 128 experts a layer at
# published widths, 3 of the 48 layers
QWEN3_MOE_PUBLISHED = {
    "num_hidden_layers": 48, "hidden_size": 2048, "num_attention_heads": 32,
    "num_key_value_heads": 4, "head_dim": 128, "intermediate_size": 6144,
    "moe_intermediate_size": 768, "num_experts": 128, "num_experts_per_tok": 8,
    "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
    "vocab_size": 151936, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "use_sliding_window": False, "sliding_window": None,
    "router_aux_loss_coef": 0.001, "attention_bias": False}
QWEN3_MOE_MODEL = {
    "family": "moe", "num_layers": 3, "d_model": 2048, "num_heads": 32, "num_kv_heads": 4,
    "head_dim": 128, "d_ff": 0, "vocab_size": 151936, "num_experts": 128,
    "num_experts_per_tok": 8, "moe_d_ff": 768, "capacity_factor": 16.0,
    "router_aux_loss_coef": 0.001, "qk_norm": True, "qkv_bias": False,
    "tie_embeddings": False, "rope_theta": 1000000.0, "norm_eps": 1e-06, "sliding_window": 0}


def _add_moe_config(tmp_path, **extra):
    """A copy of the benchmark with a Qwen3-MoE configuration added as a
    new file: (its manifest entry, the copy's root, the bytes of every
    file the copy had before)."""
    root = tmp_path / "perfbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "qwen3-moe-30b-a3b.json").write_text(json.dumps(
        {"name": "qwen3-moe-30b-a3b", "reference": "moe_decoder", "compute_dtype": "bfloat16",
         "model": dict(QWEN3_MOE_MODEL, **extra), "published_keys": QWEN3_MOE_PUBLISHED,
         "assumed": ["capacity_factor E / k: no slot dropped, as published"]}))
    entry = {"name": "qwen3-moe-30b-a3b", "file": "perfbench/configs/qwen3-moe-30b-a3b.json",
             "reduced": ["num_layers"]}
    return entry, tmp_path, before


def test_a_moe_configuration_passes_the_key_check(tmp_path):
    """A MoE configuration at its published keys, with only its depth
    cut, passes; no file that exists is edited."""
    entry, root, before = _add_moe_config(tmp_path)
    check_published_keys([entry], root)
    per_layer = {}
    for name, shape, _ in moe_decoder.layout(QWEN3_MOE_MODEL):
        if name.startswith("layers/"):
            group = name.split("/")[1]
            per_layer[group] = per_layer.get(group, 0) + math.prod(shape[1:])
    # 18.9 M attention, 0.26 M router and 604 M expert parameters a layer
    assert per_layer["attn"] == 18874368 + 2 * 128
    assert per_layer["moe"] == 262144 + 603979776
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("extra,named", [({"mystery_width": 7}, "mystery_width"),
                                         ({"experts_held": 16}, "experts_held"),
                                         ({"moe_d_ff": 512}, "moe_d_ff"),
                                         ({"router_aux_loss_coef": 0.01},
                                          "router_aux_loss_coef")])
def test_an_unmapped_or_changed_key_fails_by_name(tmp_path, extra, named):
    """A key in neither map and not reduced, or a mapped key off its
    published value, fails with an assertion that names it."""
    entry, root, before = _add_moe_config(tmp_path, **extra)
    with pytest.raises(AssertionError, match=named):
        check_published_keys([entry], root)
    assert all(p.read_bytes() == b for p, b in before.items())


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
