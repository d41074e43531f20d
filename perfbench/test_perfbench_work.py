"""The benchmark's counts of work against hand counts at small shapes,
and the counts of the benchmark's cells pinned."""
import json
from pathlib import Path

import pytest

from perfbench import work
from perfbench.readers import roofline
from perfbench.tiny import MODELS


def pairs_by_loop(S, window):
    return sum(1 for i in range(S) for j in range(S)
               if j <= i and (window <= 0 or j > i - window))


@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (16, 0), (16, 4), (16, 16), (16, 40),
                                      (33, 5)])
def test_attended_pairs(S, window):
    assert work.attended_pairs(S, window) == pairs_by_loop(S, window)


def test_attention_flops_by_hand():
    # B 2, S 8, H 4, hd 16, L 2, causal: 36 pairs a (row, head)
    c = dict(MODELS["dense"], sliding_window=0)
    pairs = 2 * 4 * 36
    got = work.attention_flops(c, 2, 8)
    assert got == {"fwd": 2 * 2 * 2 * 16 * pairs, "bwd": 2 * 5 * 2 * 16 * pairs,
                   "model_bwd": 2 * 4 * 2 * 16 * pairs}


def test_matmul_params_by_hand():
    d = MODELS["dense"]  # D 64, q 64, kv 32, F 128, V 256, L 2, tied
    per = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128
    assert work.matmul_params(d) == 2 * per + 64 * 256
    h = MODELS["hybrid"]  # Di 128, R 8, N 8
    per_h = per + 64 * 256 + 128 * (8 + 16) + 8 * 128 + 128 * 64
    assert work.matmul_params(h, head=False) == 2 * per_h


def test_step_and_prefill_flops():
    d = MODELS["dense"]
    att = work.attention_flops(d, 2, 8)
    assert work.train_step_flops(d, 2, 8) == 6 * work.matmul_params(d) * 16 + att["fwd"] \
        + att["model_bwd"]
    assert work.prefill_flops(d, 2, 8) == 2 * work.matmul_params(d, head=False) * 16 \
        + 2 * 64 * 256 * 2 + att["fwd"]


def test_flash_and_scan_bytes_by_hand():
    d = MODELS["dense"]  # B 2, S 8, H 4, KV 2, hd 16, L 2
    q, kv, lse = 2 * 8 * 4 * 16 * 2, 2 * 8 * 2 * 16 * 2, 2 * 4 * 8 * 4
    assert work.flash_work(d, 2, 8, "fwd")["bytes"] == 2 * (2 * q + 2 * kv)
    assert work.flash_work(d, 2, 8, "fwd_lse")["bytes"] == 2 * (2 * q + 2 * kv + lse)
    assert work.flash_work(d, 2, 8, "bwd")["bytes"] == 2 * (4 * q + 4 * kv + lse)
    h = MODELS["hybrid"]  # B 1, S 4, Di 128, N 8, L 2
    bsd, bsn = 4 * 128, 4 * 8
    ins = bsd * 2 + bsd * 4 + 2 * bsn * 4 + 128 * 8 * 4 + 128 * 4
    fwd = work.scan_work(h, 1, 4, "fwd")
    assert fwd["bytes"] == 2 * (ins + bsd * 2 + 128 * 8 * 4)
    assert fwd["flops"] == 2 * (7 * bsd * 8 + 3 * bsd)
    assert work.scan_work(h, 1, 4, "bwd")["flops"] == 2 * 19 * bsd * 8
    assert work.scan_work(d, 1, 4, "fwd") == {"flops": 0, "bytes": 0}


def test_least_seconds_takes_the_binding_bound():
    peaks = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert work.least_seconds({"flops": 2e12, "bytes": 1e9}, peaks) == 2.0
    assert work.least_seconds({"flops": 1e9, "bytes": 3e9}, peaks) == 3.0


def test_moe_counts_by_hand():
    # B 2, S 8; D 64, q 64, kv 32, E 8, k 2, F 32, L 2, V 256 untied
    c = MODELS["moe"]
    experts = 3 * 64 * 32 * 2                # three products for each of a token's 2 slots
    per = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 64 * 8 + experts
    assert work.matmul_params(c) == 2 * per + 64 * 256
    assert work.matmul_params(c, head=False) == 2 * per
    pairs = 2 * 4 * 36
    assert work.attention_flops(c, 2, 8) == {"fwd": 2 * 2 * 2 * 16 * pairs,
                                             "bwd": 2 * 5 * 2 * 16 * pairs,
                                             "model_bwd": 2 * 4 * 2 * 16 * pairs}
    rows = 2 * 8 * 2                         # every one of the 32 routed slots
    weights = 3 * 8 * 64 * 32 * 2
    fwd = work.expert_work(c, 2, 8, "fwd")
    assert fwd == {"flops": 2 * 3 * 2 * rows * 64 * 32, "bytes": 2 * (2 * rows * 64 * 2 + weights)}
    assert work.expert_work(c, 2, 8, "bwd") == {"flops": 2 * 6 * 2 * rows * 64 * 32,
                                                "bytes": 2 * (3 * rows * 64 * 2 + 2 * weights)}
    # the experts' forward is their share of the model FLOPs' forward
    assert fwd["flops"] == 2 * 2 * experts * 2 * 8
    assert work.flash_work(c, 2, 8, "fwd") == work.flash_work(MODELS["dense"], 2, 8, "fwd")
    assert work.expert_work(MODELS["dense"], 2, 8, "fwd") == {"flops": 0, "bytes": 0}
    with pytest.raises(ValueError):
        work.expert_work(c, 2, 8, "fwd_lse")


def test_roofline_reads_the_expert_family():
    assert roofline.FAMILIES["experts"] is work.expert_work


# every count of the benchmark's cells as the counts stood before the MoE
# terms came in: (configuration, B, S) -> count
PINNED = {
    ("qwen2-1.5b", 2, 16384): {
        "matmul_params": 1543569408, "matmul_params_nohead": 1310195712,
        "attention_flops": {"fwd": 46182306938880, "bwd": 115455767347200,
                            "model_bwd": 92364613877760},
        "train_step_flops": 442025014984704, "prefill_flops": 132048226615296,
        "flash": {"fwd": {"flops": 46182306938880, "bytes": 6576668672},
                  "fwd_lse": {"flops": 46182306938880, "bytes": 6620708864},
                  "bwd": {"flops": 115455767347200, "bytes": 13197377536}},
        "scan": {"fwd": {"flops": 0, "bytes": 0}, "bwd": {"flops": 0, "bytes": 0}}},
    ("qwen2-1.5b", 2, 4096): {
        "matmul_params": 1543569408, "matmul_params_nohead": 1310195712,
        "attention_flops": {"fwd": 2886922665984, "bwd": 7217306664960,
                            "model_bwd": 5773845331968},
        "train_step_flops": 84530291539968, "prefill_flops": 24354102706176,
        "flash": {"fwd": {"flops": 2886922665984, "bytes": 1644167168},
                  "fwd_lse": {"flops": 2886922665984, "bytes": 1655177216},
                  "bwd": {"flops": 7217306664960, "bytes": 3299344384}},
        "scan": {"fwd": {"flops": 0, "bytes": 0}, "bwd": {"flops": 0, "bytes": 0}}},
    ("hymba-1.5b", 2, 4096): {
        "matmul_params": 1608500800, "matmul_params_nohead": 1557299200,
        "attention_flops": {"fwd": 1503448268800, "bwd": 3758620672000,
                            "model_bwd": 3006896537600},
        "train_step_flops": 83571376128000, "prefill_flops": 27018443168000,
        "flash": {"fwd": {"flops": 1503448268800, "bytes": 2013265920},
                  "fwd_lse": {"flops": 1503448268800, "bytes": 2039480320},
                  "bwd": {"flops": 3758620672000, "bytes": 4052746240}},
        "scan": {"fwd": {"flops": 96468992000, "bytes": 6764511232},
                 "bwd": {"flops": 255013683200, "bytes": 11825086464}}},
}


@pytest.mark.parametrize("name,B,S", list(PINNED))
def test_counts_of_the_cells_are_pinned(name, B, S):
    """Every count the benchmark's configurations read at their mixes'
    shapes, exactly (a change here moves a per-layer reading)."""
    c = json.loads((Path(work.__file__).parent / "configs" / f"{name}.json").read_text())["model"]
    got = {"matmul_params": work.matmul_params(c),
           "matmul_params_nohead": work.matmul_params(c, head=False),
           "attention_flops": work.attention_flops(c, B, S),
           "train_step_flops": work.train_step_flops(c, B, S),
           "prefill_flops": work.prefill_flops(c, B, S),
           "flash": {d: work.flash_work(c, B, S, d) for d in ("fwd", "fwd_lse", "bwd")},
           "scan": {d: work.scan_work(c, B, S, d) for d in ("fwd", "bwd")}}
    assert got == PINNED[(name, B, S)]
    assert all(type(v) is int for v in (got["matmul_params"], got["train_step_flops"],
                                        got["prefill_flops"]))
    assert work.expert_work(c, B, S, "fwd") == {"flops": 0, "bytes": 0}
