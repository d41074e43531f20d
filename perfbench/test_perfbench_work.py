"""The benchmark's counts of work against hand counts at small shapes."""
import pytest

from perfbench import work
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
