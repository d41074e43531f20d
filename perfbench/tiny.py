"""Cells at a size a CPU test holds: the benchmark's own mixes and
configuration families with every size cut down, for the tests that drive
whole runs on the CPU (``test_perfbench_*.py``)."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench.harness import Spec

HERE = Path(__file__).resolve().parent

MODELS = {
    "dense": dict(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256, qkv_bias=True, tie_embeddings=True,
                  rope_theta=1e6, norm_eps=1e-6, sliding_window=0),
    "hybrid": dict(family="hybrid", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=256, ssm_state=8, ssm_conv=4, d_inner=128,
                   dt_rank=8, sliding_window=32, qkv_bias=False, tie_embeddings=True,
                   rope_theta=1e4, norm_eps=1e-6),
    # capacity_factor E / k: the port's capacity-bounded dispatch keeps
    # every slot, as the dropless reference computes them
    "moe": dict(family="moe", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=0, vocab_size=256, num_experts=8, num_experts_per_tok=2,
                moe_d_ff=32, capacity_factor=4.0, qk_norm=True, qkv_bias=False,
                tie_embeddings=False, rope_theta=1e6, norm_eps=1e-6, sliding_window=0),
}
REFERENCES = {"dense": "decoder", "hybrid": "decoder", "moe": "moe_decoder"}
# set from the CPU readings of sound tiny runs, far below what the faults read
# (the first step's global gradient norm reads 1.1-2.2 here, so the clip acts)
LIMITS = {"train": {"loss_gap": 1e-3, "gnorm_gap": 0.01, "grad_norm_gap": 0.05,
                    "change_gap": 0.1},
          "serve": {"params_mismatch": 0, "token_gap": 0.05, "logit_err": 0.05}}
MANIFEST = {"end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "train_tokens_per_s", "unit": "tokens/s"},
                           {"name": "ttft_p95_s", "unit": "s"},
                           {"name": "prompt_tokens_per_s", "unit": "tokens/s"}],
            "per_layer": []}


def spec(family: str, kind: str, length: int = 64) -> Spec:
    """A tiny cell of ``family`` (a key of ``MODELS``) under the training
    ("train") or serving ("serve") mix, ``length`` tokens a row."""
    mix_name = "train-4k" if kind == "train" else "serve-doc8k"
    with open(HERE / "mixes" / f"{mix_name}.json") as f:
        mix = json.load(f)
    mix.update({"seq_len": length} if kind == "train" else {"prompt_len": length})
    check = {"steps": 3} if kind == "train" else {"requests": 3}
    check["limits"] = dict(LIMITS[kind])
    name = f"tiny-{family}"
    cell = {"config": name, "traffic": mix_name, "chips": 1, "check": check}
    config = {"name": name, "reference": REFERENCES[family], "compute_dtype": "bfloat16",
              "model": copy.deepcopy(MODELS[family])}
    return Spec(f"{name}.{kind}", cell, config, mix)
