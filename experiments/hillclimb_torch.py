"""Hill-climb driver on the PyTorch port: trace tagged variants of the
chosen cells.

The port's twin of ``experiments/hillclimb.py``, with the same variants.
Each variant is a (cell, overrides, tag) tuple; ``launch.dryrun.run_cell``
traces the cell's step with the plan's ``overrides`` on fake tensors over a
fake process group of the mesh's size, on the CPU. The records land in
``experiments/dryrun_torch/<cell>__<tag>.json`` next to the baselines, and
``python -m repro_torch.launch.roofline --tag <tag>`` renders them. The
seconds printed are ``roofline.analyze``'s: the H100 datasheet constants of
``launch.mesh``, a model, not a measurement.

Usage: PYTHONPATH=src python experiments/hillclimb_torch.py [variant ...]
"""
import sys
import time

import torch

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.roofline import analyze
from repro_torch.models.runtime import train_rules_v2

VARIANTS = {
    # H2 (deepseek): output-dim FSDP sharding kills projection all-reduces
    "deepseek_fsdp2": dict(
        arch="deepseek-coder-33b", shape="train_4k", mesh="pod",
        overrides={"rules": train_rules_v2()}, tag="fsdp2",
    ),
    # H2b: same, multipod (verifies the pod axis still shards)
    "deepseek_fsdp2_mp": dict(
        arch="deepseek-coder-33b", shape="train_4k", mesh="multipod",
        overrides={"rules": train_rules_v2()}, tag="fsdp2",
    ),
    # H3 (deepseek): fsdp2 + smaller q chunks (bound score transients)
    "deepseek_fsdp2_qc256": dict(
        arch="deepseek-coder-33b", shape="train_4k", mesh="pod",
        overrides={"rules": train_rules_v2(), "q_chunk": 256}, tag="fsdp2qc256",
    ),
    # H5 (qwen3 moe): output-dim FSDP for the dense parts of the MoE net
    "qwen3_fsdp2": dict(
        arch="qwen3-moe-30b-a3b", shape="train_4k", mesh="pod",
        overrides={"rules": train_rules_v2()}, tag="fsdp2",
    ),
    # H4 (qwen3 moe): expert-parallel all-to-all (moe_ffn_a2a)
    "qwen3_a2a": dict(
        arch="qwen3-moe-30b-a3b", shape="train_4k", mesh="pod",
        overrides={"moe_impl": "a2a"}, tag="a2a",
    ),
    "qwen3_a2a_mp": dict(
        arch="qwen3-moe-30b-a3b", shape="train_4k", mesh="multipod",
        overrides={"moe_impl": "a2a"}, tag="a2a",
    ),
    # H7 (deepseek): save dot outputs in remat (kill recompute traffic)
    "deepseek_rematdots": dict(
        arch="deepseek-coder-33b", shape="train_4k", mesh="pod",
        overrides={"remat_policy": "dots"}, tag="rematdots",
    ),
    # H9: int8 KV cache for the over-HBM decode cells
    "musicgen_int8kv": dict(
        arch="musicgen-large", shape="decode_32k", mesh="pod",
        overrides={"kv_dtype": "int8"}, tag="int8kv",
    ),
    "internvl2_int8kv": dict(
        arch="internvl2-76b", shape="decode_32k", mesh="pod",
        overrides={"kv_dtype": "int8"}, tag="int8kv",
    ),
    "mixtral_long_int8kv": dict(
        arch="mixtral-8x7b", shape="long_500k", mesh="pod",
        overrides={"kv_dtype": "int8"}, tag="int8kv",
    ),
    # H6 (falcon): fsdp2 on the ssm projections
    "falcon_fsdp2": dict(
        arch="falcon-mamba-7b", shape="train_4k", mesh="pod",
        overrides={"rules": train_rules_v2()}, tag="fsdp2",
    ),
}


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        spec = VARIANTS[name]
        ov = dict(spec.get("overrides") or {})
        if ov.get("kv_dtype") == "int8":
            ov["kv_dtype"] = torch.int8
        t0 = time.time()
        rec = run_cell(spec["arch"], spec["shape"], spec["mesh"], overrides=ov,
                       tag=spec["tag"], force=True)
        a = analyze(rec)
        if a is not None:
            print(f"[OK] {name}: peak={a['peak_gib']:.1f}GiB comp={a['compute_s']:.2f}s "
                  f"mem={a['memory_s']:.2f}s coll={a['collective_s']:.2f}s "
                  f"({a['dominant']}) traced in {time.time() - t0:.1f}s")
        elif not rec.get("applicable", True):
            print(f"[SKIP] {name}: {rec.get('skip_reason')}")
        else:
            print(f"[FAIL] {name}: {rec.get('error')}")


if __name__ == "__main__":
    main()
