"""Roofline report: reads the dry-run records, writes markdown.

The port of ``repro.launch.roofline``, with the H100 constants of
``launch.mesh`` (NVIDIA's datasheet figures, not a measurement). Per
device:

  compute    = FLOPs / 989 TFLOP/s (bf16 dense)
  memory     = HBM bytes / 3.35 TB/s
  collective = collective wire bytes / the slowest link an axis of the
               mesh crosses (``mesh.collective_bandwidth``: 50 GB/s of
               InfiniBand NDR for the production meshes, whose 16-wide
               ``model`` axis spans two 8-GPU NVLink nodes)

The FLOPs and bytes are ``launch.cost_analysis``'s: the kernels' FLOPs by
formula, the eager port's unfused bytes. ``model_flops`` is the
reference's: 6 N D for a train cell, 2 N_active D for inference, over the
cell's tokens (``TOKENS``). ``HBM_PER_CHIP`` is the H100's 80 GB.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh pod] [--tag X]
           [--vs-mesh M] [--vs-tag T]

With ``--vs-mesh`` or ``--vs-tag`` it renders each cell beside the same
cell of another mesh or tag (``compare``): a hill-climb variant beside its
baseline, a multipod cell beside its pod one.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, MULTIPOD_AXES, MULTIPOD_SHAPE,
                                     PEAK_FLOPS_BF16, POD_AXES, POD_SHAPE,
                                     collective_bandwidth)

DRYRUN_DIR = str(OUT_DIR)

TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
          "decode_32k": 128, "long_500k": 1}
HBM_PER_CHIP = HBM_BYTES


def model_flops(rec: dict) -> float:
    n = rec.get("model_params_active") or rec.get("model_params", 0)
    toks = TOKENS.get(rec["shape"], 0)
    mult = 6.0 if rec["shape"] == "train_4k" else 2.0
    return mult * n * toks


def load(mesh: Optional[str] = None, tag: str = "", root: str = DRYRUN_DIR) -> List[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(root, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh and r.get("mesh") != mesh:
            continue
        if (r.get("tag") or "") != tag:
            continue
        recs.append(r)
    return recs


def _link_rate(rec: dict) -> float:
    shape = rec.get("mesh_shape") or (MULTIPOD_SHAPE if rec["mesh"] == "multipod" else POD_SHAPE)
    axes = MULTIPOD_AXES if len(shape) == 3 else POD_AXES
    return collective_bandwidth(dict(zip(axes, shape)))


def analyze(rec: dict) -> Optional[dict]:
    if not rec.get("ok"):
        return None
    a = rec["analysis"]
    ct = a["flops_per_device"] / PEAK_FLOPS_BF16
    mt = a["bytes_per_device"] / HBM_BW
    lt = a["collective_bytes_per_device"] / _link_rate(rec)
    dom = max((ct, "compute"), (mt, "memory"), (lt, "collective"))[1]
    mf = model_flops(rec) / rec["devices"]
    bound = max(ct, mt, lt)
    return {
        "compute_s": ct, "memory_s": mt, "collective_s": lt,
        "dominant": dom,
        "step_s": bound,
        "model_flops_per_dev": mf,
        "useful_ratio": mf / max(a["flops_per_device"], 1),
        # fraction of peak FLOP/s reached if the dominant term sets the step
        # time (the roofline score)
        "roofline_frac": (mf / PEAK_FLOPS_BF16) / max(bound, 1e-12),
        "peak_gib": rec["memory"]["peak_bytes_est"] / 2**30,
        "fits_hbm": rec["memory"]["peak_bytes_est"] <= HBM_PER_CHIP,
    }


def next_move(rec: dict, a: dict) -> str:
    dom = a["dominant"]
    if dom == "memory":
        if rec["shape"] in ("train_4k", "prefill_32k"):
            return ("fuse the eager elementwise chains (norms, RoPE, SwiGLU, AdamW) into "
                    "kernels; the flash and scan kernels already keep S^2 and the state on chip")
        return "shrink KV traffic: int8 cache, larger decode batch per fetch"
    if dom == "collective":
        return ("overlap/shrink collectives: moe_ffn_a2a for MoE, bf16 grads, keep model "
                "collectives inside an NVLink node (model <= 8)")
    return "already compute-bound: raise tensor-core use in the flash and scan kernels"


def markdown(mesh: str = "pod", tag: str = "", root: str = DRYRUN_DIR) -> str:
    rows = [
        "| arch | shape | comp s | mem s | coll s | dominant | useful | roofline | peak GiB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load(mesh, tag, root):
        if not rec.get("applicable", True):
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | SKIP "
                f"({rec.get('skip_reason', '')[:40]}…) | | | | |"
            )
            continue
        a = analyze(rec)
        if a is None:
            rows.append(f"| {rec['arch']} | {rec['shape']} | FAIL | | | | | | | |")
            continue
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {a['compute_s']:.3f} | "
            f"{a['memory_s']:.3f} | {a['collective_s']:.3f} | {a['dominant']} | "
            f"{a['useful_ratio']:.2f} | {a['roofline_frac']*100:.1f}% | "
            f"{a['peak_gib']:.1f} | {'Y' if a['fits_hbm'] else 'N'} |"
        )
    return "\n".join(rows)


def compare(mesh: str, tag: str, base_mesh: str, base_tag: str,
            root: str = DRYRUN_DIR) -> str:
    """Each traced cell of (``mesh``, ``tag``) beside the same arch and
    shape of (``base_mesh``, ``base_tag``): the roofline seconds, the peak
    and the argument bytes (params, optimizer state, cache and batch on one
    device) of both, base first, and their ratios."""
    base = {(r["arch"], r["shape"]): r for r in load(base_mesh, base_tag, root)}
    rows = [f"| arch | shape | comp s | mem s | coll s | dominant | peak GiB | args GiB | "
            f"vs {base_mesh}{'__' + base_tag if base_tag else ''}: coll x | peak x | args x |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for rec in load(mesh, tag, root):
        a, b = analyze(rec), base.get((rec["arch"], rec["shape"]))
        ab = analyze(b) if b else None
        if a is None or ab is None:
            continue
        args, bargs = (r["memory"]["argument_bytes"] / 2**30 for r in (rec, b))
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {ab['compute_s']:.3f} -> {a['compute_s']:.3f} | "
            f"{ab['memory_s']:.3f} -> {a['memory_s']:.3f} | "
            f"{ab['collective_s']:.3f} -> {a['collective_s']:.3f} | {a['dominant']} | "
            f"{ab['peak_gib']:.1f} -> {a['peak_gib']:.1f} | {bargs:.2f} -> {args:.2f} | "
            f"{a['collective_s'] / max(ab['collective_s'], 1e-12):.3f} | "
            f"{a['peak_gib'] / max(ab['peak_gib'], 1e-12):.3f} | "
            f"{args / max(bargs, 1e-12):.4f} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--tag", default="")
    ap.add_argument("--root", default=DRYRUN_DIR, help="the dry run's records")
    ap.add_argument("--vs-mesh", default=None,
                    help="compare each cell with this mesh's record of it")
    ap.add_argument("--vs-tag", default=None, help="... and this tag's (default: none)")
    args = ap.parse_args()
    if args.vs_mesh is not None or args.vs_tag is not None:
        print(compare(args.mesh, args.tag, args.vs_mesh or args.mesh, args.vs_tag or "",
                      args.root))
        return
    print(markdown(args.mesh, args.tag, args.root))
    print()
    for rec in load(args.mesh, args.tag, args.root):
        a = analyze(rec)
        if a:
            print(f"{rec['arch']:22s} {rec['shape']:12s} -> {next_move(rec, a)}")


if __name__ == "__main__":
    main()
