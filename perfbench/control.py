"""Readings that the correctness limits are set from, on the chip at a
cell's own size.

  python3 perfbench/control.py --workload qwen2-1.5b.train-4k \
      --seeds 11,12,13 --control-seeds 21,22,23 --seconds 5

For each of ``--seeds`` it runs the cell as the benchmark does (set-up, a
window of ``--seconds``, the check) and prints the numbers compared: the
program's readings, whose largest over a dozen seeds or more is a limit's
lower reading. For each of ``--control-seeds`` it prints the control's
readings: the plain reference computed with float8 products (the
precision below the configurations' bf16) in the program's place, and for
a training cell also the reference with two faults the check must catch:
half of each batch left out (the mean over the rest), and the update
taken without the clip by the global gradient norm. The smallest of those
is a limit's upper reading. One JSON object a line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def serve_control(spec, seed: int, device: str) -> Dict[str, float]:
    """The float8 reference serving the cell's first ``check.requests``
    requests: the widest gap of its greedy token below the float32
    reference's best logit, and its largest logit error over the float32
    reference's largest logit."""
    from perfbench import traffic, weights
    from perfbench.harness import reference

    ref = reference(spec)
    c, mix = spec.model, spec.mix
    ref.no_tf32()
    flat = weights.make(ref.layout(c), c, seed, device)
    gaps, errs = [], []
    for i in range(spec.cell["check"]["requests"]):
        prompts = traffic.request(c, mix, seed, i, device)
        want = ref.last_logits(c, flat, prompts, ref.FP32)
        got = ref.last_logits(c, flat, prompts, ref.FP8)
        tok = got.argmax(-1, keepdim=True)
        gaps.append(float((want.max(-1).values - want.gather(-1, tok).squeeze(-1)).max()))
        errs.append(float((got - want).abs().max() / want.abs().max()))
    return {"token_gap": max(gaps), "logit_err": max(errs)}


def train_control(spec, seed: int, device: str) -> Dict[str, Dict[str, float]]:
    """The training check's numbers for the float8 reference and for the
    half-batch and no-clip faults, each against the float32 reference."""
    from perfbench import traffic, weights
    from perfbench.drivers.train import compare
    from perfbench.harness import reference

    ref = reference(spec)
    c, mix, chk = spec.model, spec.mix, spec.cell["check"]
    ref.no_tf32()
    flat = weights.make(ref.layout(c), c, seed, device)
    batches = [traffic.train_batch(c, mix, seed, i, device) for i in range(chk["steps"])]
    opt = mix["optimizer"]
    want = ref.train_steps(c, flat, batches, opt, ref.FP32)
    out = {}
    for name, o, kw in (("fp8", opt, dict(prec=ref.FP8)),
                        ("half_batch", opt, dict(rows=range(mix["batch"] // 2))),
                        ("no_clip", dict(opt, clip_norm=float("inf")), {})):
        got = ref.train_steps(c, flat, batches, o, **kw)
        out[name] = dict(compare(got, want, opt["clip_norm"])[0], gnorm=got["gnorms"][0])
        del got
        gc.collect()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    seeds: List[int] = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        r = harness.run_cell(spec, seed, args.seconds, False, device="cuda", t_start=t,
                             manifest=manifest)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                          "seconds": time.perf_counter() - t, "correct": r["correct"],
                          "readings": r["log"].get("readings") or
                          {k: v["value"] for k, v in r["checks"].items()},
                          "gnorms": r["log"].get("gnorms"),
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                          "metrics": r["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t = time.perf_counter()
        if spec.mix["kind"] == "train":
            got = train_control(spec, seed, "cuda")
        else:
            got = {"fp8": serve_control(spec, seed, "cuda")}
        for side, readings in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "seconds": time.perf_counter() - t, "readings": readings}),
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
