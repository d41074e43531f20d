"""The port's benchmark: run one cell once on the CUDA card and print its
result as the last line of standard output.

  python3 perfbench/run.py --workload qwen2-1.5b.train-4k --seed 7 \
      --seconds 45 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the same set-up and window, then a few units under
``torch.profiler``). Exits non-zero, printing no result, without a CUDA
card or with fewer cards than the cell takes, and when JAX or the JAX
package was loaded. The compared numbers and their limits are the last
lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# kernel and compile caches at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from perfbench import harness

    spec = harness.load_spec(args.workload)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
        print(f"perfbench: {args.workload} takes {spec.cell['chips']} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), device="cuda",
                              t_start=T_START, manifest=manifest)
    loaded = harness.jax_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    log = result.pop("log")
    print("perfbench: " + ", ".join(f"{k} {v!r}" for k, v in log.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
