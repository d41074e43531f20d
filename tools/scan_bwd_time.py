#!/usr/bin/env python3
"""Time the port's selective-scan backward against other versions of it.

  python3 tools/scan_bwd_time.py [--source NAME=ROOT ...] [--sass]

Builds ``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu`` as it is
("tree") and, for each ``--source``, the backward of another checkout's
ROOT: an unpacked parent commit, or a copy of the tree under the ignored
``build/`` with one edit to try (another block shape, or a probe that
drops a piece of work to see what it costs). All build at once with the
flags of
``repro_torch.kernels._build`` into the ignored ``build/dev/scan_bwd``.
For each build it prints the registers and spill stores ptxas reports for
the N 16 entries and, where the source exports it, the launch geometry
at hymba-1.5b's training shape (blocks, threads, cluster, resident blocks
an SM, clusters resident at once, waves). Each build is then held against
the plain backward (``selective_scan_bwd_ref``, chip_smoke.py's tolerances)
at two small shapes and at the training shape (B 4, S 512, Di 3200, N 16,
x and dy bf16, random inputs from seed 9), two calls bit-identical, and
timed there: the device time per call (20 calls captured in a CUDA graph,
replayed three times) and the eager time, in turns (builds in order,
then in reverse order) on one card. Prints the card's name and power limit
first. A build that disagrees with the plain version is still timed (a
probe may drop work on purpose) and makes the exit code 1. ``--sass``
also writes each build's SASS of the bf16 N 16 staged kernel, and its
instruction counts by opcode, to ``build/dev/scan_bwd/NAME.sass``. Needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "ssm_scan" / "csrc" / "ssm_scan_bwd.cu"
OUT = ROOT / "build" / "dev" / "scan_bwd"
TRAIN = (4, 512, 3200, 16)
SMALL = ((2, 130, 96, 16), (1, 65, 3216, 8))
TOL = {"float32": 1e-4, "dx_bf16": 2e-2}      # chip_smoke.py's SCAN_BWD_TOL


def build(builds, nvcc_flags, nvcc):
    """Compile every (name, source) at once; {name: (library, log)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src in builds:
        lib, log = OUT / f"{name}.so", OUT / f"{name}.log"
        cmd = [nvcc, *nvcc_flags, "-o", str(lib), str(src)]
        procs.append((name, lib, log, subprocess.Popen(cmd, stdout=open(log, "w"),
                                                       stderr=subprocess.STDOUT)))
    out = {}
    for name, lib, log, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"scan_bwd_time: {name} failed to build:\n{log.read_text()}")
        out[name] = (lib, log.read_text())
    return out


def ptxas_n16(log: str):
    """(type, registers, spill-store bytes) of each N 16 backward entry."""
    out, entry, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            # mangled: ssm_scan_bwd_kernel<float or __nv_bfloat16, 16, VEC>
            for tag, key in (("f32", "IfLi16E"), ("bf16", "13__nv_bfloat16Li16E")):
                if "ssm_scan_bwd_kernel" in entry and key in entry:
                    out.append((tag, int(m.group(1)), spill))
            entry, spill = None, 0
    return out


def sass(lib_path) -> str:
    """Write the SASS of the bf16 N 16 staged backward kernel next to the
    library; return its instruction count and the commonest opcodes."""
    out = subprocess.run(["cuobjdump", "-sass", str(lib_path)], capture_output=True,
                         text=True).stdout
    body, keep = [], False
    for line in out.splitlines():
        if "Function :" in line:
            keep = "ssm_scan_bwd_kernel" in line and "13__nv_bfloat16Li16ELb1E" in line
        if keep:
            body.append(line)
    Path(lib_path).with_suffix(".sass").write_text("\n".join(body))
    ops = {}
    for line in body:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m:
            op = m.group(1).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:24]
    return f"SASS {sum(ops.values())} instructions: " + " ".join(f"{k} {v}" for k, v in top)


def load(path):
    lib = ctypes.CDLL(str(path))
    lib.repro_ssm_scan_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    lib.repro_ssm_scan_bwd.restype = ctypes.c_int
    lib.repro_ssm_scan_bwd_work_floats.argtypes = [ctypes.c_int] * 4
    lib.repro_ssm_scan_bwd_work_floats.restype = ctypes.c_longlong
    return lib


def geometry(lib, B, S, Di, N):
    if not hasattr(lib, "repro_ssm_scan_bwd_geometry"):
        return None
    out = (ctypes.c_int * 9)()
    rc = lib.repro_ssm_scan_bwd_geometry(B, S, Di, N, 1, out)
    return None if rc else list(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import selective_scan_bwd_ref

    if not torch.cuda.is_available():
        print("scan_bwd_time: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    builds = [("tree", SRC)]
    for spec in args.source:
        name, _, root = spec.partition("=")
        builds.append((name, Path(root) / SRC.relative_to(ROOT)))
    libs = {}
    for name, (path, log) in build(builds, _build.NVCC_FLAGS, _build._nvcc()).items():
        libs[name] = load(path)
        geo = geometry(libs[name], *TRAIN)
        geo_s = "no geometry export" if geo is None else (
            f"{geo[0]} blocks of {geo[1]} threads, clusters of {geo[2]}, {geo[3]} blocks "
            f"({geo[3] * geo[1] // 32} warps) an SM, {geo[4]} clusters at once on {geo[5]} SMs: "
            f"{geo[0] / geo[2] / max(geo[4], 1):.3f} waves; {geo[6]} registers, "
            f"{geo[7]} B local, {geo[8]} B shared a block")
        print(f"[{name}] N16 registers / spill stores {ptxas_n16(log)}; {geo_s}", flush=True)
        if args.sass:
            print(f"[{name}] {sass(path)}", flush=True)

    def inputs(B, S, Di, N, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(B, S, Di, generator=g, device="cuda").bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, Di, generator=g, device="cuda") * 0.5 - 1.0)
        b = torch.randn(B, S, N, generator=g, device="cuda")
        c = torch.randn(B, S, N, generator=g, device="cuda")
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device="cuda"))
        a = -torch.exp(a_log.repeat(Di, 1).bfloat16().float())
        d = torch.randn(Di, generator=g, device="cuda")
        dy = torch.randn(B, S, Di, generator=g, device="cuda").bfloat16()
        _, _, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, chunk_states=True)
        return x, dt, b, c, a, d, dy, hc

    real = scan_ops._bwd_lib

    def run(name, args_):
        scan_ops._bwd_lib = lambda: libs[name]
        try:
            x, dt, b, c, a, d, dy, hc = args_
            return scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc)
        finally:
            scan_ops._bwd_lib = real

    cases = {shape: inputs(*shape, seed=9) for shape in SMALL + (TRAIN,)}
    wrong = set()
    for shape, args_ in cases.items():
        want = selective_scan_bwd_ref(*args_[:7], chunk_states=args_[7])
        for name in libs:
            got, again = run(name, args_), run(name, args_)
            same = all(torch.equal(u.reshape(-1).view(torch.uint8),
                                   v.reshape(-1).view(torch.uint8)) for u, v in zip(got, again))
            errs = [float((u.float() - w.float()).abs().max() / w.float().abs().max())
                    for u, w in zip(got[:6], want[:6])]
            ok = same and errs[0] <= TOL["dx_bf16"] and max(errs[1:]) <= TOL["float32"]
            print(f"[{name}] B{shape[0]} S{shape[1]} Di{shape[2]} N{shape[3]}: "
                  f"{'ok' if ok else 'WRONG'}; bit-identical {same}; rel err dx ddt db dc da dd "
                  + " ".join(f"{e:.1e}" for e in errs), flush=True)
            if not ok:
                wrong.add(name)
    train = cases[TRAIN]
    times = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            dev = time_ms(lambda: run(name, train), graph=True, iters=20)
            eager = time_ms(lambda: run(name, train), iters=20)
            times[name].append((dev, eager))
    for name, ts in times.items():
        print(f"[{name}] hymba-1.5b training shape: device ms "
              + " / ".join(f"{d:.4f}" for d, _ in ts) + "; eager ms "
              + " / ".join(f"{e:.4f}" for _, e in ts), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
