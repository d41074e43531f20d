"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``<kernel>/csrc/<name>.cu`` exposes a plain C interface and is compiled
on its own by ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the
repository root (listed in ``.gitignore``). The library file name carries a
hash of the source, of the headers (``*.cuh``) in its ``csrc/`` directory, of
the headers it includes from another kernel's ``csrc/`` and of the flags, so
an edited source or header is rebuilt and an unchanged one is reused. ``--use_fast_math`` is never passed: the kernels
rely on IEEE division, ``expf`` and ``rintf`` to match their plain versions.

Nothing here runs at import time; the first wrapper call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = {
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bwd": KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
    "block_delta": KERNELS_DIR / "block_delta" / "csrc" / "block_delta.cu",
    "ssm_scan": KERNELS_DIR / "ssm_scan" / "csrc" / "ssm_scan.cu",
    "ssm_scan_bwd": KERNELS_DIR / "ssm_scan" / "csrc" / "ssm_scan_bwd.cu",
    "grouped_mm": KERNELS_DIR / "grouped_mm" / "csrc" / "grouped_mm.cu",
}
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, to launch, or reported a CUDA error."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _headers(src: Path) -> List[Path]:
    """The ``*.cuh`` beside ``src``, then the headers it includes by a
    quoted path from elsewhere (a header shared across kernels)."""
    local = sorted(src.parent.glob("*.cuh"))
    shared = [(src.parent / inc).resolve() for inc in _INCLUDE.findall(src.read_text())]
    return local + [h for h in shared if h.exists() and h.parent != src.parent.resolve()]


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha1(src.read_bytes())
    for header in _headers(src):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named kernel that has no current library, one ``nvcc``
    per source, all started together. Returns {name: seconds} for the ones
    built; ``ptxas`` resource lines go to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs.append((name, out, tmp, log, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    times: Dict[str, float] = {}
    failed = []
    for name, out, tmp, log, t0, proc in procs:
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append((name, out.with_suffix(".log").read_text()))
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{log}" for n, log in failed))
    return times


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")
