"""Guards for the port's copies of the framework-free modules and for its
import boundary.

* Every copied module is the original text with ``repro.`` imports
  rewritten to ``repro_torch.``; ``core/client.py`` differs in one more
  hunk, which replaces the per-byte coverage loop of ``Transaction.commit``
  with an interval union.
* No module of ``repro_torch`` and not ``chip_smoke.py`` imports ``jax`` or
  ``repro``.
* The interval union covers exactly what the per-byte loop covers: random
  blind writes into one block leave the same cache state in both packages.
"""
import ast
import difflib
import re
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.backend import BackendService as RefBackend
from repro.core.client import LocalServer as RefLocal
from repro.core.posix import O_CREAT as REF_O_CREAT
from repro.core.runtime import FunctionRuntime as RefRuntime
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import O_CREAT
from repro_torch.core.runtime import FunctionRuntime

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
COPIED = (
    [f"configs/{p.name}" for p in sorted((REF / "configs").glob("*.py"))]
    + [f"core/{m}.py" for m in ("__init__", "types", "api", "blockstore", "obs", "backend",
                                 "client", "posix", "runtime", "arena", "tensorstate")]
    + ["serving/engine.py"]
)
_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)


def _rewritten(path: Path) -> str:
    return _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)} repro_torch.", path.read_text())


@pytest.mark.parametrize("module", COPIED)
def test_copy_is_the_original_with_imports_rewritten(module):
    want = _rewritten(REF / module).splitlines()
    got = (PORT / module).read_text().splitlines()
    hunks = [op for op in difflib.SequenceMatcher(a=want, b=got, autojunk=False).get_opcodes()
             if op[0] != "equal"]
    if module != "core/client.py":
        assert hunks == [], module
        return
    # one contiguous region (difflib may split it around an unchanged line)
    i1, i2, j1, j2 = hunks[0][1], hunks[-1][2], hunks[0][3], hunks[-1][4]
    assert i2 - i1 <= 10 and j2 - j1 <= 15, hunks
    removed = "\n".join(want[i1:i2])
    added = "\n".join(got[j1:j2])
    assert "for i in range(off, min(off + len(data), self.block_size)):" in removed
    assert "bytearray" not in added and "sorted(" in added


def _py_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        for r in roots:
            assert r not in ("jax", "jaxlib", "repro"), (path, node.lineno, r)


def _per_byte_covered(patches, block_size):
    """The reference's loop, verbatim in effect."""
    covered = bytearray(block_size)
    n = 0
    for off, data in patches:
        for i in range(off, min(off + len(data), block_size)):
            if not covered[i]:
                covered[i] = 1
                n += 1
    return n


def _blind_writes_cached(backend_cls, local_cls, runtime_cls, o_creat, writes, bs):
    """Commit ``writes`` (offset, length) into a new file in one transaction
    and report which of its blocks the committing cache kept."""
    local = local_cls(backend_cls(block_size=bs))
    seen = {}

    def fn(fs):
        fd = fs.open("/mnt/tsfs/f", o_creat)
        for i, (off, n) in enumerate(writes):
            fs.pwrite(fd, bytes([i % 251 + 1]) * n, off)
        seen["fid"] = fs._fd(fd).fid
        fs.close(fd)

    runtime_cls(local).invoke(fn)
    return sorted(bi for (fid, bi) in local.cache if fid == seen["fid"])


BS = 64


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, BS - 1), st.integers(1, BS)), min_size=1,
                max_size=8))
def test_interval_union_equals_per_byte_coverage(writes):
    writes = [(off, min(n, BS - off)) for off, n in writes]   # inside block 0
    port = _blind_writes_cached(BackendService, LocalServer, FunctionRuntime, O_CREAT,
                                writes, BS)
    ref = _blind_writes_cached(RefBackend, RefLocal, RefRuntime, REF_O_CREAT, writes, BS)
    full = _per_byte_covered([(off, b"x" * n) for off, n in writes], BS) == BS
    assert port == ref == ([0] if full else [])
