"""The port's examples (``examples/torch_*.py``) run end to end on the CPU,
each in a subprocess with ``--device cpu`` (two threads, ``TIMEOUT_S``),
and print what they promise:

* ``torch_train_100m.py`` at d 128, 2 layers, B 2 x S 32, 4 steps, a
  checkpoint every 2: a fresh start, finite losses, a full checkpoint and
  then a delta one. AdamW moves every parameter and moment each step, so
  the delta writes every block of the state: its bytes are the full
  checkpoint's, not fewer; the test holds it to at most those.
* ``torch_serve_snapshot.py``: 5 refresh rounds of 3 requests each, the
  pinned versions never going back, 15 requests over 5 versions.
* ``torch_elastic_workers.py``: the committed step count equals the
  workers' commits (no lost or doubled step).
* ``torch_quickstart.py`` and ``torch_wordcount_functions.py``: their
  numbered checklist and their word counts.
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, f"examples/{script}", "--device", "cpu", *args],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_train_100m_runs_and_checkpoints():
    out = _run("torch_train_100m.py", "--d-model", "128", "--layers", "2", "--batch", "2",
               "--seq", "32", "--steps", "4", "--ckpt-every", "2")
    assert "fresh start" in out
    losses = [float(x) for x in re.findall(r"^step +\d+ loss=(\S+) gnorm=", out, re.M)]
    assert losses and all(math.isfinite(x) for x in losses), out
    ckpts = re.findall(r"checkpoint @ (\d+): ([\d,]+) bytes \((\d+) blocks, (\w+)\)", out)
    assert [(s, kind) for s, _, _, kind in ckpts] == [("2", "full"), ("4", "delta")], out
    full, delta = (int(b.replace(",", "")) for _, b, _, _ in ckpts)
    assert 0 < delta <= full
    assert re.search(r"^done: 4 steps, \d+ occ aborts", out, re.M), out


def test_serve_snapshot_serves_pinned_versions():
    out = _run("torch_serve_snapshot.py")
    versions = [int(v) for v in re.findall(r"^round \d: pinned version (\d+),", out, re.M)]
    assert len(versions) == 5 and versions == sorted(versions), out
    assert "served 15 requests across 5 snapshot versions while training ran" in out


def test_elastic_workers_lose_no_step():
    out = _run("torch_elastic_workers.py")
    m = re.search(r"^final committed step count: (\d+) \(== (\d+) worker commits", out, re.M)
    assert m and m.group(1) == m.group(2) and int(m.group(1)) > 0, out
    assert "[coord] w2 left" in out


@pytest.mark.parametrize("script,lines", [
    ("torch_quickstart.py", [rf"^{i}\. " for i in range(1, 8)]),
    ("torch_wordcount_functions.py", [r"^ingested 4 docs", r"^top words: a=7"]),
])
def test_framework_free_examples(script, lines):
    out = _run(script)
    for line in lines:
        assert re.search(line, out, re.M), (line, out)
