"""Deterministic, shardable, resumable synthetic LM data pipeline.

Batches are a pure function of (seed, step, shard) — no filesystem state is
required to be local, so any worker can take over any shard at any step
(the statelessness the FaaS model assumes). The *cursor* (next step per
shard) lives in FaaSFS, so pipeline progress commits atomically with the
training step that consumed the batch: a retried step re-reads the same
cursor and regenerates the identical batch (exactly-once consumption).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.posix import FaaSFS, O_CREAT


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    seed: int = 0


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    key = f"{cfg.seed}:{step}:{shard}".encode()
    digest = hashlib.sha256(key).digest()
    return np.random.default_rng(np.frombuffer(digest[:8], dtype=np.uint64)[0])


def synth_batch(cfg: DataConfig, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens with enough structure to be learnable."""
    rng = _rng_for(cfg, step, shard)
    b = cfg.global_batch // cfg.num_shards
    s = cfg.seq_len
    # piecewise-repeating structure: short motifs the model can learn
    motif_len = 8
    n_motifs = 64
    motifs = (
        _rng_for(cfg, -1, 0).integers(0, cfg.vocab_size, (n_motifs, motif_len))
    )
    idx = rng.integers(0, n_motifs, (b, s // motif_len + 1))
    tokens = motifs[idx].reshape(b, -1)[:, :s].astype(np.int32)
    noise = rng.random((b, s)) < 0.05
    tokens = np.where(noise, rng.integers(0, cfg.vocab_size, (b, s)), tokens)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.ones((b, s), np.float32)
    mask[:, -1] = 0.0
    return {
        "tokens": tokens,
        "labels": labels.astype(np.int32),
        "mask": mask,
    }


class PipelineCursor:
    """Per-shard next-step cursor stored in FaaSFS (atomic with the step)."""

    def __init__(self, path: str = "/mnt/tsfs/data/cursor"):
        self.path = path

    def next_step(self, fs: FaaSFS, shard: int) -> int:
        p = f"{self.path}.{shard}"
        fd = fs.open(p, O_CREAT)
        raw = fs.pread(fd, 8, 0)
        step = int.from_bytes(raw, "little") if raw else 0
        fs.pwrite(fd, (step + 1).to_bytes(8, "little"), 0)
        fs.close(fd)
        return step

    def peek(self, fs: FaaSFS, shard: int) -> int:
        p = f"{self.path}.{shard}"
        if not fs.exists(p):
            return 0
        fd = fs.open(p)
        raw = fs.pread(fd, 8, 0)
        fs.close(fd)
        return int.from_bytes(raw, "little") if raw else 0
