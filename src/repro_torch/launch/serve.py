"""Serving launcher: greedy decode from FaaSFS parameter snapshots.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 512 --tokens 32

The slice, on one device (``--device``, default ``cuda``):

  1. publish v0 of the float32 parameters into an in-process
     ``BackendService`` (256 KiB blocks, eager cache updates);
  2. ``SnapshotServer.refresh()`` pins it; a request prefills the prompts
     (flash-attention kernel on CUDA), writes the prefill K/V into the
     decode cache at ``[:, :, :S]`` and runs ``--tokens`` greedy decode
     steps;
  3. publish v1, a sparse update, IN PLACE: the block-delta kernel flags
     the dirty 256 KiB blocks of each leaf and ``TensorStore.save`` writes
     only those blocks under the same name;
  4. ``refresh()`` and serve again.

``--reduced`` takes the tiny same-family config of the CPU tests.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.bridge import DeviceSnapshot, flat_tensors, params_to_numpy
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced_config
from repro_torch.core.backend import BackendService
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.runtime import FunctionRuntime
from repro_torch.core.tensorstate import TensorStore
from repro_torch.core.types import CachePolicy
from repro_torch.models import model as M
from repro_torch.serving.engine import SnapshotServer
from repro_torch.state.checkpoint import dirty_block_indices

BLOCK_BYTES = 1 << 18
ROOT = "/mnt/tsfs/train"
NAME = "state"


def _structure(tree):
    """``tree``'s dict structure with empty leaves: a SnapshotServer
    template that holds no parameter memory."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def generate(
    cfg: ModelConfig,
    params: Dict,
    prompts: torch.Tensor,
    tokens: int,
    *,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompts`` (B, S), then ``tokens`` greedy decode steps.

    Returns (prefill logits (B, V) float32, tokens (B, tokens + 1)): the
    argmax of the prefill logits followed by one token per decode step.
    The decode cache has the compute type.
    """
    B, S = prompts.shape
    logits, pc = M.prefill(cfg, params, prompts, compute_dtype=compute_dtype)
    cache = M.make_decode_cache(cfg, B, S + tokens, compute_dtype, device=prompts.device)
    cache["k"][:, :, :S] = pc["k"]
    cache["v"][:, :, :S] = pc["v"]
    tok = logits.argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(tokens):
        step_logits, cache = M.decode_step(cfg, params, cache, tok, S + i,
                                           compute_dtype=compute_dtype)
        tok = step_logits.argmax(dim=-1, keepdim=True)
        out.append(tok)
    return logits, torch.cat(out, dim=1)


def sparse_update(cfg: ModelConfig, params: Dict, generator: torch.Generator,
                  *, rows: int = 8) -> Dict:
    """v1 of ``params``: ``rows`` random rows of ``embed`` and the first 16
    input rows of the middle layer's ``mlp/wi`` get small random deltas.
    The two touched leaves are new tensors; every other leaf is shared."""
    out = dict(params)
    dev = params["embed"].device
    embed = params["embed"].clone()
    idx = torch.randperm(cfg.vocab_size, generator=generator, device=dev)[:rows]
    embed[idx] += 0.01 * torch.randn(rows, cfg.d_model, generator=generator, device=dev)
    out["embed"] = embed
    layers = dict(params["layers"])
    mlp = dict(layers["mlp"])
    wi = mlp["wi"].clone()
    layer = cfg.num_layers // 2
    wi[layer, :16] += 0.01 * torch.randn(16, cfg.d_ff, generator=generator, device=dev)
    mlp["wi"] = wi
    layers["mlp"] = mlp
    out["layers"] = layers
    return out


@dataclass
class PublishInfo:
    version: int                                # commit timestamp
    stats: Dict[str, int]                       # TensorStore.save stats
    dirty: Optional[Dict[str, List[int]]]       # per-leaf mask (None: full)
    seconds: float


class ServeSlice:
    """Publisher and snapshot server over one in-process FaaSFS backend."""

    def __init__(self, cfg: ModelConfig, *, device: str = "cuda",
                 compute_dtype=torch.bfloat16, tokens: int = 32,
                 block_bytes: int = BLOCK_BYTES):
        self.cfg = cfg
        self.device = device
        self.compute_dtype = compute_dtype
        self.tokens = tokens
        self.block_bytes = block_bytes
        self.backend = BackendService(block_size=block_bytes, policy=CachePolicy.EAGER)
        self.boot = LocalServer(self.backend)
        self.snapshot = DeviceSnapshot(device, block_bytes)
        self.published: Optional[Dict] = None
        self.server: Optional[SnapshotServer] = None
        self._cast: Tuple[Any, Any] = (None, None)

    def publish(self, params: Dict) -> PublishInfo:
        """Publish the device tree ``params`` as ``{"params": ...}``. The
        first publish writes every block; later ones write, in place, the
        blocks the block-delta kernel flags against the last publish."""
        t0 = time.perf_counter()
        tree = {"params": params}
        dirty = None
        if self.published is not None:
            old = flat_tensors({"params": self.published})
            dirty = {}
            for name, new in flat_tensors(tree).items():
                idx = dirty_block_indices(new, old[name], self.block_bytes)
                if idx is not None:
                    dirty[name] = idx
        host = params_to_numpy(tree)
        stats: Dict[str, int] = {}

        def do_publish(fs: FaaSFS) -> None:
            stats.clear()
            stats.update(TensorStore(fs, prefix=ROOT).save(
                NAME, host, block_bytes=self.block_bytes, dirty_blocks=dirty))

        FunctionRuntime(self.boot).invoke(do_publish)
        self.published = params
        if self.server is None:
            self.server = SnapshotServer(LocalServer(self.backend), self._decode_fn,
                                         _structure(tree), root=ROOT, name=NAME)
        return PublishInfo(self.backend.latest_ts, stats, dirty,
                           time.perf_counter() - t0)

    def refresh(self) -> int:
        return self.server.refresh()

    def serve(self, prompts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.server.serve(prompts)

    def device_params(self) -> Dict:
        """The device tree of the pinned snapshot, moved on first use."""
        return self.snapshot.get(self.server.params)["params"]

    def _decode_fn(self, state, prompts: torch.Tensor):
        dev = self.snapshot.get(state)
        if self._cast[0] is not dev:
            self._cast = (dev, M.cast_params(dev["params"], self.compute_dtype))
        return generate(self.cfg, self._cast[1], prompts, self.tokens,
                        compute_dtype=self.compute_dtype)


@dataclass
class ServeRun:
    slice: ServeSlice
    prompts: torch.Tensor
    params_v0: Dict
    params_v1: Dict
    publish_v0: PublishInfo
    publish_v1: PublishInfo
    out_v0: Tuple[torch.Tensor, torch.Tensor]
    out_v1: Tuple[torch.Tensor, torch.Tensor]
    seconds: Dict[str, float] = field(default_factory=dict)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(
    cfg: ModelConfig,
    *,
    device: str = "cuda",
    batch: int = 4,
    prompt_len: int = 512,
    tokens: int = 32,
    seed: int = 0,
    compute_dtype=torch.bfloat16,
    params: Optional[Dict] = None,
) -> ServeRun:
    """Steps 1-4 of the module docstring. ``params`` (a device tree) skips
    the random initialization; prompts and the update come from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = M.init_params(cfg, gen, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device)
    sl = ServeSlice(cfg, device=device, compute_dtype=compute_dtype, tokens=tokens)
    secs: Dict[str, float] = {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(device)
        secs[key] = time.perf_counter() - t0
        return out

    pub0 = sl.publish(params)
    timed("refresh_v0", sl.refresh)
    out0 = timed("serve_v0", sl.serve, prompts)
    params1 = sparse_update(cfg, params, gen)
    pub1 = sl.publish(params1)
    timed("refresh_v1", sl.refresh)
    out1 = timed("serve_v1", sl.serve, prompts)
    secs["publish_v0"], secs["publish_v1"] = pub0.seconds, pub1.seconds
    return ServeRun(sl, prompts, params, params1, pub0, pub1, out0, out1, secs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    r = run(cfg, device=args.device, batch=args.batch, prompt_len=args.prompt_len,
            tokens=args.tokens, seed=args.seed)
    n_dirty = sum(len(v) for v in r.publish_v1.dirty.values())
    print(f"arch={cfg.name} device={args.device} params={cfg.param_count()}")
    print(f"v0: published {r.publish_v0.stats['bytes_written']} B in "
          f"{r.seconds['publish_v0']:.2f}s; refresh {r.seconds['refresh_v0']:.2f}s; "
          f"served {args.batch}x({args.prompt_len}+{args.tokens}) in "
          f"{r.seconds['serve_v0']:.2f}s")
    print(f"v1: {n_dirty} dirty blocks, wrote {r.publish_v1.stats['blocks_written']} "
          f"blocks in place in {r.seconds['publish_v1']:.2f}s; refresh "
          f"{r.seconds['refresh_v1']:.2f}s; served in {r.seconds['serve_v1']:.2f}s")
    for tag, (_, toks) in (("v0", r.out_v0), ("v1", r.out_v1)):
        print(f"  {tag} row 0: {toks[0].tolist()}")


if __name__ == "__main__":
    main()
