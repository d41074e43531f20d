"""Serving launcher: greedy decode from FaaSFS parameter snapshots.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 512 --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b --reduced \
      --kv-dtype int8

The slice, on one device (``--device``, default ``cuda``), for every
family of ``configs/``:

  1. publish v0 of the float32 parameters into an in-process
     ``BackendService`` (256 KiB blocks, eager cache updates);
  2. ``SnapshotServer.refresh()`` pins it; a request prefills the prompts
     (flash-attention and selective-scan kernels on CUDA; for a vlm config
     after ``vision_prefix`` pixel embeddings drawn from the seed, as the
     reference's stub frontend gives them), seeds the decode cache with the
     prefill K/V (quantized for ``--kv-dtype int8``) and the SSM state, and
     runs ``--tokens`` greedy decode steps;
  3. publish v1, a sparse update, IN PLACE: the block-delta kernel flags
     the dirty 256 KiB blocks of each leaf and ``PublishStore.publish``
     writes only those blocks under the same name;
  4. ``refresh()`` and serve again.

``--reduced`` takes the tiny same-family config of the CPU tests.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.bridge import DeviceSnapshot, flat_tensors, params_to_numpy, structure
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced_config
from repro_torch.core import obs
from repro_torch.core.client import LocalServer
from repro_torch.core.posix import FaaSFS
from repro_torch.core.runtime import FunctionRuntime
from repro_torch.core.types import CachePolicy
from repro_torch.models import model as M
from repro_torch.serving.engine import SnapshotServer
from repro_torch.state.checkpoint import dirty_block_indices
from repro_torch.state.publish import PublishBackend, PublishStore
from repro_torch.tracing import span

BLOCK_BYTES = 1 << 18
ROOT = "/mnt/tsfs/train"
NAME = "state"

_PUBLISH_US = {phase: obs.REGISTRY.histogram(
    "faasfs_ml_publish_us", buckets=obs.LATENCY_BUCKETS_US + (30_000_000, 100_000_000),
    labels=("phase",), unit="us", help="ServeSlice.publish by phase").labels(phase)
    for phase in ("detect", "to_host", "save", "commit")}
_PUBLISH_BYTES = obs.REGISTRY.counter(
    "faasfs_ml_publish_bytes_total", unit="bytes",
    help="bytes PublishStore.publish wrote for ServeSlice.publish").labels()
_PUBLISH_BLOCKS = {path: obs.REGISTRY.counter(
    "faasfs_ml_publish_blocks_total", labels=("path",), unit="blocks",
    help="blocks ServeSlice.publish committed: handed over whole, or patched"
).labels(path) for path in ("whole", "patched")}
_REQUESTS = obs.REGISTRY.counter(
    "faasfs_ml_serve_requests_total", help="requests ServeSlice served").labels()
_TOKENS = {kind: obs.REGISTRY.counter(
    "faasfs_ml_serve_tokens_total", labels=("kind",), unit="tokens",
    help="prompt tokens prefilled and tokens generated (the first from the prefill)"
).labels(kind) for kind in ("prompt", "generated")}


KV_DTYPES = {"bf16": None, "int8": torch.int8}


def request_pixel_embeds(cfg: ModelConfig, batch: int, seed: int, device) -> torch.Tensor:
    """The (batch, vision_prefix, d_model) bf16 pixel embeddings of a vlm
    request: standard normal from ``seed`` on a CPU generator (the same
    values on every device), as the reference's stub frontend stands in
    for the vision encoder."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, cfg.vision_prefix, cfg.d_model, generator=gen)
    return x.to(torch.bfloat16).to(device)


def seed_cache(cfg: ModelConfig, prefill_cache: Dict, batch: int, max_seq: int,
               dtype, *, device) -> Dict:
    """A ``make_decode_cache`` cache of ``dtype`` holding the prefill's
    state: K/V at ``[:, :, :S]`` (quantized by ``M.quantize_kv``, the
    function decode uses, for an int8 cache) and the SSM conv and scan
    state."""
    cache = M.make_decode_cache(cfg, batch, max_seq, dtype, device=device)
    for key, state in prefill_cache.items():
        if key in ("k", "v"):
            S = state.shape[2]
            if dtype == torch.int8:
                cache[key][:, :, :S], cache[key + "_scale"][:, :, :S] = M.quantize_kv(state)
            else:
                cache[key][:, :, :S] = state
        else:
            cache[key].copy_(state)
    return cache


def generate(
    cfg: ModelConfig,
    params: Dict,
    prompts: torch.Tensor,
    tokens: int,
    *,
    compute_dtype=torch.bfloat16,
    pixel_embeds: Optional[torch.Tensor] = None,
    kv_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompts`` (B, S), after ``pixel_embeds`` (B, P, D) for a
    vlm config, then ``tokens`` greedy decode steps from position P + S.

    Returns (prefill logits (B, V) float32, tokens (B, tokens + 1)): the
    argmax of the prefill logits followed by one token per decode step.
    The decode cache has ``kv_dtype`` (None: the compute type; or
    ``torch.int8``), seeded with the prefill's state (``seed_cache``).
    """
    B = prompts.shape[0]
    with span("serve.prefill"):
        logits, pc = M.prefill(cfg, params, prompts, pixel_embeds=pixel_embeds,
                               compute_dtype=compute_dtype)
    S = prompts.shape[1] + (pixel_embeds.shape[1] if cfg.vision_prefix
                            and pixel_embeds is not None else 0)
    cache = seed_cache(cfg, pc, B, S + tokens, kv_dtype or compute_dtype,
                       device=prompts.device)
    tok = logits.argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(tokens):
        with span("serve.decode_step"):
            step_logits, cache = M.decode_step(cfg, params, cache, tok, S + i,
                                               compute_dtype=compute_dtype)
            tok = step_logits.argmax(dim=-1, keepdim=True)
        out.append(tok)
    return logits, torch.cat(out, dim=1)


def sparse_update(cfg: ModelConfig, params: Dict, generator: torch.Generator,
                  *, rows: int = 8) -> Dict:
    """v1 of ``params``: ``rows`` random rows of ``embed`` and the first 16
    input rows of the middle layer's ``mlp/wi`` (when the config has an
    MLP), of its first expert's ``moe/wi`` (MoE) and of its ``ssm/in_proj``
    (SSM) get small random deltas. The touched leaves are new tensors;
    every other leaf is shared."""
    out = dict(params)
    dev = params["embed"].device
    embed = params["embed"].clone()
    idx = torch.randperm(cfg.vocab_size, generator=generator, device=dev)[:rows]
    embed[idx] += 0.01 * torch.randn(rows, cfg.d_model, generator=generator, device=dev)
    out["embed"] = embed
    layers = dict(params["layers"])
    layer = cfg.num_layers // 2
    # (group, leaf, index of the matrix whose input rows change)
    touched = ([("mlp", "wi", (layer,))] if cfg.d_ff > 0 else []) + \
        ([("moe", "wi", (layer, 0))] if cfg.is_moe else []) + \
        ([("ssm", "in_proj", (layer,))] if cfg.has_ssm else [])
    for group, name, at in touched:
        sub = dict(layers[group])
        w = sub[name].clone()
        w[at][:16] += 0.01 * torch.randn(16, w.shape[-1], generator=generator, device=dev)
        sub[name] = w
        layers[group] = sub
    out["layers"] = layers
    return out


@dataclass
class PublishInfo:
    version: int                                # commit timestamp
    stats: Dict[str, int]                       # PublishStore.publish stats
    dirty: Optional[Dict[str, List[int]]]       # per-leaf mask (None: full)
    seconds: float
    detect_seconds: float                       # dirty detection, synchronized


class ServeSlice:
    """Publisher and snapshot server over one in-process FaaSFS backend.

    Counts in ``obs.REGISTRY``: each publish's phases in
    ``faasfs_ml_publish_us{phase}`` (``detect``: the dirty blocks of a
    later publish, synchronized; ``to_host``: ``params_to_numpy``;
    ``save``: ``PublishStore.publish`` in the function body's last attempt;
    ``commit``: the rest of ``FunctionRuntime.invoke``, its begin, commit,
    install and any retry), the bytes written in
    ``faasfs_ml_publish_bytes_total`` and the blocks in
    ``faasfs_ml_publish_blocks_total{path}`` (``whole``: built once and
    handed to the commit as they are; ``patched``: a leaf's ragged last
    block, or a leaf under one block); each request and its prompt and
    generated tokens in ``faasfs_ml_serve_requests_total`` and
    ``faasfs_ml_serve_tokens_total{kind}``."""

    def __init__(self, cfg: ModelConfig, *, device: str = "cuda",
                 compute_dtype=torch.bfloat16, tokens: int = 32,
                 block_bytes: int = BLOCK_BYTES, kv_dtype=None, seed: int = 0):
        """``kv_dtype``: the decode cache's type (None: the compute type;
        ``torch.int8``); ``seed``: that of a vlm request's pixel embeds."""
        self.cfg = cfg
        self.device = device
        self.compute_dtype = compute_dtype
        self.tokens = tokens
        self.kv_dtype = kv_dtype
        self.seed = seed
        self.block_bytes = block_bytes
        self.backend = PublishBackend(block_bytes, policy=CachePolicy.EAGER)
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
            _sync(self.device)
        detect = time.perf_counter() - t0
        host = params_to_numpy(tree)
        t_host = time.perf_counter()
        last: Dict[str, Any] = {}   # the function body's last attempt

        def do_publish(fs: FaaSFS) -> None:
            t = time.perf_counter()
            last["stats"], last["whole"] = PublishStore(fs, prefix=ROOT).publish(
                NAME, host, dirty_blocks=dirty)
            last["save"] = time.perf_counter() - t

        FunctionRuntime(self.boot).invoke(do_publish)
        invoked = time.perf_counter() - t_host
        stats = last["stats"]
        for phase, seconds in (("detect", detect), ("to_host", t_host - t0 - detect),
                               ("save", last["save"]), ("commit", invoked - last["save"])):
            _PUBLISH_US[phase].observe(seconds * 1e6)
        _PUBLISH_BYTES.inc(stats["bytes_written"])
        _PUBLISH_BLOCKS["whole"].inc(last["whole"])
        _PUBLISH_BLOCKS["patched"].inc(stats["blocks_written"] - last["whole"])
        self.published = params
        if self.server is None:
            self.server = SnapshotServer(LocalServer(self.backend), self._decode_fn,
                                         structure(tree), root=ROOT, name=NAME)
        return PublishInfo(self.backend.latest_ts, stats, dirty,
                           time.perf_counter() - t0, detect)

    def refresh(self) -> int:
        return self.server.refresh()

    def serve(self, prompts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.server.serve(prompts)

    def device_params(self) -> Dict:
        """The device tree of the pinned snapshot, moved on first use."""
        return self.snapshot.get(self.server.params)["params"]

    def _decode_fn(self, state, prompts: torch.Tensor):
        with span("serve.request"):
            with span("serve.snapshot"):
                dev = self.snapshot.get(state)
            if self._cast[0] is not dev:
                with span("serve.cast"):
                    self._cast = (dev, M.cast_params(dev["params"], self.compute_dtype))
            pixels = (request_pixel_embeds(self.cfg, prompts.shape[0], self.seed,
                                           prompts.device) if self.cfg.vision_prefix else None)
            logits, toks = generate(self.cfg, self._cast[1], prompts, self.tokens,
                                    compute_dtype=self.compute_dtype, pixel_embeds=pixels,
                                    kv_dtype=self.kv_dtype)
        _REQUESTS.inc()
        _TOKENS["prompt"].inc(prompts.numel())
        _TOKENS["generated"].inc(toks.numel())
        return logits, toks


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
    kv_dtype=None,
    params: Optional[Dict] = None,
) -> ServeRun:
    """Steps 1-4 of the module docstring. ``params`` (a device tree) skips
    the random initialization; prompts, pixel embeds and the update come
    from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = M.init_params(cfg, gen, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device)
    sl = ServeSlice(cfg, device=device, compute_dtype=compute_dtype, tokens=tokens,
                    kv_dtype=kv_dtype, seed=seed)
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
    secs["detect_v1"] = pub1.detect_seconds
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
    ap.add_argument("--kv-dtype", choices=list(KV_DTYPES), default="bf16",
                    help="the decode cache's type: bf16 (the compute type) or int8 "
                         "(per-position, per-KV-head scales)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    r = run(cfg, device=args.device, batch=args.batch, prompt_len=args.prompt_len,
            tokens=args.tokens, seed=args.seed, kv_dtype=KV_DTYPES[args.kv_dtype])
    n_dirty = sum(len(v) for v in r.publish_v1.dirty.values())
    print(f"arch={cfg.name} device={args.device} params={cfg.param_count()}")
    prefix = f"{cfg.vision_prefix} pixel embeds + " if cfg.vision_prefix else ""
    print(f"v0: published {r.publish_v0.stats['bytes_written']} B in "
          f"{r.seconds['publish_v0']:.2f}s; refresh {r.seconds['refresh_v0']:.2f}s; "
          f"served {args.batch}x({prefix}{args.prompt_len}+{args.tokens}) with the "
          f"{args.kv_dtype} cache in "
          f"{r.seconds['serve_v0']:.2f}s")
    print(f"v1: {n_dirty} dirty blocks, wrote {r.publish_v1.stats['blocks_written']} "
          f"blocks in place in {r.seconds['publish_v1']:.2f}s (dirty detection "
          f"{r.seconds['detect_v1']:.4f}s); refresh "
          f"{r.seconds['refresh_v1']:.2f}s; served in {r.seconds['serve_v1']:.2f}s")
    for tag, (_, toks) in (("v0", r.out_v0), ("v1", r.out_v1)):
        print(f"  {tag} row 0: {toks[0].tolist()}")


if __name__ == "__main__":
    main()
