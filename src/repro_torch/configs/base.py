"""Architecture config system.

Every assigned architecture is a frozen ``ModelConfig``; every assigned
input-shape cell is a ``ShapeCell``. The dry-run, smoke tests, benchmarks and
launchers all key off this registry (``--arch <id>``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-LM architecture (backbone only for audio/vlm)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int          # query heads; 0 for attention-free archs
    num_kv_heads: int
    head_dim: int
    d_ff: int               # dense FFN width (per-expert width for MoE in moe_d_ff)
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    dt_rank: int = 0

    # --- attention details ---
    sliding_window: int = 0     # 0 => full attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # --- modality stubs ---
    vision_prefix: int = 0      # [vlm] precomputed patch embeddings prepended
    audio_tokens: bool = False  # [audio] tokens are EnCodec codes (stub frontend)

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""            # provenance tag, e.g. "arXiv:2407.14679; hf"

    # ------------------------------------------------------------------ #
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return not self.attention_free

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context without O(S) full-softmax KV?

        SSM archs carry O(1) state; hybrid uses SWA+SSM; SWA archs have a
        bounded attention window.
        """
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        D, L = self.d_model, self.num_layers
        n = self.vocab_size * D  # embedding
        if not self.tie_embeddings:
            n += D * self.vocab_size  # lm head
        n += D  # final norm
        per_layer = 0
        if self.has_attention:
            per_layer += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
            if self.qk_norm:
                per_layer += 2 * self.head_dim
        if self.has_ssm:
            di = self.d_inner
            per_layer += (
                D * 2 * di                      # in_proj
                + di * self.ssm_conv + di       # conv
                + di * (self.dt_rank + 2 * self.ssm_state)  # x_proj
                + self.dt_rank * di + di        # dt_proj
                + di * self.ssm_state + di      # A_log, D skip
                + di * D                        # out_proj
            )
        if self.is_moe:
            per_layer += D * self.num_experts  # router
            per_layer += self.num_experts * 3 * D * self.moe_d_ff
        elif self.d_ff > 0:
            per_layer += 3 * D * self.d_ff
        # norms: pre-mixer ln1, pre-ffn ln2, hybrid branch-fusion norms
        per_layer += D                          # ln1
        if self.is_moe or self.d_ff > 0:
            per_layer += D                      # ln2
        if self.family == "hybrid":
            per_layer += 2 * D                  # branch norms
        return n + L * per_layer

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: routed experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_all = self.num_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        moe_active = (
            self.num_layers * self.num_experts_per_tok * 3 * self.d_model * self.moe_d_ff
        )
        return full - moe_all + moe_active


@dataclass(frozen=True)
class ShapeCell:
    """An assigned input-shape cell."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)
SHAPES_BY_NAME: Dict[str, ShapeCell] = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; reason if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (see DESIGN.md)"
        )
    return True, ""


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def list_configs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import for registration side effects
    from repro_torch.configs import (  # noqa: F401
        deepseek_coder_33b,
        falcon_mamba_7b,
        granite_3_2b,
        hymba_1_5b,
        internvl2_76b,
        minitron_8b,
        mixtral_8x7b,
        musicgen_large,
        qwen2_1_5b,
        qwen3_moe_30b_a3b,
    )


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: Dict[str, object] = dict(
        num_layers=2,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        rope_theta=cfg.rope_theta,
    )
    if cfg.has_attention:
        small.update(num_heads=4, num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)), head_dim=16)
    else:
        small.update(num_heads=0, num_kv_heads=0, head_dim=0)
    if cfg.is_moe:
        small.update(num_experts=4, num_experts_per_tok=min(2, cfg.num_experts_per_tok), moe_d_ff=32, d_ff=0)
    if cfg.has_ssm:
        small.update(d_inner=128, ssm_state=8, dt_rank=8, ssm_conv=cfg.ssm_conv)
    if cfg.sliding_window:
        small.update(sliding_window=32)
    if cfg.vision_prefix:
        small.update(vision_prefix=8)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **small)  # type: ignore[arg-type]
