"""The work the benchmark's cells need, counted from shapes: attended
pairs, model FLOPs, and each kernel's least FLOPs and bytes.

Everything here is arithmetic on a configuration's sizes (the ``model``
object of a file under ``configs/``) and a traffic mix's shapes. Each
input byte is read once and each output byte written once; remat
recompute is never counted. ``least_seconds`` takes the table of peaks in
``peaks.json``.
"""
from __future__ import annotations

from typing import Dict

BF16, F32 = 2, 4


def attended_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs the causal mask and a sliding ``window`` keep in
    an S x S attention, per (batch row, head)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def has_attention(c: Dict) -> bool:
    """Whether the configuration's layers have attention heads."""
    return c.get("num_heads", 0) > 0


def matmul_params(c: Dict, *, head: bool = True) -> int:
    """Parameters that enter a product for every token: the layers'
    projections, and the output head when ``head``. Embedding lookups,
    norms, biases, the conv and the scan's A and D are not products. A
    ``moe`` layer's router (D x E) enters for every token, its experts'
    three products for each of the token's k slots (no slot is dropped),
    and it has no dense FFN."""
    D, L = c["d_model"], c["num_layers"]
    per = 0
    if has_attention(c):
        q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
        per += D * (q + 2 * kv) + q * D
    if c["family"] == "hybrid":
        Di, R, N = c["d_inner"], c["dt_rank"], c["ssm_state"]
        per += D * 2 * Di + Di * (R + 2 * N) + R * Di + Di * D
    if c["family"] == "moe":
        per += D * c["num_experts"] + 3 * D * c["moe_d_ff"] * c["num_experts_per_tok"]
    else:
        per += 3 * D * c["d_ff"]
    return L * per + (D * c["vocab_size"] if head else 0)


def attention_flops(c: Dict, B: int, S: int) -> Dict[str, int]:
    """The whole model's attention FLOPs for B rows of S tokens: forward
    2 products (Q K^T, P V) and backward 5 (Q K^T again, dV, dP, dK, dQ) of
    2 head_dim FLOPs per kept pair, as the flash kernels compute them.
    ``model_bwd`` is the backward a model-FLOPs count takes, 4 products."""
    if not has_attention(c):
        return {"fwd": 0, "bwd": 0, "model_bwd": 0}
    pairs = B * c["num_heads"] * attended_pairs(S, c.get("sliding_window", 0))
    per = 2 * c["head_dim"] * pairs * c["num_layers"]
    return {"fwd": 2 * per, "bwd": 5 * per, "model_bwd": 4 * per}


def train_step_flops(c: Dict, B: int, S: int) -> int:
    """Model FLOPs of one training step: 6 x product parameters x tokens,
    plus attention forward and backward; no remat recompute."""
    att = attention_flops(c, B, S)
    return 6 * matmul_params(c) * B * S + att["fwd"] + att["model_bwd"]


def prefill_flops(c: Dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill of B prompts of S tokens: 2 x the layers'
    product parameters x tokens, the head at the last position only, and
    attention forward."""
    return (2 * matmul_params(c, head=False) * B * S + 2 * c["d_model"] * c["vocab_size"] * B
            + attention_flops(c, B, S)["fwd"])


def flash_work(c: Dict, B: int, S: int, direction: str) -> Dict[str, int]:
    """Least FLOPs and bytes of the model's flash calls in one direction
    ("fwd": the prefill or training forward; "fwd_lse": the training
    forward, which also writes the float32 log-sum-exp; "bwd"), all
    layers. bf16 q, k, v, o, dout, dq, dk, dv; float32 lse."""
    H, KV, hd, L = c["num_heads"], c["num_kv_heads"], c["head_dim"], c["num_layers"]
    q = B * S * H * hd * BF16
    kv = B * S * KV * hd * BF16
    lse = B * H * S * F32
    att = attention_flops(c, B, S)
    if direction == "fwd":
        return {"flops": att["fwd"], "bytes": L * (q + 2 * kv + q)}
    if direction == "fwd_lse":
        return {"flops": att["fwd"], "bytes": L * (q + 2 * kv + q + lse)}
    if direction == "bwd":
        # read q, k, v, o, dout, lse; write dq, dk, dv
        return {"flops": att["bwd"], "bytes": L * (q + 2 * kv + q + q + lse + q + 2 * kv)}
    raise ValueError(direction)


def scan_work(c: Dict, B: int, S: int, direction: str) -> Dict[str, int]:
    """Least FLOPs and bytes of the model's selective-scan calls in one
    direction, all layers. Forward reads x (bf16), dt (float32), B and C
    (float32, (B, S, N)), A (Di, N) and D; writes y (bf16) and the last
    state (float32, (B, Di, N)). Per state element 7 FLOPs forward and
    19 backward, per channel 3 forward (the skip term). Backward reads the
    forward's inputs and dy (bf16); writes dx (bf16), ddt, dB, dC, dA, dD
    (float32)."""
    if c["family"] != "hybrid":
        return {"flops": 0, "bytes": 0}
    Di, N, L = c["d_inner"], c["ssm_state"], c["num_layers"]
    bsd, bsn, dn = B * S * Di, B * S * N, Di * N
    ins = bsd * BF16 + bsd * F32 + 2 * bsn * F32 + dn * F32 + Di * F32
    if direction == "fwd":
        return {"flops": L * (7 * bsd * N + 3 * bsd),
                "bytes": L * (ins + bsd * BF16 + B * dn * F32)}
    if direction == "bwd":
        outs = bsd * BF16 + bsd * F32 + 2 * bsn * F32 + dn * F32 + Di * F32
        return {"flops": L * 19 * bsd * N, "bytes": L * (ins + bsd * BF16 + outs)}
    raise ValueError(direction)


def expert_work(c: Dict, B: int, S: int, direction: str) -> Dict[str, int]:
    """Least FLOPs and bytes of the experts' products in one direction, all
    layers, over the B S k (token, slot) rows of B S tokens: every slot is
    computed, as no token is dropped, so these are the rows the kernels
    take, not an expectation. Forward 3 products (x Wi, x Wg, act Wo),
    backward 6 (each one's two input gradients), of 2 D F FLOPs a row
    each. Bytes as a fused kernel moves them, each operand and result once
    in bf16: forward reads the rows x and all E experts' Wi, Wg, Wo and
    writes y; backward reads x, dy and the weights and writes dx and the
    three weight gradients. The (rows, F) intermediates, the routing and
    the dispatch are not counted."""
    if c["family"] != "moe":
        return {"flops": 0, "bytes": 0}
    D, F, L = c["d_model"], c["moe_d_ff"], c["num_layers"]
    rows = B * S * c["num_experts_per_tok"]
    weights = 3 * c["num_experts"] * D * F * BF16
    if direction == "fwd":
        return {"flops": L * 3 * 2 * rows * D * F, "bytes": L * (2 * rows * D * BF16 + weights)}
    if direction == "bwd":
        return {"flops": L * 6 * 2 * rows * D * F,
                "bytes": L * (3 * rows * D * BF16 + 2 * weights)}
    raise ValueError(direction)


def least_seconds(work: Dict[str, int], peaks: Dict) -> float:
    """The larger of FLOPs at the bf16 dense peak and bytes at HBM rate."""
    return max(work["flops"] / peaks["bf16_flops_per_s"], work["bytes"] / peaks["hbm_bytes_per_s"])
