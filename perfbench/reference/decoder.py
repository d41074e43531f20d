"""Plain reference of the decoder families the benchmark runs: dense GQA
(qwen2-1.5b) and hybrid parallel attention + mamba heads (hymba-1.5b).

Plain ``torch`` operations in float32 with TF32 off, no kernel, no cache
and no batching beyond the prompt rows; it imports nothing of the program.
It follows the published block equations as the port states them:

  x   = embed[tokens]
  h   = rms(x) * ln1
  dense:  x += attn(h)
  hybrid: x += (rms(attn(h)) * attn_branch_norm + rms(mamba(h)) * ssm_branch_norm) / 2
  x  += wo(silu(h2 @ wg) * (h2 @ wi)),  h2 = rms(x) * ln2
  logits = (rms(x) * final_norm) @ head   (head = embed^T when tied)

attn: q, k, v products (+ bias), RoPE with half-split rotation on float32
angles, causal softmax over the last ``sliding_window`` keys (0: all),
grouped query heads (head h reads KV head h // (H / KV)). mamba (mamba-1):
in_proj to (xi | z), causal depthwise conv of K taps on xi, SiLU, x_proj to
(dt_in | B | C), dt = softplus(dt_in @ dt_proj + dt_bias), the selective
scan h_t = exp(dt A) h_{t-1} + dt x B, y = C h + D x, gated by SiLU(z),
out_proj.

``Precision`` routes every product: ``FP32`` computes it in float32,
``FP8`` rounds both operands (and, backward, the incoming gradient) to
float8 e4m3 with one scale a tensor, the step below the bf16 the
configurations state; it is the control of the correctness check.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.tree import nest

Leaf = Tuple[str, Tuple[int, ...], str]


# --------------------------------------------------------------------------- #
# Parameter layout
# --------------------------------------------------------------------------- #
def layout(c: Dict) -> List[Leaf]:
    """(flat name, shape, init kind) of every parameter, stacked over the
    layers on a leading axis. Init kinds: normal (std 0.02), out (std
    0.02 / sqrt(2 L), the projections back into the residual), norm (1 +
    0.02 N(0, 1)), ssm_A (log 1..N), dt_bias (inverse softplus of dt drawn
    log-uniform in [1e-3, 0.1])."""
    D, L, V = c["d_model"], c["num_layers"], c["vocab_size"]
    out: List[Leaf] = [("embed", (V, D), "normal"), ("final_norm", (D,), "norm")]
    if not c.get("tie_embeddings"):
        out.append(("lm_head", (D, V), "normal"))
    fam = c["family"]
    if fam in ("dense", "hybrid"):
        H, KV = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
        out += [("layers/attn/wq", (L, D, H), "normal"), ("layers/attn/wk", (L, D, KV), "normal"),
                ("layers/attn/wv", (L, D, KV), "normal"), ("layers/attn/wo", (L, H, D), "out"),
                ("layers/ln1", (L, D), "norm")]
        if c.get("qkv_bias"):
            out += [("layers/attn/bq", (L, H), "normal"), ("layers/attn/bk", (L, KV), "normal"),
                    ("layers/attn/bv", (L, KV), "normal")]
    if fam == "hybrid":
        Di, R, N, K = c["d_inner"], c["dt_rank"], c["ssm_state"], c["ssm_conv"]
        out += [("layers/ssm/in_proj", (L, D, 2 * Di), "normal"),
                ("layers/ssm/conv_w", (L, Di, K), "normal"),
                ("layers/ssm/conv_b", (L, Di), "normal"),
                ("layers/ssm/x_proj", (L, Di, R + 2 * N), "normal"),
                ("layers/ssm/dt_proj", (L, R, Di), "normal"),
                ("layers/ssm/dt_bias", (L, Di), "dt_bias"),
                ("layers/ssm/A_log", (L, Di, N), "ssm_A"),
                ("layers/ssm/D", (L, Di), "norm"),
                ("layers/ssm/out_proj", (L, Di, D), "out"),
                ("layers/attn_branch_norm", (L, D), "norm"),
                ("layers/ssm_branch_norm", (L, D), "norm")]
    if fam not in ("dense", "hybrid"):
        raise ValueError(f"the reference has no {fam!r} family")
    F_ = c["d_ff"]
    out += [("layers/mlp/wi", (L, D, F_), "normal"), ("layers/mlp/wg", (L, D, F_), "normal"),
            ("layers/mlp/wo", (L, F_, D), "out"), ("layers/ln2", (L, D), "norm")]
    return sorted(out)


# --------------------------------------------------------------------------- #
# Precision of the products
# --------------------------------------------------------------------------- #
E4M3_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale (its largest magnitude
    onto 448), back in float32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        return _unbroadcast(ga, qa.shape), _unbroadcast(gb, qb.shape)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class Precision:
    """How the reference computes its products."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(name)
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8MatMul.apply(a, b)
        return a @ b


FP32, FP8 = Precision("fp32"), Precision("fp8")


def no_tf32() -> None:
    """Float32 products in float32: the card would run them in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd): half-split rotation at positions 0..S-1, the
    angles as float32 products of position and frequency."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / torch.pow(theta, torch.arange(0, hd, 2, dtype=torch.float32,
                                                device=x.device) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, prec: Precision, q_chunk: int = 512):
    """Causal GQA attention. q (B, S, H, hd), k/v (B, S, KV, hd) ->
    (B, S, H, hd); keys of query i are those j <= i (and j > i - window
    when ``window``). Query chunks of ``q_chunk`` rows read only the keys
    their mask can keep."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4)       # B KV G S hd
    kt = k.permute(0, 2, 3, 1)[:, :, None]                         # B KV 1 hd S
    vv = v.permute(0, 2, 1, 3)[:, :, None]                         # B KV 1 S hd
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for lo in range(0, S, q_chunk):
        hi = min(S, lo + q_chunk)
        klo = 0 if window <= 0 else max(0, lo - window + 1)
        s = prec.mm(qg[:, :, :, lo:hi], kt[..., klo:hi]) * scale  # B KV G c Sk
        qp = torch.arange(lo, hi, device=q.device)[:, None]
        kp = torch.arange(klo, hi, device=q.device)[None, :]
        ok = kp <= qp
        if window > 0:
            ok = ok & (kp > qp - window)
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        outs.append(prec.mm(p, vv[:, :, :, klo:hi]))
    o = torch.cat(outs, dim=3)                                     # B KV G S hd
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def attn_branch(c, lp, h, prec: Precision):
    B, S, _ = h.shape
    hd = c["head_dim"]
    ap = lp["attn"]
    q, k, v = prec.mm(h, ap["wq"]), prec.mm(h, ap["wk"]), prec.mm(h, ap["wv"])
    if c.get("qkv_bias"):
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = rope(q.reshape(B, S, c["num_heads"], hd), c["rope_theta"])
    k = rope(k.reshape(B, S, c["num_kv_heads"], hd), c["rope_theta"])
    v = v.reshape(B, S, c["num_kv_heads"], hd)
    o = attention(q, k, v, c.get("sliding_window", 0), prec)
    return prec.mm(o.reshape(B, S, -1), ap["wo"])


def scan_chunk_len(dt: torch.Tensor, A: torch.Tensor, limit: float = 60.0) -> int:
    """The longest power-of-two chunk, at most 64 steps, over which the
    decay exponent |A| sum(dt) stays under ``limit``, so that exp(-cum)
    inside a chunk cannot overflow float32."""
    worst = float(A.detach().abs().max()) * float(dt.detach().max())
    t = 64
    while t > 1 and t * worst > limit:
        t //= 2
    return t


def selective_scan(x, dt, Bm, Cm, A, D):
    """The mamba-1 recurrence on one row: x, dt (S, Di); Bm, Cm (S, N);
    A (Di, N) negative; D (Di,). Returns y (S, Di). In chunks of T steps:
    inside a chunk h_t = e^{c_t} (h_in + sum_{s<=t} e^{-c_s} u_s) with
    c the running sum of dt A from the chunk's start and u = dt x B; the
    chunks' entering states follow one after another."""
    S, Di = x.shape
    N = A.shape[1]
    T = scan_chunk_len(dt, A)
    pad = (-S) % T
    if pad:
        x, dt = F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    n = (S + pad) // T
    u = ((dt * x)[:, :, None] * Bm[:, None, :]).reshape(n, T, Di, N)
    cum = torch.cumsum((dt[:, :, None] * A).reshape(n, T, Di, N), dim=1)
    local = torch.exp(cum) * torch.cumsum(torch.exp(-cum) * u, dim=1)
    decay = torch.exp(cum[:, -1])                                   # n Di N
    h_in = [torch.zeros(Di, N, dtype=x.dtype, device=x.device)]
    for i in range(n - 1):
        h_in.append(decay[i] * h_in[-1] + local[i, -1])
    h = local + torch.exp(cum) * torch.stack(h_in)[:, None]
    y = torch.einsum("ctdn,ctn->ctd", h, Cm.reshape(n, T, N)).reshape(n * T, Di)
    return y[:S] + x[:S] * D


def mamba_branch(c, lp, h, prec: Precision):
    p = lp["ssm"]
    B, S, _ = h.shape
    R, N, K = c["dt_rank"], c["ssm_state"], c["ssm_conv"]
    xi, z = prec.mm(h, p["in_proj"]).chunk(2, dim=-1)
    conv = F.conv1d(xi.transpose(1, 2), p["conv_w"][:, None, :], p["conv_b"],
                    padding=K - 1, groups=xi.shape[-1])[..., :S]
    xa = F.silu(conv.transpose(1, 2))
    dt_in, Bm, Cm = torch.split(prec.mm(xa, p["x_proj"]), [R, N, N], dim=-1)
    dt = F.softplus(prec.mm(dt_in, p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = torch.stack([selective_scan(xa[b], dt[b], Bm[b], Cm[b], A, p["D"]) for b in range(B)])
    return prec.mm(y * F.silu(z), p["out_proj"])


def block(c, x, lp, prec: Precision):
    eps = c["norm_eps"]
    h = rms(x, lp["ln1"], eps)
    if c["family"] == "hybrid":
        a = rms(attn_branch(c, lp, h, prec), lp["attn_branch_norm"], eps)
        s = rms(mamba_branch(c, lp, h, prec), lp["ssm_branch_norm"], eps)
        x = x + 0.5 * (a + s)
    else:
        x = x + attn_branch(c, lp, h, prec)
    h2 = rms(x, lp["ln2"], eps)
    m = lp["mlp"]
    return x + prec.mm(prec.mm(h2, m["wi"]) * F.silu(prec.mm(h2, m["wg"])), m["wo"])


def layer_params(tree: Dict, i: int) -> Dict:
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def head_weight(c, tree: Dict) -> torch.Tensor:
    return tree["embed"].t() if c.get("tie_embeddings") else tree["lm_head"]


def hidden(c, tree: Dict, tokens: torch.Tensor, prec: Precision, remat: bool = False):
    """Final-normed hidden states (B, S, D); ``remat`` recomputes each
    layer in the backward pass, so one layer's graph is held at a time."""
    x = tree["embed"][tokens]
    for i in range(c["num_layers"]):
        lp = layer_params(tree["layers"], i)
        if remat:
            x = checkpoint(lambda x_, lp_: block(c, x_, lp_, prec), x, lp, use_reentrant=False)
        else:
            x = block(c, x, lp, prec)
    return rms(x, tree["final_norm"], c["norm_eps"])


# --------------------------------------------------------------------------- #
# Serving: the prefill's last-position logits
# --------------------------------------------------------------------------- #
@torch.no_grad()
def last_logits(c, flat: Dict[str, torch.Tensor], tokens: torch.Tensor,
                prec: Precision = FP32) -> torch.Tensor:
    """(B, V) float32 logits at each prompt's last position, one prompt
    row at a time."""
    tree = nest(flat)
    head = head_weight(c, tree)
    rows = [prec.mm(hidden(c, tree, tokens[b:b + 1], prec)[:, -1], head)
            for b in range(tokens.shape[0])]
    return torch.cat(rows)


# --------------------------------------------------------------------------- #
# Training: loss, gradients and AdamW
# --------------------------------------------------------------------------- #
def _nll(c, x, head, labels, mask, prec: Precision):
    logits = prec.mm(x, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def loss_and_grads(c, flat: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   prec: Precision = FP32, *, rows: Sequence[int] = (),
                   ce_chunk: int = 1024):
    """Mean next-token NLL over the batch's masked positions and its
    gradient for every leaf of ``flat``, a row at a time (each row's NLL
    sum over the whole batch's count, so the sums over rows are the
    batch's). ``rows`` keeps only those rows (the mean over them): a fault
    the correctness check must catch."""
    keep = list(rows) or list(range(batch["tokens"].shape[0]))
    count = batch["mask"][keep].sum()
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    tree = nest(leaves)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    total = 0.0
    for b in keep:
        with torch.enable_grad():
            x = hidden(c, tree, batch["tokens"][b:b + 1], prec, remat=True)
            head = head_weight(c, tree)
            lab, msk = batch["labels"][b:b + 1], batch["mask"][b:b + 1]
            nll = x.new_zeros(())
            for lo in range(0, x.shape[1], ce_chunk):
                sl = slice(lo, lo + ce_chunk)
                nll = nll + checkpoint(_nll, c, x[:, sl], head, lab[:, sl], msk[:, sl], prec,
                                       use_reentrant=False)
            loss = nll / count
            gs = torch.autograd.grad(loss, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        total += float(loss.detach())
    return total, grads


def lr_at(opt: Dict, step: int) -> float:
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min``."""
    if step < opt["warmup_steps"]:
        return opt["lr_peak"] * step / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"]) / max(opt["decay_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    return opt["lr_min"] + 0.5 * (opt["lr_peak"] - opt["lr_min"]) * (1 + math.cos(math.pi * t))


def train_steps(c, flat: Dict[str, torch.Tensor], batches, opt: Dict,
                prec: Precision = FP32, *, rows: Sequence[int] = ()) -> Dict:
    """AdamW steps from ``flat`` on ``batches``: decoupled weight decay on
    leaves of two or more dims, clipping by the global gradient norm, bias
    correction. Returns the loss and the global gradient norm of each
    step, each leaf's gradient norm at the first step before clipping
    (``grad_norms``) and after it (``clipped``), and the norm of each
    leaf's change after the last step."""
    p = {k: v.clone() for k, v in flat.items()}
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    losses, gnorms, first, clipped = [], [], {}, {}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    for n, batch in enumerate(batches, start=1):
        loss, g = loss_and_grads(c, p, batch, prec, rows=rows)
        losses.append(loss)
        gnorm = math.sqrt(sum(float(t.square().sum()) for t in g.values()))
        gnorms.append(gnorm)
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
        if n == 1:
            first = {k: float(t.norm()) for k, t in g.items()}
            clipped = {k: v * scale for k, v in first.items()}
        lr = lr_at(opt, n)
        for k in p:
            gk = g[k] * scale
            m[k] = b1 * m[k] + (1 - b1) * gk
            v2[k] = b2 * v2[k] + (1 - b2) * gk.square()
            step = (m[k] / (1 - b1 ** n)) / ((v2[k] / (1 - b2 ** n)).sqrt() + eps)
            if p[k].dim() >= 2:
                step = step + opt["weight_decay"] * p[k]
            p[k] = p[k] - lr * step
        del g
    change = {k: float((p[k] - flat[k]).norm()) for k in p}
    return {"losses": losses, "gnorms": gnorms, "grad_norms": first, "clipped": clipped,
            "change": change}
