"""Plain reference of the mixture-of-experts decoder family the benchmark
can run (Qwen3-MoE: hf Qwen/Qwen3-30B-A3B, arXiv:2505.09388).

Plain ``torch`` operations in float32 with TF32 off, no kernel and no
cache; it imports nothing of the program. It takes ``decoder.py``'s norm,
RoPE, attention, products and AdamW schedule, and follows the published
Qwen3-MoE block:

  x   = embed[tokens]
  h   = rms(x) * ln1
  x  += attn(h), q and k RMS-normed per head (q_norm, k_norm) before RoPE
  h2  = rms(x) * ln2
  g   = softmax(h2 @ router) in float32, over all E experts
  the top k of g by a stable descending sort (the lower id first on
  ties), their weights w renormalised to sum 1
  x  += sum over the token's k slots, expert e each:
        w * (silu(h2 @ wg[e]) * (h2 @ wi[e])) @ wo[e]
  logits = (rms(x) * final_norm) @ head   (head = embed^T when tied)

Every layer holds all E experts and every routed slot is computed: no
token is dropped, as published. A configuration cut to one chip is cut in
depth, so that each layer does the expert rows a chip of an
expert-parallel deployment does (B S k) and gives every token all k of
its experts' outputs. The training loss is the mean next-token NLL plus
``router_aux_loss_coef`` (0.01, the port's weight, when the key is
absent) times the layers' mean load-balance term, each layer's
E * sum_e mean_t(g_te) * mean_t(n_te), n the token's slots on expert e,
over the batch's tokens; the loss reported is the NLL alone, as the port
reports it.

Departures from the published model, each stated by the configuration:

* **The load-balance term** is taken per layer and averaged over the
  layers, as the port takes it; Hugging Face's ``load_balancing_loss_func``
  takes the means over all layers' tokens at once.
* The gradient runs over the kept rows of the batch together (the
  load-balance means are the batch's), not a row at a time as in
  ``decoder.py``.

``Precision`` is ``decoder.py``'s: ``FP32``, or ``FP8`` (every product,
the router's and the experts' included, on float8 e4m3 operands), the
control of the correctness check.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.decoder import (FP8, FP32, Leaf, Precision, _nll, attention,  # noqa: F401
                                         head_weight, layer_params, lr_at, no_tf32, rms, rope)
from perfbench.tree import nest

AUX_COEF = 0.01   # the port's load-balance weight, where the configuration states none


# --------------------------------------------------------------------------- #
# Parameter layout
# --------------------------------------------------------------------------- #
def layout(c: Dict) -> List[Leaf]:
    """(flat name, shape, init kind) of every parameter, stacked over the
    layers on a leading axis, in ``decoder.layout``'s init kinds; wi, wg
    and wo stack the E experts."""
    if c["family"] != "moe":
        raise ValueError(f"the MoE reference has no {c['family']!r} family")
    D, L, V = c["d_model"], c["num_layers"], c["vocab_size"]
    H, KV, hd = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"], c["head_dim"]
    E, F_ = c["num_experts"], c["moe_d_ff"]
    out: List[Leaf] = [("embed", (V, D), "normal"), ("final_norm", (D,), "norm"),
                       ("layers/attn/wq", (L, D, H), "normal"),
                       ("layers/attn/wk", (L, D, KV), "normal"),
                       ("layers/attn/wv", (L, D, KV), "normal"),
                       ("layers/attn/wo", (L, H, D), "out"), ("layers/ln1", (L, D), "norm"),
                       ("layers/moe/router", (L, D, E), "normal"),
                       ("layers/moe/wi", (L, E, D, F_), "normal"),
                       ("layers/moe/wg", (L, E, D, F_), "normal"),
                       ("layers/moe/wo", (L, E, F_, D), "out"), ("layers/ln2", (L, D), "norm")]
    if not c.get("tie_embeddings"):
        out.append(("lm_head", (D, V), "normal"))
    if c.get("qkv_bias"):
        out += [("layers/attn/bq", (L, H), "normal"), ("layers/attn/bk", (L, KV), "normal"),
                ("layers/attn/bv", (L, KV), "normal")]
    if c.get("qk_norm"):
        out += [("layers/attn/q_norm", (L, hd), "norm"), ("layers/attn/k_norm", (L, hd), "norm")]
    return sorted(out)


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
def attn_branch(c, lp, h, prec: Precision):
    B, S, _ = h.shape
    hd, eps = c["head_dim"], c["norm_eps"]
    ap = lp["attn"]
    q, k, v = prec.mm(h, ap["wq"]), prec.mm(h, ap["wk"]), prec.mm(h, ap["wv"])
    if c.get("qkv_bias"):
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = q.reshape(B, S, c["num_heads"], hd)
    k = k.reshape(B, S, c["num_kv_heads"], hd)
    if c.get("qk_norm"):
        q, k = rms(q, ap["q_norm"], eps), rms(k, ap["k_norm"], eps)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    v = v.reshape(B, S, c["num_kv_heads"], hd)
    o = attention(q, k, v, c.get("sliding_window", 0), prec)
    return prec.mm(o.reshape(B, S, -1), ap["wo"])


def route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, k) renormalised, ids (T, k), gates
    (T, E)): the float32 softmax's k largest gates by a stable descending
    sort, the lower id first on ties."""
    gates = torch.softmax(logits.float(), dim=-1)
    top, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    return top / top.sum(-1, keepdim=True), ids, gates


def balance(gates: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """E * sum over experts of the mean gate times the mean slot count,
    over the tokens of gates (T, E) and ids (T, k)."""
    E = gates.shape[-1]
    counts = (ids[..., None] == torch.arange(E, device=ids.device)).float().sum(1)
    return E * (gates.mean(0) * counts.mean(0)).sum()


def experts(mp, hf, weights, ids, prec: Precision) -> torch.Tensor:
    """The weighted sum of each token's k experts' outputs (wi, wg
    (E, D, F) and wo (E, F, D)): hf (T, D), weights and ids (T, k) ->
    (T, D). Every routed slot is computed, an expert at a time."""
    y = torch.zeros_like(hf)
    for j in range(mp["wi"].shape[0]):
        tok, slot = torch.nonzero(ids == j, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = hf[tok]
        act = F.silu(prec.mm(xe, mp["wg"][j])) * prec.mm(xe, mp["wi"][j])
        y = y.index_add(0, tok, prec.mm(act, mp["wo"][j]) * weights[tok, slot, None])
    return y


def moe_branch(c, mp, h, prec: Precision):
    """The MoE feed-forward on the normed h (B, S, D): (its output
    (B, S, D), the layer's load-balance term)."""
    B, S, D = h.shape
    hf = h.reshape(B * S, D)
    weights, ids, gates = route(prec.mm(hf, mp["router"]), c["num_experts_per_tok"])
    y = experts(mp, hf, weights, ids, prec)
    return y.reshape(B, S, D), balance(gates, ids)


def block(c, x, lp, prec: Precision):
    """One layer: (x, its load-balance term)."""
    eps = c["norm_eps"]
    x = x + attn_branch(c, lp, rms(x, lp["ln1"], eps), prec)
    y, aux = moe_branch(c, lp["moe"], rms(x, lp["ln2"], eps), prec)
    return x + y, aux


def hidden(c, tree: Dict, tokens: torch.Tensor, prec: Precision, remat: bool = False):
    """(final-normed hidden states (B, S, D), the layers' mean load-balance
    term); ``remat`` recomputes each layer in the backward pass."""
    x = tree["embed"][tokens]
    auxes = []
    for i in range(c["num_layers"]):
        lp = layer_params(tree["layers"], i)
        if remat:
            x, aux = checkpoint(lambda x_, lp_: block(c, x_, lp_, prec), x, lp,
                                use_reentrant=False)
        else:
            x, aux = block(c, x, lp, prec)
        auxes.append(aux)
    return rms(x, tree["final_norm"], c["norm_eps"]), torch.stack(auxes).mean()


# --------------------------------------------------------------------------- #
# Serving: the prefill's last-position logits
# --------------------------------------------------------------------------- #
@torch.no_grad()
def last_logits(c, flat: Dict[str, torch.Tensor], tokens: torch.Tensor,
                prec: Precision = FP32) -> torch.Tensor:
    """(B, V) float32 logits at each prompt's last position, one prompt
    row at a time (routing is a token's own, so rows do not interact)."""
    tree = nest(flat)
    head = head_weight(c, tree)
    rows = [prec.mm(hidden(c, tree, tokens[b:b + 1], prec)[0][:, -1], head)
            for b in range(tokens.shape[0])]
    return torch.cat(rows)


# --------------------------------------------------------------------------- #
# Training: loss, gradients and AdamW
# --------------------------------------------------------------------------- #
def loss_and_grads(c, flat: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   prec: Precision = FP32, *, rows: Sequence[int] = (),
                   ce_chunk: int = 1024):
    """The mean next-token NLL over the batch's masked positions, and the
    gradient of it plus the weighted load-balance term for every leaf of
    ``flat``, over the kept rows together. ``rows`` keeps only those rows
    (the means over them): a fault the correctness check must catch."""
    keep = list(rows) or list(range(batch["tokens"].shape[0]))
    tokens, labels, mask = (batch[k][keep] for k in ("tokens", "labels", "mask"))
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    tree = nest(leaves)
    with torch.enable_grad():
        x, aux = hidden(c, tree, tokens, prec, remat=True)
        head = head_weight(c, tree)
        nll = x.new_zeros(())
        for lo in range(0, x.shape[1], ce_chunk):
            sl = slice(lo, lo + ce_chunk)
            nll = nll + checkpoint(_nll, c, x[:, sl], head, labels[:, sl], mask[:, sl], prec,
                                   use_reentrant=False)
        loss = nll / mask.sum()
        total = loss + c.get("router_aux_loss_coef", AUX_COEF) * aux
        gs = torch.autograd.grad(total, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, gs))


def train_steps(c, flat: Dict[str, torch.Tensor], batches, opt: Dict,
                prec: Precision = FP32, *, rows: Sequence[int] = ()) -> Dict:
    """``decoder.train_steps`` with this family's loss: AdamW steps from
    ``flat`` on ``batches`` (decoupled weight decay on leaves of two or
    more dims, clipping by the global gradient norm, bias correction).
    Returns the loss and the global gradient norm of each step, each
    leaf's gradient norm at the first step before clipping
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
