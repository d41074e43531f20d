"""``moe_decoder.py``'s model, loss and AdamW steps, with the training
check's state kept in host memory: the reference for a configuration
whose check does not fit the card beside what the run still holds there.

Every number ``train_steps`` returns is ``moe_decoder.train_steps``'s, and
``last_logits`` and ``layout`` are its own. What differs is where the
state lives while the steps run:

* the weights are stepped in place in the tensors ``train_steps`` is
  given, and put back, bit for bit, before it returns (a copy of them
  waits in host memory);
* each layer's slice of a leaf stacked over the layers is a leaf of its
  own (a view of the stacked weight), and each leaf's gradient moves to
  host memory as soon as the backward pass has accumulated it;
* AdamW's moments live in host memory, and the update runs on the card a
  slice of a leaf at a time, with ``moe_decoder``'s operations in its
  order, so every element takes the same bits.

So the card holds the weights once, one layer's recomputed graph and a
slice of the update, where ``moe_decoder.train_steps`` holds a copy of
the weights, both moments and every gradient besides.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.moe_decoder import (AUX_COEF, FP8, FP32, Precision, _nll,  # noqa: F401
                                             head_weight, hidden, last_logits, layout, lr_at,
                                             no_tf32)
from perfbench.tree import nest

CHUNK = 1 << 26   # elements of a leaf that one slice of the update takes

Part = Tuple[str, int, torch.Tensor]   # (leaf name, layer or -1 for a whole leaf, view)


def _parts(flat: Dict[str, torch.Tensor]) -> List[Part]:
    """The leaves autograd sees: each layer's slice of a ``layers/`` leaf
    and every other leaf whole, each a view of ``flat``'s tensor."""
    out: List[Part] = []
    for k, v in flat.items():
        if k.startswith("layers/"):
            out += [(k, i, v[i].detach().requires_grad_(True)) for i in range(v.shape[0])]
        else:
            out.append((k, -1, v.detach().requires_grad_(True)))
    return out


def _tree(parts: Sequence[Part]) -> Dict:
    """The parameter tree ``moe_decoder.hidden`` takes, each stacked leaf
    a list of its layers' leaves (``layer_params`` indexes either)."""
    flat: Dict = {}
    for k, i, t in parts:
        if i < 0:
            flat[k] = t
        else:
            flat.setdefault(k, []).append(t)
    return nest(flat)


def loss_and_grads(c, flat: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], prec: Precision = FP32, *,
                   rows: Sequence[int] = (), ce_chunk: int = 1024) -> Tuple[float, Dict]:
    """``moe_decoder.loss_and_grads``, writing each leaf's gradient into
    ``grads`` (host tensors shaped as ``flat``'s) as soon as it is whole.
    Returns the NLL and each leaf's squared gradient norm."""
    keep = list(rows) or list(range(batch["tokens"].shape[0]))
    tokens, labels, mask = (batch[k][keep] for k in ("tokens", "labels", "mask"))
    parts = _parts(flat)
    sq: Dict[str, List[torch.Tensor]] = {k: [] for k in flat}

    def hook(k: str, i: int):
        def move(t: torch.Tensor) -> None:
            sq[k].append(t.grad.square().sum())
            (grads[k] if i < 0 else grads[k][i]).copy_(t.grad)
            t.grad = None
        return move

    for k, i, t in parts:
        t.register_post_accumulate_grad_hook(hook(k, i))
    tree = _tree(parts)
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
        total.backward()
    for k, v in flat.items():
        if len(sq[k]) != (v.shape[0] if k.startswith("layers/") else 1):
            raise RuntimeError(f"{k}: {len(sq[k])} gradients written")
    del parts, tree, x, head, nll, total
    return float(loss.detach()), {k: sum(float(s) for s in v) for k, v in sq.items()}


@torch.no_grad()
def _update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v2: torch.Tensor, *,
            scale: float, lr: float, n: int, opt: Dict) -> None:
    """``moe_decoder``'s AdamW update of one leaf ``p`` on its device, in
    place, from host ``g``, ``m`` and ``v2`` (the moments written back),
    a slice of ``CHUNK`` elements at a time."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    decay = p.dim() >= 2
    pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v2))
    for lo in range(0, pf.numel(), CHUNK):
        sl = slice(lo, lo + CHUNK)
        pk = pf[sl]
        gk = gf[sl].to(p.device) * scale
        mk = b1 * mf[sl].to(p.device) + (1 - b1) * gk
        vk = b2 * vf[sl].to(p.device) + (1 - b2) * gk.square()
        step = (mk / (1 - b1 ** n)) / ((vk / (1 - b2 ** n)).sqrt() + eps)
        if decay:
            step = step + opt["weight_decay"] * pk
        pk.copy_(pk - lr * step)
        mf[sl].copy_(mk)
        vf[sl].copy_(vk)


def train_steps(c, flat: Dict[str, torch.Tensor], batches, opt: Dict,
                prec: Precision = FP32, *, rows: Sequence[int] = ()) -> Dict:
    """``moe_decoder.train_steps``: the same AdamW steps from ``flat`` on
    ``batches`` and the same numbers returned, with the weights stepped in
    ``flat``'s own tensors, which hold their first values again on
    return."""
    host = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in flat.items()}
    p0 = {k: v.to("cpu", copy=True) for k, v in flat.items()}
    m = {k: torch.zeros_like(v) for k, v in host.items()}
    v2 = {k: torch.zeros_like(v) for k, v in host.items()}
    losses, gnorms, first, clipped = [], [], {}, {}
    try:
        for n, batch in enumerate(batches, start=1):
            loss, sq = loss_and_grads(c, flat, batch, host, prec, rows=rows)
            losses.append(loss)
            gnorm = math.sqrt(sum(sq.values()))
            gnorms.append(gnorm)
            scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
            if n == 1:
                first = {k: math.sqrt(s) for k, s in sq.items()}
                clipped = {k: v * scale for k, v in first.items()}
            lr = lr_at(opt, n)
            for k, p in flat.items():
                _update(p, host[k], m[k], v2[k], scale=scale, lr=lr, n=n, opt=opt)
        change = {k: float((p - p0[k].to(p.device)).norm()) for k, p in flat.items()}
    finally:
        with torch.no_grad():
            for k, p in flat.items():
                p.copy_(p0[k])
    return {"losses": losses, "gnorms": gnorms, "grad_norms": first, "clipped": clipped,
            "change": change}
