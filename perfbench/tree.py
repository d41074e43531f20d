"""Parameter trees as the port keeps them (nested dicts) and as flat
{"a/b/c": tensor} maps, in the port's leaf naming (sorted paths)."""
from __future__ import annotations

from typing import Dict

import torch


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b/c": t} -> {"a": {"b": {"c": t}}}."""
    tree: Dict = {}
    for name, t in flat.items():
        node = tree
        *path, last = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``nest``, in sorted order."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
