"""The one generator of the benchmark's traffic: it reads a mix's
parameters (a file under ``mixes/``) and makes each unit of work from the
run seed, on the run's device.

A training mix gives ``batch`` rows of ``seq_len`` tokens a step, each
step's rows new; a serving mix gives requests of ``batch`` prompts of
``prompt_len`` tokens, one client at a time. Token ids are uniform over
the configuration's vocabulary. Step or request ``i`` of seed ``s`` is the same in every run
and differs from every other; set-up's warm-up requests take negative
``i``.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.seeds import substream


def _tokens(shape, vocab: int, seed: int, stream: str, i: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(substream(seed, stream, i))
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def train_batch(c: Dict, mix: Dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Step ``i``'s batch: tokens, the next tokens as labels, mask of ones."""
    B, S = mix["batch"], mix["seq_len"]
    ids = _tokens((B, S + 1), c["vocab_size"], seed, "train", i, device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:],
            "mask": torch.ones((B, S), dtype=torch.float32, device=device)}


def request(c: Dict, mix: Dict, seed: int, i: int, device) -> torch.Tensor:
    """Request ``i``'s prompts, (batch, prompt_len) token ids."""
    return _tokens((mix["batch"], mix["prompt_len"]), c["vocab_size"], seed, "serve", i, device)
