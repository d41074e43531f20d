"""Twins of the reference's per-architecture smoke tests
(``tests/models/test_archs_smoke.py``: ``test_forward_and_train_step``,
``test_loss_decreases_over_steps``) on the port, over all ten configs at
their reduced size on the CPU.

Each starts from the reference's initial weights (``repro.models.model.
init_params``, PRNGKey 0) carried across as numpy, and runs the port's bf16
step builder (``make_train_step`` with ``CellPlan``'s default compute
type). The first step's loss is also held against the reference's
``loss_fn`` on the same weights and batch, in bf16, to 1e-2 relative (the
bound of ``test_torch_train.py``'s bf16 step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced_config
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.bridge import flat_tensors, params_from_numpy
from repro_torch.configs.base import ShapeCell, get_config, list_configs, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import train_batch
from repro_torch.models.runtime import CellPlan, make_train_step
from repro_torch.optim import adamw

ARCHS = list_configs()
B, S = 2, 32


def _state(arch):
    jcfg = jreduced_config(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, {"params": jparams, "opt": jadamw.init_opt_state(jparams)})
    return jcfg, cfg, host


def _batch(cfg, step=0):
    return train_batch(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B),
                       step)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    """One bf16 step: finite loss and grad norm, the step count 1, the
    params moved, and the loss the reference's on the same inputs."""
    jcfg, cfg, host = _state(arch)
    batch = _batch(cfg)
    state = params_from_numpy(host, "cpu")
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", S, B), ce_chunk=16),
                           adamw.AdamWConfig(warmup_steps=2, decay_steps=8))
    new, m = step(state, batch)
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert int(new["opt"]["count"]) == 1
    old, moved = flat_tensors(state["params"]), flat_tensors(new["params"])
    assert any(not torch.equal(old[k], moved[k]) for k in old)
    _, jm = JM.loss_fn(jcfg, host["params"], {k: jnp.asarray(v) for k, v in batch.items()},
                       ce_chunk=16)
    assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases_over_steps(arch):
    """Ten bf16 steps on one batch at lr 1e-2: the last loss is below the
    first."""
    _, cfg, host = _state(arch)
    batch = _batch(cfg)
    state = params_from_numpy(host, "cpu")
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", S, B), ce_chunk=16),
                           adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=1, decay_steps=100))
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(m["loss"])
    assert losses[-1] < losses[0], (arch, losses)
