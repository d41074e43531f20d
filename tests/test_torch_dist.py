"""The plan on one device, and the dry-run tooling end to end on the CPU.

* A reduced qwen2-1.5b train step through ``plan_cell`` on a 1 x 1 gloo
  mesh (DTensor state and batch, the plan's constraint points, the
  attention on its shards, the FSDP gathers) gives the unsharded step's
  loss and grad norm in float32 to 1e-5 relative, and its new params to
  1e-6 wherever the gradient is above 1e-3 of its leaf's largest: the
  bounds of ``test_torch_train.py``'s float32 step (not bit for bit:
  DTensor reshapes the products and sums the bias gradients in another
  order, and AdamW's first step is +-lr where a gradient is at rounding
  level). Each new param keeps its placement.
* On that 1 x 1 mesh ``shard_state`` keeps the state's own tensors (no
  copy), and the planned train step of the reduced qwen2-1.5b, hymba-1.5b
  and qwen3-moe-30b-a3b runs no collective at all (DTensor's
  ``CommDebugMode``; one MoE group is split over no axis). The loss is
  the unsharded step's (1e-5 relative).
* ``python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  --mesh pod`` traces the FULL config on a fake world of 256 and writes an
  OK record, which ``roofline`` and ``perf`` render; ``launch.train
  --full`` prints its line.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeCell, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import perf, roofline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import runtime as R
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def _grads(cfg, params, batch):
    leaves = _flat(params)
    ps = {k: t.detach().requires_grad_(True) for k, t in leaves.items()}
    tree = {}
    for path, t in ps.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    total, _ = M.loss_fn(cfg, tree, R.batch_to_device(batch, "cpu"),
                         compute_dtype=torch.float32, ce_chunk=16)
    return dict(zip(ps, torch.autograd.grad(total, list(ps.values()))))


def test_plan_on_one_device_changes_nothing():
    cfg = reduced_config(get_config("qwen2-1.5b"))
    shape = ShapeCell("t", "train", 32, 2)
    opt = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    base = R.CellPlan(cfg, shape, ce_chunk=16, compute_dtype=torch.float32)
    want, wm = R.make_train_step(base, opt)(state, batch)
    mesh = make_host_mesh("cpu")
    try:
        plan = dataclasses.replace(R.plan_cell(cfg, shape, mesh), ce_chunk=16,
                                   compute_dtype=torch.float32)
        assert plan.batch_axes == ("data",) and plan.act.residual == ("data", "model", None)
        state_d = R.shard_state(plan, mesh, state)
        got, gm = R.make_train_step(plan, opt)(state_d, R.shard_batch(plan, mesh, batch))
        assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-5)
        assert gm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-5)
        grads = _grads(cfg, params, batch)
        for path, t in _flat(got["params"]).items():
            assert tuple(t.placements) == tuple(_flat(state_d["params"])[path].placements)
            g = grads[path].abs()
            big = g > 1e-3 * g.max()
            assert torch.allclose(t.full_tensor()[big], _flat(want["params"])[path][big],
                                  rtol=0, atol=1e-6), path
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b", "qwen3-moe-30b-a3b"])
def test_plan_on_one_rank_runs_no_collective(arch):
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = reduced_config(get_config(arch))
    shape = ShapeCell("t", "train", 32, 2)
    opt = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=0, decay_steps=10)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2), 0)
    _, wm = R.make_train_step(R.CellPlan(cfg, shape, ce_chunk=16,
                                         compute_dtype=torch.float32), opt)(state, batch)
    mesh = make_host_mesh("cpu")
    try:
        plan = dataclasses.replace(R.plan_cell(cfg, shape, mesh), ce_chunk=16,
                                   compute_dtype=torch.float32)
        state_d = R.shard_state(plan, mesh, state)
        batch_d = R.shard_batch(plan, mesh, batch)
        for path, t in _flat(state_d["params"]).items():      # the state itself, no copy
            assert t.to_local().data_ptr() == _flat(params)[path].data_ptr(), path
        with CommDebugMode() as comms:
            got, gm = R.make_train_step(plan, opt)(state_d, batch_d)
        assert comms.get_total_counts() == 0, comms.get_comm_counts()
        assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-5)
        for path, t in _flat(got["params"]).items():
            assert tuple(t.placements) == tuple(_flat(state_d["params"])[path].placements)
    finally:
        dist.destroy_process_group()


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_dryrun_full_config_roofline_and_perf(tmp_path):
    out = _run("repro_torch.launch.dryrun", "--arch", "qwen2-1.5b", "--shape", "train_4k",
               "--mesh", "pod", "--out", str(tmp_path))
    assert "[OK  ] qwen2-1.5b" in out and "done: 1 ok, 0 skip, 0 fail / 1" in out
    rec = json.loads((tmp_path / "qwen2-1.5b__train_4k__pod.json").read_text())
    assert rec["ok"] and rec["devices"] == 256 and rec["mesh_shape"] == [16, 16]
    a = rec["analysis"]
    assert a["flops_per_device"] > 0 and a["collective_bytes_per_device"] > 0
    assert a["kernels"]["flash_attention"]["calls"] == 2 * 28   # forward + remat recompute
    assert rec["memory"]["peak_bytes_est"] > rec["memory"]["argument_bytes"] > 0
    table = roofline.markdown("pod", root=str(tmp_path))
    assert "| qwen2-1.5b | train_4k |" in table and "FAIL" not in table
    text = perf.report(perf.load_cell("qwen2-1.5b__train_4k__pod", tmp_path), top=5,
                       fuse_min_elems=1 << 24)
    assert "HBM bytes by scope" in text and "collective wire bytes" in text
    assert "what-if fuse" in text


def test_train_full_prints_its_line():
    out = _run("repro_torch.launch.train", "--arch", "qwen2-1.5b", "--full")
    assert "per device:" in out
    assert out.strip().endswith("full config traced; attach real devices to execute")


def test_planned_decode_on_a_gloo_mesh_matches_one_device():
    """Ten float32 decode steps of the reduced qwen2-1.5b on a 2 x 2 gloo
    mesh (``launch.ranks``' ``decode_f32`` case: batch over ``data``, the
    cache's 16 positions over ``model``: positions 8-15 live on the second
    ``model`` rank, which the eighth step reaches) give the one-device
    logits within 1e-4 and write the same cache."""
    from repro_torch.launch import ranks as RK

    for r in RK.run_ranks(("qwen2-1.5b",), timeout=TIMEOUT_S, mesh="pod",
                          cases=("decode_f32",)):
        assert "error" not in r, (r["rank"], r.get("error"), r.get("trace"))
        c, = r["cells"]
        assert "error" not in c, (c["error"], c["trace"])
        assert c["logit_err"] <= 1e-4 and c["cache_err"] <= 1e-5, (r["rank"], c)


def test_planned_decode_runs_the_lookup_and_the_mamba_step_on_shards(monkeypatch):
    """Queue 3 item 13: torch 2.11's DTensor has no rule for the embedding
    lookup at token ids split over two mesh axes (``("pod", "data")``) and
    cannot add the mamba step's split dt bias to its product's partial
    sums, so a planned decode step runs both on each rank's shards. A
    decode step of the reduced hymba-1.5b traced on a fake (2, 2, 2) mesh
    (fake tensors) looks its tokens up at their batch split and takes
    ``sharded_decode_mixer`` in every layer."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ssm

    seen = {"rows": [], "mixer": 0}
    embed, mixer = M.embed_tokens, ssm.sharded_decode_mixer

    def embed_spy(*args, **kwargs):
        seen["rows"].append(args[3] if len(args) > 3 else kwargs.get("rows"))
        return embed(*args, **kwargs)

    def mixer_spy(*args, **kwargs):
        seen["mixer"] += 1
        return mixer(*args, **kwargs)

    monkeypatch.setattr(M, "embed_tokens", embed_spy)
    monkeypatch.setattr(ssm, "sharded_decode_mixer", mixer_spy)
    cfg = reduced_config(get_config("hymba-1.5b"))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    try:
        plan = R.plan_cell(cfg, ShapeCell("d", "decode", 16, 4), mesh)
        R.trace_cell(plan, mesh)
    finally:
        dist.destroy_process_group()
    assert seen["rows"] == [(("pod", "data"), None)]
    assert seen["mixer"] == cfg.num_layers
