"""``launch.cost_analysis`` and the dry run against the JAX package's
``launch.hlo_analysis``.

* Twins of ``tests/test_hlo_analysis.py``: the FLOPs of a product and of
  one SwiGLU layer's products are 2 M N K exactly; an L-layer forward
  counts L times one layer's (within 1%; eager PyTorch has no while loop
  whose trip count needs correcting, so this holds the counter to the
  layers it sees); the collective formulas on a fake world of 32 ranks in
  groups of 8 give the reference's size 7/8 + 2 size 7/8 for an all-gather
  and an all-reduce; ``roofline.model_flops`` is 6 N D with N
  ``cfg.param_count()``.
* Cost against the reference: reduced qwen2-1.5b, hymba-1.5b and
  qwen3-moe-30b-a3b, train, prefill and decode cells at B 4, S 64 on a
  2 x 2 mesh. The reference runs ``plan_cell`` -> ``lower_cell`` ->
  ``compile`` -> ``hlo_analysis`` in a subprocess with 4 forced host
  devices, as ``tests/models/test_moe_a2a.py`` does; the port runs
  ``dryrun.trace_record`` on a fake world of 4. The port's per-device
  product FLOPs with the attention and scan counted as their plain
  versions compute them (``plain_flops_per_device``, what the reference's
  ``attention_xla`` and XLA scan compare with) are within 15% of the
  reference's dot FLOPs (``hlo_analysis._dot_flops`` summed, while bodies
  scaled by their trip counts), the tolerance the reference allows between
  its count and XLA's. Both packages' collective bytes and counts are
  printed, not bounded: GSPMD and DTensor choose different exchanges.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES_BY_NAME, ShapeCell, get_config, list_configs,
                                      reduced_config)
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch, kind) for arch in ("qwen2-1.5b", "hymba-1.5b", "qwen3-moe-30b-a3b")
         for kind in ("train", "prefill", "decode")]
FLOP_TOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def _no_world_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_product_flops_exact():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    with ca.CostMode() as cost:
        a @ b
    assert cost.flops == 2 * 64 * 128 * 32


def test_one_layer_products_exact():
    """SwiGLU on (B 2, S 8, D 16) with F 40: three products."""
    x = torch.zeros(2, 8, 16)
    wi, wg, wo = torch.zeros(16, 40), torch.zeros(16, 40), torch.zeros(40, 16)
    with ca.CostMode() as cost:
        L.swiglu_mlp(x, wi, wg, wo)
    assert cost.flops == 3 * 2 * (2 * 8) * 16 * 40


def test_l_layers_count_l_times_one():
    def count(n):
        cfg = reduced_config(get_config("qwen2-1.5b"), num_layers=n)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.zeros(2, 32, dtype=torch.long)
        with torch.no_grad(), ca.CostMode() as cost:
            M.forward_hidden(cfg, params, tokens, compute_dtype=torch.float32)
        return cost.flops

    one, eight = count(1), count(8)
    assert one > 0 and abs(eight - 8 * one) <= 0.01 * 8 * one


def test_collective_formulas_on_a_fake_world():
    import torch.distributed._functional_collectives as funcol

    mesh = make_mesh((4, 8), ("data", "model"))
    group = mesh.get_group("model")
    size = 64 * 64 * 4
    with ca.CostMode() as cost:
        g = funcol.wait_tensor(funcol.all_gather_tensor(torch.zeros(8, 64), 0, group))
        funcol.wait_tensor(funcol.all_reduce(g, "sum", group))
    assert cost.collective_bytes == pytest.approx(size * 7 / 8 + 2 * size * 7 / 8, abs=1)
    assert dict(cost.collective_counts) == {"all-gather": 1, "all-reduce": 1}
    assert ca.wire_bytes("reduce-scatter", size / 8, 8) == size * 7 / 8
    assert ca.wire_bytes("all-to-all", size, 8) == size * 7 / 8


@pytest.mark.parametrize("S,window", [(1, 0), (64, 0), (64, 16), (64, 64), (64, 100), (37, 5)])
def test_attended_pairs_counts_the_mask(S, window):
    """The kernels' formula counts the (query, key) pairs the plain
    attention's mask keeps."""
    from repro_torch.models.attention import _mask_bias

    pos = torch.arange(S)
    kept = int((_mask_bias(pos, pos, causal=True, window=window, kv_len=None) == 0).sum())
    assert L.attended_pairs(S, window) == kept


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_is_6nd(arch):
    cfg = get_config(arch)
    rec = {"shape": "train_4k", "model_params": cfg.param_count(),
           "model_params_active": cfg.active_param_count()}
    n = cfg.active_param_count()
    assert roofline.model_flops(rec) == 6.0 * n * roofline.TOKENS["train_4k"]
    if not cfg.is_moe:
        assert n == cfg.param_count()


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json, re
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    from repro.configs.base import ShapeCell, get_config, reduced_config
    from repro.launch import hlo_analysis as H
    from repro.launch.mesh import _make_mesh
    from repro.models import runtime

    def dot_flops(model, name):
        comp = model.comps.get(name)
        if comp is None:
            return 0
        table = {op.name: op.result_type for op in comp.ops.values()}
        total = 0
        for opn in comp.order:
            op = comp.ops[opn]
            if op.opcode == "while":
                body = re.search(r"body=%?([\\w.\\-]+)", op.line)
                cond = re.search(r"condition=%?([\\w.\\-]+)", op.line)
                trips = (H._trip_count(model.comps[cond.group(1)])
                         if cond and cond.group(1) in model.comps else 1)
                total += trips * dot_flops(model, body.group(1)) if body else 0
            elif op.opcode in ("call", "async-start", "fusion"):
                m = re.search(r"(?:to_apply|calls)=%?([\\w.\\-]+)", op.line)
                total += dot_flops(model, m.group(1)) if m else 0
            elif op.opcode == "conditional":
                br = re.findall(r"branch_computations=\\{([^}]*)\\}", op.line)
                names = H._OPERAND_RE.findall(br[0]) if br else []
                total += dot_flops(model, names[0]) if names else 0
            elif op.opcode in ("dot", "convolution"):
                total += H._dot_flops(op, table)
        return total

    mesh = _make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, kind in json.loads(sys.argv[1]):
        plan = runtime.plan_cell(reduced_config(get_config(arch)), ShapeCell("t", kind, 64, 4),
                                 mesh)
        text = runtime.lower_cell(plan, mesh).compile().as_text()
        ana = H.analyze_text(text)
        model = H.HloCostModel(text)
        ana["dot_flops_per_device"] = dot_flops(model, model.entry)
        out[f"{arch}/{kind}"] = ana
    print("REF_JSON " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_costs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(CELLS)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    line = next((l for l in res.stdout.splitlines() if l.startswith("REF_JSON ")), None)
    assert line, res.stderr[-3000:]
    return json.loads(line[len("REF_JSON "):])


@pytest.fixture(scope="module")
def port_costs():
    from repro_torch.launch import dryrun

    mesh = make_mesh((2, 2), ("data", "model"))
    return {f"{arch}/{kind}": dryrun.trace_record(reduced_config(get_config(arch)),
                                                  ShapeCell("t", kind, 64, 4), mesh)
            for arch, kind in CELLS}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_product_flops_match_reference(arch, kind, reference_costs, port_costs):
    ref = reference_costs[f"{arch}/{kind}"]
    port = port_costs[f"{arch}/{kind}"]["analysis"]
    want, got = ref["dot_flops_per_device"], port["plain_flops_per_device"]
    print(f"{arch} {kind}: FLOPs/device port {got} (kernels by formula "
          f"{port['flops_per_device']}) reference dots {want}; collective bytes/device "
          f"port {port['collective_bytes_per_device']:.0f} {port['collective_counts']} "
          f"reference {ref['collective_bytes_per_device']:.0f} {ref['collective_counts']}")
    assert abs(got - want) <= FLOP_TOL * want, (got, want)
