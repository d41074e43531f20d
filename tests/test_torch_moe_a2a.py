"""Twin of ``tests/models/test_moe_a2a.py`` on the port: ``moe_ffn_a2a`` in
gloo processes against the port's ``moe_ffn`` on the whole batch, and
against the reference on the same numpy inputs.

The reference test's case: B 4, S 8, D 16, E 4 experts of F 32, top-2,
tokens on (batch axes, ``model``) and experts on ``model``. Bounds are the
reference's: outputs atol 2e-5 rtol 1e-4, the aux loss rtol 1e-4, the
gradient of sum(y^2) + aux with respect to ``wi`` atol 2e-4 rtol 1e-3.
The exchange is ``all_to_all_single`` in its autograd form over the
``model`` process group (gloo). Each process has ``TIMEOUT_S``; past it the
test kills them and fails.

* Capacity factor 32 (nothing dropped) on a 2 x 2 ``data`` x ``model``
  mesh: the a2a against the port's ``moe_ffn`` with one group and the
  reference's ``moe_ffn``.
* Capacity factor 1.25, where tokens drop, on the 2 x 2 mesh (batch over
  ``data``) and on a 2 x 2 x 2 ``pod`` x ``data`` x ``model`` mesh (batch
  over ``("pod", "data")``): the a2a caps each rank's block of tokens,
  ``moe_ffn`` each group, so the yardstick is the reference's
  ``moe_ffn_a2a``, run on the CPU in a subprocess with 8 forced host
  devices as the reference test runs it (capacity 5 a block of 8 tokens on
  the 2 x 2 mesh, 2 a block of 4 on the 2 x 2 x 2 one). The drops happen:
  the test counts the slots the reference's dispatch drops.
"""
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.moe import moe_ffn as jmoe_ffn

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
B, S, D, E, F, K, CF = 4, 8, 16, 4, 32, 2, 32.0
DROP_CF = 1.25
MESHES = {"pod": ((2, 2), ("data", "model"), ("data",)),
          "multipod": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))}


def _inputs():
    r = np.random.default_rng(0)
    return {"router": (r.standard_normal((D, E)) * 0.1).astype(np.float32),
            "wi": (r.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            "wg": (r.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            "wo": (r.standard_normal((E, F, D)) * 0.1).astype(np.float32),
            "x": r.standard_normal((B, S, D)).astype(np.float32)}


def _rank(rank: int, store: str, mesh_name: str, cf: float, out) -> None:
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.moe import moe_ffn, moe_ffn_a2a

    shape, axes, batch_axes = MESHES[mesh_name]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        a = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        kw = dict(num_experts=E, top_k=K, capacity_factor=cf)

        def whole(t):
            return DTensor.from_local(t, mesh, [Replicate()] * len(shape), run_check=False)

        wi = a["wi"].clone().requires_grad_(True)
        y_ref, aux_ref = moe_ffn(a["x"], a["router"], wi, a["wg"], a["wo"], groups=1, **kw)
        g_ref, = torch.autograd.grad((y_ref ** 2).sum() + aux_ref, wi)

        wi_d = whole(a["wi"].clone()).requires_grad_(True)
        y, aux = moe_ffn_a2a(whole(a["x"]), whole(a["router"]), wi_d, whole(a["wg"]),
                             whole(a["wo"]), mesh=mesh, batch_axes=batch_axes,
                             model_axis="model", seq_axis="model", **kw)
        g, = torch.autograd.grad((y ** 2).sum() + aux, wi_d)
        out.put((rank, y.full_tensor().detach().numpy(), float(aux.full_tensor()),
                 g.full_tensor().numpy(), y_ref.detach().numpy(), float(aux_ref),
                 g_ref.numpy()))
    finally:
        dist.destroy_process_group()


def _run_ranks(tmp_path, mesh_name: str, cf: float):
    import math

    world = math.prod(MESHES[mesh_name][0])
    store = str(tmp_path / f"store_{mesh_name}")     # a file rendezvous: no port to race for
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, store, mesh_name, cf, out))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = [out.get(timeout=TIMEOUT_S) for _ in procs]
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return sorted(results, key=lambda r: r[0])


def test_moe_a2a_matches_global_dispatch_on_a_gloo_mesh(tmp_path):
    results = _run_ranks(tmp_path, "pod", CF)
    a = _inputs()
    jy, jaux = jmoe_ffn(*(jnp.asarray(a[k]) for k in ("x", "router", "wi", "wg", "wo")),
                        num_experts=E, top_k=K, capacity_factor=CF, groups=1)
    for rank, y, aux, g, y_ref, aux_ref, g_ref in results:
        np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=1e-4)
        assert aux == pytest.approx(aux_ref, rel=1e-4)
        np.testing.assert_allclose(g, g_ref, atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(y, np.asarray(jy), atol=2e-5, rtol=1e-4)
        assert aux == pytest.approx(float(jaux), rel=1e-4)


# the reference's moe_ffn_a2a on 8 forced host devices, both meshes (the
# pod one on the first 4), its mesh built as tests/models/test_moe_a2a.py
# builds it; inputs and outputs through .npz files
REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.moe import moe_ffn_a2a

    cfg = json.loads(sys.argv[1])
    a = dict(np.load(cfg["inputs"]))
    E, k, cf = cfg["E"], cfg["K"], cfg["cf"]
    res = {}
    for name, (shape, axes, batch_axes) in cfg["meshes"].items():
        n = int(np.prod(shape))
        if hasattr(jax.sharding, "AxisType"):
            mesh = jax.make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:n],
                                 axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
            use_mesh = lambda: jax.set_mesh(mesh)
        else:
            mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
            use_mesh = lambda: mesh
        fn = lambda *args: moe_ffn_a2a(*args, num_experts=E, top_k=k, capacity_factor=cf,
                                       mesh=mesh, batch_axes=tuple(batch_axes),
                                       model_axis="model", seq_axis="model")
        args = [jnp.asarray(a[key]) for key in ("x", "router", "wi", "wg", "wo")]

        def loss(w):
            y, aux = fn(args[0], args[1], w, args[3], args[4])
            return jnp.sum(y ** 2) + aux
        with use_mesh():
            y, aux = jax.jit(fn)(*args)
            g = jax.jit(jax.grad(loss))(args[2])
        res[name + "_y"], res[name + "_aux"], res[name + "_g"] = y, aux, g
    np.savez(cfg["out"], **{key: np.asarray(v) for key, v in res.items()})
""")


@pytest.fixture(scope="module")
def reference_drops(tmp_path_factory):
    """The reference's ``moe_ffn_a2a`` outputs at ``DROP_CF`` on both
    meshes: {mesh: (y, aux, grad wi)}."""
    tmp = tmp_path_factory.mktemp("a2a_ref")
    np.savez(tmp / "inputs.npz", **_inputs())
    cfg = {"inputs": str(tmp / "inputs.npz"), "out": str(tmp / "out.npz"), "E": E, "K": K,
           "cf": DROP_CF, "meshes": MESHES}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(cfg)],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = np.load(tmp / "out.npz")
    return {m: (out[m + "_y"], float(out[m + "_aux"]), out[m + "_g"]) for m in MESHES}


def _dropped_slots(mesh_name: str) -> int:
    """Slots past their expert's capacity in the reference's dispatch: each
    (batch shard x sequence shard) block of tokens routed on its own, in
    the a2a's token order, at the a2a's capacity."""
    from repro.models.moe import top_k_routing

    shape, axes, batch_axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    nb = int(np.prod([sizes[ax] for ax in batch_axes]))
    nm = sizes["model"]
    a = _inputs()
    bl, sl = B // nb, S // nm
    cap = max(1, int(DROP_CF * bl * sl * K / E))
    dropped = 0
    for i in range(nb):
        for j in range(nm):
            xf = a["x"][i * bl:(i + 1) * bl, j * sl:(j + 1) * sl].reshape(-1, D)
            _, ids = top_k_routing(jnp.asarray(xf) @ jnp.asarray(a["router"]), K)
            counts = np.bincount(np.asarray(ids).reshape(-1), minlength=E)
            dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_moe_a2a_with_drops_matches_reference_a2a(mesh_name, reference_drops, tmp_path):
    assert _dropped_slots(mesh_name) > 0
    jy, jaux, jg = reference_drops[mesh_name]
    for rank, y, aux, g, *_ in _run_ranks(tmp_path, mesh_name, DROP_CF):
        np.testing.assert_allclose(y, jy, atol=2e-5, rtol=1e-4)
        assert aux == pytest.approx(jaux, rel=1e-4)
        np.testing.assert_allclose(g, jg, atol=2e-4, rtol=1e-3)
