"""Twin of ``tests/models/test_moe_a2a.py`` on the port: ``moe_ffn_a2a`` in
four gloo processes on a 2 x 2 (``data`` x ``model``) mesh against the
port's ``moe_ffn`` on the whole batch, and against the reference's
``moe_ffn`` on the same numpy inputs.

The reference test's case: B 4, S 8, D 16, E 4 experts of F 32, top-2,
capacity factor 32 (nothing dropped), tokens on (data, model) and experts
on ``model``. Bounds are the reference's: outputs atol 2e-5 rtol 1e-4, the
aux loss rtol 1e-4, the gradient of sum(y^2) + aux with respect to ``wi``
atol 2e-4 rtol 1e-3. The exchange is ``all_to_all_single`` in its autograd
form over the ``model`` process group (gloo). Each process has
``TIMEOUT_S``; past it the test kills them and fails.
"""
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.moe import moe_ffn as jmoe_ffn

TIMEOUT_S = 120
B, S, D, E, F, K, CF = 4, 8, 16, 4, 32, 2, 32.0


def _inputs():
    r = np.random.default_rng(0)
    return {"router": (r.standard_normal((D, E)) * 0.1).astype(np.float32),
            "wi": (r.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            "wg": (r.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            "wo": (r.standard_normal((E, F, D)) * 0.1).astype(np.float32),
            "x": r.standard_normal((B, S, D)).astype(np.float32)}


def _rank(rank: int, store: str, out) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.moe import moe_ffn, moe_ffn_a2a

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        a = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        kw = dict(num_experts=E, top_k=K, capacity_factor=CF)

        def whole(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()], run_check=False)

        wi = a["wi"].clone().requires_grad_(True)
        y_ref, aux_ref = moe_ffn(a["x"], a["router"], wi, a["wg"], a["wo"], groups=1, **kw)
        g_ref, = torch.autograd.grad((y_ref ** 2).sum() + aux_ref, wi)

        wi_d = whole(a["wi"].clone()).requires_grad_(True)
        y, aux = moe_ffn_a2a(whole(a["x"]), whole(a["router"]), wi_d, whole(a["wg"]),
                             whole(a["wo"]), mesh=mesh, batch_axes=("data",),
                             model_axis="model", seq_axis="model", **kw)
        g, = torch.autograd.grad((y ** 2).sum() + aux, wi_d)
        out.put((rank, y.full_tensor().detach().numpy(), float(aux.full_tensor()),
                 g.full_tensor().numpy(), y_ref.detach().numpy(), float(aux_ref),
                 g_ref.numpy()))
    finally:
        dist.destroy_process_group()


def test_moe_a2a_matches_global_dispatch_on_a_gloo_mesh(tmp_path):
    store = str(tmp_path / "store")     # a file rendezvous: no port to race for
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, store, out)) for r in range(4)]
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

    a = _inputs()
    jy, jaux = jmoe_ffn(*(jnp.asarray(a[k]) for k in ("x", "router", "wi", "wg", "wo")),
                        num_experts=E, top_k=K, capacity_factor=CF, groups=1)
    for rank, y, aux, g, y_ref, aux_ref, g_ref in sorted(results, key=lambda r: r[0]):
        np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=1e-4)
        assert aux == pytest.approx(aux_ref, rel=1e-4)
        np.testing.assert_allclose(g, g_ref, atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(y, np.asarray(jy), atol=2e-5, rtol=1e-4)
        assert aux == pytest.approx(float(jaux), rel=1e-4)
