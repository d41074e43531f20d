"""Production mesh definitions and the H100 constants of the roofline.

The port of ``repro.launch.mesh``. The meshes keep the reference's shapes
and axis names, so the port's dry-run cells line up one for one with the
reference's: a pod is (16, 16) ``data`` x ``model``, two pods (2, 16, 16)
``pod`` x ``data`` x ``model``. They are ``DeviceMesh``es over a process
group of that many ranks; when no such world exists the group is
``torch.distributed``'s ``fake`` backend, whose collectives move nothing,
with this process as rank 0, for tracing (``launch.dryrun``). Functions,
not module-level constants: importing this module starts no process group.

Hardware constants: NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU
datasheet (dense rates, no sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3,
80 GB of HBM, NVLink 4 at 900 GB/s a GPU (both directions together), and
one 400 Gb/s InfiniBand NDR link a GPU between nodes.

A collective's time takes the slowest link its axis crosses. An NVLink node
holds 8 GPUs and the mesh is laid out ``model`` fastest, so a ``model`` axis
of at most 8 stays inside a node, and a 16-wide one, as in the production
meshes, crosses nodes: every ``model`` collective then runs at the
InfiniBand rate, and so does every ``data`` and ``pod`` collective (their
ranks are a node or more apart). That is where this roofline differs most
from the reference's, which gives every TPU v5e axis one ICI figure.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12        # per GPU, dense
HBM_BW = 3.35e12                # bytes/s per GPU
HBM_BYTES = 80e9                # per GPU
NVLINK_BW = 900e9               # bytes/s per GPU, both directions together
IB_BW = 400e9 / 8               # bytes/s per GPU: one 400 Gb/s NDR link
GPUS_PER_NODE = 8

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


def axis_bandwidth(axis: str, sizes: Dict[str, int]) -> float:
    """Bytes/s of a collective over mesh axis ``axis`` of a mesh with axis
    sizes ``sizes`` (``model`` fastest): NVLink when the axis's ranks share
    a node, else InfiniBand."""
    inner = 1
    for name in reversed(list(sizes)):
        inner *= sizes[name]
        if name == axis:
            break
    return NVLINK_BW if inner <= GPUS_PER_NODE else IB_BW


def collective_bandwidth(sizes: Dict[str, int]) -> float:
    """The rate the roofline gives the step's collective bytes: the slowest
    link any axis of more than one rank crosses."""
    rates = [axis_bandwidth(a, sizes) for a, n in sizes.items() if n > 1]
    return min(rates) if rates else NVLINK_BW


def _world(n: int) -> None:
    """A default process group of ``n`` ranks: the one there is when its
    size is ``n``; else, replacing a fake one, the ``fake`` backend with
    this process as rank 0."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; "
                               f"the mesh needs {n}")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A CPU ``DeviceMesh`` of ``shape`` named ``axes`` over a world of its
    size (``_world``), for tracing."""
    import math

    from torch.distributed.device_mesh import init_device_mesh

    _world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 GPUs per pod; 2 pods = 512 when ``multi_pod``."""
    if multi_pod:
        return make_mesh(MULTIPOD_SHAPE, MULTIPOD_AXES)
    return make_mesh(POD_SHAPE, POD_AXES)


def make_host_mesh(device: str = "cuda"):
    """A 1x1 ``data`` x ``model`` mesh over the real local device, on a
    process group of one rank (NCCL for "cuda", gloo for "cpu") at
    ``tcp://localhost:<a free port>``, created unless one of one rank
    exists."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=POD_AXES)
