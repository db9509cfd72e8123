"""Mesh definitions. Counterpart of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
device and starts no process group. The production meshes are
``MeshShape``s (sizes and names, no devices: what the dry-run prices);
the host mesh is a real ``DeviceMesh`` over this process's devices. The
reference's TPU roofline constants are not carried over: the port prices
with the H100's (``repro_torch/roofline.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _ensure_group(device_type: str) -> None:
    """A world-size-1 process group if none exists: ``nccl`` for CUDA,
    ``gloo`` for the CPU, on an in-memory ``HashStore`` (no TCP port, so
    concurrent test workers cannot collide). A group that already exists
    (a multi-process launch) is used as it is."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(*, data: int = 1, model: int = 1, device: str | None = None):
    """A ("data", "model") ``DeviceMesh`` over the process group's devices
    (one process a device). ``device``: "cuda" (None: the GPU) or "cpu".
    Asking for more devices than the group has gives (world, 1), as the
    reference's host mesh falls back to (devices, 1)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = torch.device("cuda" if device is None else device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to build a CPU mesh")
    _ensure_group(device_type)
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def chips(mesh) -> int:
    """The devices of a ``MeshShape`` or a ``DeviceMesh``."""
    return mesh.size if isinstance(mesh, MeshShape) else mesh.size()
