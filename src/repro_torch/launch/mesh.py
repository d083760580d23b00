"""Mesh builders.

Counterpart of ``repro/launch/mesh.py``. Functions, not module-level
constants: importing this module starts no process group.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.kernels.common import resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 dual-pod (512 ranks)
    ``DeviceMesh`` over the process group, which must have that many
    ranks (the dry run's is a fake group of placeholder ranks).

    Axes: ``data`` carries FSDP + data parallelism, ``model`` carries
    tensor/expert parallelism, ``pod`` (multi-pod only) is an outer
    data-parallel axis whose collectives ride the inter-pod network.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device: Any = "cuda"):
    """A ``(world, 1)`` ``("data", "model")`` ``DeviceMesh`` over the
    process group: one rank a device.

    When no group exists this process starts one of world size 1: nccl
    for ``cuda``, gloo for ``cpu``, its rendezvous a ``FileStore`` in a
    new temporary directory (no network port). ``cuda`` raises without a
    CUDA device, and on a group whose backend is not nccl."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
        dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)
    if dev.type == "cuda":
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"a cuda mesh needs an nccl group, not {dist.get_backend()!r}")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (n, 1), mesh_dim_names=("data", "model"))
