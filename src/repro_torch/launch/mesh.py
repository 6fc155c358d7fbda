"""Process group and mesh factories.

The counterpart of ``repro/launch/mesh.py``, on ``torch.distributed``.
Functions, not module-level state, so importing this module starts no
process group.  Single pod: 16x16 = 256 ranks, axes (data, model).
Multi-pod: 2x16x16 = 512 ranks, axes (pod, data, model): ``pod`` is a
second data-parallel axis whose gradient all-reduce crosses pods; nothing
else communicates across them.

``init_distributed`` starts the default group from the ``torchrun``
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on ``cuda``, gloo on ``cpu``.  A process that no
launcher started gets a one-rank group on a free localhost port, so a
plain ``python -m`` run takes the same path.  ``init_fake`` starts the
dry-run's fake group: N ranks in one process, no communication.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.common import ambient_mesh


def launched() -> bool:
    """True when a launcher (``torchrun``) started this process."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device: str | torch.device = "cuda") -> None:
    """Start the default process group (no-op when one is running)."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if launched():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)


def init_fake(world: int) -> None:
    """The dry-run's group: ``world`` ranks that this process stands for
    (it is rank 0); collectives move no data."""
    # registers the "fake" backend with c10d
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


def _mesh(device_type: str, shape: tuple, axes: tuple) -> DeviceMesh:
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} {axes} mesh needs {math.prod(shape)} "
                         f"ranks; this process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model_axis: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the process group as (data, model)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"--model-axis {model_axis} does not divide the "
                         f"{n} ranks")
    return _mesh(device_type, (n // model_axis, model_axis),
                 ("data", "model"))


def use_mesh(mesh: DeviceMesh):
    """Context manager: ``mesh`` is the ambient mesh inside the block
    (``models.common.current_mesh``)."""
    return ambient_mesh(mesh)


__all__ = ["init_distributed", "init_fake", "launched", "make_host_mesh",
           "make_production_mesh", "use_mesh"]
