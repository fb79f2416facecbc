"""Device meshes of the port (``repro.launch.mesh`` over ``torch.distributed``).

Functions, not module constants: importing this module touches no process
group.  The production geometry is the reference's, so its specs compare one
for one:

  single-pod : (16, 16)    axes ("data", "model")          = 256 devices
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   = 512 devices

"model" is the tensor-parallel axis, the paper's instance granularity (one
tensor-parallel group serves one replica); "data" and "pod" enumerate
instances and batch shards.  ``make_host_mesh`` spans the ranks that exist.
``fake_process_group`` stands up a process group of any world size inside
one process (torch's fake backend, whose collectives move nothing): the
dry-run's counterpart of the reference's 512 placeholder host devices.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _device_type() -> str:
    return "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"


def _init_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the initialised process group, whose world
    must be the mesh's 256 (512 multi-pod) ranks."""
    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh {shape} needs a "
            f"world of {need} ranks, got {world}")
    return _init_mesh(shape, axes)


def make_host_mesh(model: int | None = None):
    """A (world // model, model) ("data", "model") mesh over the ranks that
    exist (default model = 1: data parallel)."""
    world = torch.distributed.get_world_size()
    model = model or 1
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide the world of {world} ranks")
    return _init_mesh((world // model, model), ("data", "model"))


def init_process_group(device: str | torch.device) -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or start a one-rank
    group on a free localhost port when none is described: NCCL on
    ``cuda``, gloo on ``cpu``.  Returns False where a group was already up."""
    if torch.distributed.is_initialized():
        return False
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        torch.distributed.init_process_group(backend)
        return True
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    return True


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """A process group of ``world_size`` ranks inside this process, seen as
    ``rank``; the fake backend's collectives move no data.  Torn down at the
    block's end."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=rank,
                                         world_size=world_size)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()

