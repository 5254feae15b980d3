"""Device meshes on ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).  Functions, not module-level constants: merely
importing this module starts no process group.

* ``make_production_mesh``: 256 ranks as (16 data, 16 model), or 2 pods of
  that as (2 pod, 16, 16) = 512 ranks, the JAX package's axis names and
  sizes.  It needs a process group of that world: real ranks, or the dry
  run's fake one (``launch.dryrun.fake_world``).
* ``make_host_mesh``: the (world, 1) mesh over the current group, (1, 1)
  on one device.  Without a process group it starts a one-rank group:
  ``nccl`` on the card, ``gloo`` when the caller asked for the CPU; it
  never falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core import runtime

BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _backend_ok(device: torch.device) -> None:
    got = dist.get_backend()
    want = BACKEND[device.type]
    if got != "fake" and want not in got:
        raise RuntimeError(
            f"the process group runs {got!r}, a mesh on {device.type} needs "
            f"{want!r}")


def _start_local_group(device: Optional[Union[str, torch.device]] = None
                       ) -> None:
    """A one-rank process group on ``device`` (the card unless named) if
    none exists: ``nccl`` for the card, ``gloo`` for the CPU, over an
    in-process store (no address, no port)."""
    device = runtime.resolve_device(device)
    if dist.is_initialized():
        _backend_ok(device)
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(BACKEND[device.type], store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device: Optional[Union[str, torch.device]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the current
    process group, whose world must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    device = runtime.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (torchrun, "
                           "init_process_group) or use make_host_mesh()")
    _backend_ok(device)
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """Single pod: 256 ranks as (16 data, 16 model).  Multi-pod: 2 pods x
    the same in-pod layout = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: Optional[Union[str, torch.device]] = None):
    """The (world, 1) ("data", "model") mesh over the current process
    group: (1, 1) on one device, after starting a one-rank group there if
    none exists (``_start_local_group``)."""
    _start_local_group(device)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)
