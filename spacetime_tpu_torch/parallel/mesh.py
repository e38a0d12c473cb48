"""The Mesh value: a process group, this process's rank in it, the world
size, and the device its state lives on.

Counterpart of `spacetime_tpu/parallel/mesh.py`.  A JAX mesh is a grid of
devices inside one program; on torch.distributed each rank is a process
with one device, so the Mesh names the group and this process's place in
it.  The group must be initialized first (`multihost.initialize`, or
`torch.distributed.init_process_group`): `make_mesh` never starts one, and
never falls back to another backend or to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1D mesh: `size` ranks of `group`, this process being `rank`, with
    its state on `device` (cuda:LOCAL_RANK under NCCL, the CPU under
    gloo)."""

    group: object  # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The Mesh over the initialized default group: every rank, one device
    each (the NCCL group's current CUDA device, the gloo group's CPU).
    `n_devices`, if given, must be the world size.  Raises RuntimeError
    when no group is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is initialized; call "
            "spacetime_tpu_torch.parallel.multihost.initialize() under torchrun (or "
            "torch.distributed.init_process_group) first")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: requested {n_devices} devices, the group has {size}")
    backend = dist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"make_mesh: backend {backend!r} is not supported (nccl or gloo)")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=device)


def pad_to_multiple(n: int, m: int) -> int:
    """`n` rounded up to a multiple of `m`."""
    return ((n + m - 1) // m) * m
