"""Joining the processes of a run: torchrun's environment to a process
group, and the host-side helpers of a multi-process run.

Counterpart of `spacetime_tpu/parallel/multihost.py`, whose launcher
(`tools/launch_multihost.py`) torchrun replaces: torchrun starts one
process per GPU and sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK in each.  A script calls `initialize()` first, then builds its
Mesh (`mesh.make_mesh()`) and runs `Engine(config, mesh=mesh)`; every rank
builds the same scene (it is deterministic) and keeps its block
(`host_state`), and host-side consumers take whole arrays with
`allgather`.  Started without torchrun's variables, `initialize` does
nothing and the process runs alone.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from . import comm, sharding
from .mesh import Mesh

# a hung rendezvous or collective raises after this long instead of waiting
# forever
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(device=None, timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join this process into the group torchrun's environment describes:
    NCCL with this rank on cuda:LOCAL_RANK, or gloo when `device` is "cpu"
    (`device` None means CUDA, and raises without it, as every entry point
    does).  Returns False, doing nothing, when RANK or WORLD_SIZE is
    absent; True once the group is up (or was already)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = int(os.environ["MASTER_PORT"])
    init = f"tcp://{addr}:{port}"
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=size,
                                timeout=timeout)
        return True
    dev = device_mod.resolve(device)
    local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", init_method=init, rank=rank, world_size=size,
                            timeout=timeout, device_id=torch.device("cuda", local))
    return True


def is_multiprocess() -> bool:
    """Whether this process is one of several in an initialized group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_state(particles, buf, mesh: Mesh):
    """This rank's block of state that every rank built the same (a
    deterministic scene build): `sharding.shard_state`."""
    return sharding.shard_state(particles, buf, mesh)


def allgather(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Every rank's `x` (equal shapes) concatenated on dim 0, on every
    rank's host: for host-side consumers of sharded arrays."""
    return comm.all_gather(x, mesh).cpu().numpy()


def sync(mesh: Mesh | None = None) -> None:
    """A barrier across the ranks (before teardown, between phases); a
    no-op in a single process."""
    if dist.is_initialized():
        dist.barrier(group=None if mesh is None else mesh.group)


def shutdown() -> None:
    """Destroy the process group, if one is up.  Drop every mesh Engine
    first: NCCL's teardown waits for the CUDA graphs that captured its
    collectives (an Engine's fused frames) to be destroyed, so a group
    destroyed under a live one never returns."""
    if dist.is_initialized():
        dist.destroy_process_group()
