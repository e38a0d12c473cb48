"""The collectives of the sharded frame, on a mesh's process group.

Each takes and returns tensors on the mesh's device and blocks the
calling stream (or, on the CPU, the caller) until its result is there; on
CUDA they are captured into the fused frame's graphs with the rest of the
stage.  The torch.distributed function is looked up at each call, so a
wrapper installed around it (as the tests' collective counter is) sees
every call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_fn():
    # torch 2.13 deprecates all_gather_into_tensor (a FutureWarning at every
    # call) for all_gather_single; torch 2.11 has only the old name
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _scatter_fn():
    # likewise reduce_scatter_tensor and reduce_scatter_single
    return getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `x` (equal shapes), concatenated on dim 0 in rank
    order."""
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather_fn()(out, x, group=mesh.group)
    return out


def reduce_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of `x` ((size * B, ...)), this rank's block
    of B rows."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _scatter_fn()(out, x, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """`x` reduced over the ranks ("sum" or "min"), in place; returns `x`."""
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(x, op=red, group=mesh.group)
    return x


def block(n: int, rank: int, size: int) -> tuple:
    """(first, count) of rank `rank`'s share of `n` rows split into
    ceil(n / size) rows a rank in rank order (the last shares may be
    shorter, or empty)."""
    per = -(-n // size)
    first = min(rank * per, n)
    return first, min(per, n - first)
