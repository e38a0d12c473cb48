"""Collision forces: the per-step cell sort, the CUDA kernel's wrapper
(`csrc/collision.cu`) and its plain-torch version.

Replaces `spacetime_tpu/ops/forces_pallas.py` (`_collision_kernel`,
`build_sorted_order`, `collision_forces_pallas`).  Once per step,
`build_cell_order` stable-sorts the particles by flat halo cell id and
builds a dense `[start, end)` table over all (bdim + 2)^2 cells by one
`searchsorted`; the kernel then scans exact sorted ranges, so no window is
ever truncated.  Each particle's scan covers the cells within the
collision distance plus the per-axis displacement since the cells were
built (see csrc/collision.cu), so its candidate set is exact at every RK4
stage.  The TPU-only machinery — the sort-as-permutation, the
128-element alignment, `chunk_sub`, `split_windows`, the BIGPOS overscan —
does not carry over: gathers and scatters on the card are plain indexing.

Two variants, as the TPU kernel's `exclude_bonds` flag has:

  * include (`neighbors=None`): bonded pairs stay in the sum and the caller
    subtracts them (`forces.bonded_repulsion_shifted`), the lattice-padded
    scenes' path;
  * exclude (`neighbors` given): the kernel drops j = i and j in
    neighbors[i, 0..7] itself, the path of scenes without spring offsets.

Both versions can cover a range of sorted rows, `rows` = (first,
count): on a mesh (parallel/) each rank launches the kernel over its share
of the sorted order only (the TPU kernel's tile grid split across chips),
writing the forces of those rows' particles into an otherwise zero (N, 2)
buffer, which one reduce-scatter sums to each particle's owner: exact,
since each particle has one nonzero contributor.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

PLAIN_CHUNK = 1024  # rows of the plain version's all-pairs block


class CellOrder(NamedTuple):
    """Particles sorted by flat halo cell id (fixed for one step)."""

    sorted_idx: torch.Tensor  # (N,) i32 particle index per sorted row
    sorted_cell: torch.Tensor  # (N,) i32 cell id per sorted row (n_cells = inactive)
    cell_start: torch.Tensor  # (n_cells + 1,) i32 first sorted row of each cell
    origin: torch.Tensor  # (2,) f32 grid origin the cell ids were computed from
    n_cells: int
    side: int  # cells per grid row (grid_dim + 2)
    bin_resolution: float  # cell edge, lightseconds


def build_cell_order(cell: torch.Tensor, origin: torch.Tensor, n_cells: int, side: int,
                     bin_resolution: float) -> CellOrder:
    """Stable sort by cell id plus the dense per-cell start table; `cell`
    and `origin` are what grid.cell_ids returns.  Empty cells start where
    the next cell does, so cells [a, b] span the sorted rows
    [cell_start[a], cell_start[b + 1]); cell_start[n_cells] counts the
    active particles."""
    sorted_cell, perm = torch.sort(cell, stable=True)
    queries = torch.arange(n_cells + 1, dtype=sorted_cell.dtype, device=cell.device)
    cell_start = torch.searchsorted(sorted_cell, queries, out_int32=True)
    return CellOrder(
        sorted_idx=perm.to(torch.int32),
        sorted_cell=sorted_cell,
        cell_start=cell_start,
        origin=origin,
        n_cells=n_cells,
        side=side,
        bin_resolution=bin_resolution,
    )


def collision_forces_plain(pos: torch.Tensor, active: torch.Tensor,
                           collision_distance: float, repulsion: float,
                           neighbors: torch.Tensor | None = None,
                           which: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked brute force over all active pairs with the kernel's test and
    per-pair term — exact by construction.  Bonded pairs are included,
    unless `neighbors` is given: then j = i and j in neighbors[i] are
    excluded, as the exclude variant does.  With `which` (particle
    indices) only those particles' forces are computed, the other rows
    left 0."""
    n = pos.shape[0]
    cd2 = collision_distance * collision_distance
    px, py = pos[:, 0], pos[:, 1]
    ids = torch.arange(n, device=pos.device)
    if which is None:
        which = ids
    out = torch.zeros_like(pos)
    for a in range(0, which.shape[0], PLAIN_CHUNK):
        i = which[a:a + PLAIN_CHUNK].long()
        dx = px[i, None] - px[None, :]
        dy = py[i, None] - py[None, :]
        dist2 = dx * dx + dy * dy
        hit = (dist2 < cd2) & (dist2 > 0.0) & active[None, :] & active[i, None]
        if neighbors is not None:
            hit = hit & (ids[None, :] != i[:, None])
            for s in range(neighbors.shape[1]):
                hit = hit & (ids[None, :] != neighbors[i, s, None])
        mag = torch.where(hit, repulsion * torch.rsqrt(torch.clamp(dist2, min=1e-20)), 0.0)
        out[i, 0] = torch.sum(mag * dx, dim=1)
        out[i, 1] = torch.sum(mag * dy, dim=1)
    return out


def collision_forces(pos: torch.Tensor, active: torch.Tensor, order: CellOrder,
                     collision_distance: float, repulsion: float,
                     disp: torch.Tensor,
                     neighbors: torch.Tensor | None = None,
                     rows: tuple | None = None) -> torch.Tensor:
    """(N, 2) collision forces: bonded pairs included, or excluded with
    self pairs when `neighbors` ((N, 8) i32) is given.  `order` was built
    from earlier positions; `disp` ((2,) f32 on the device) bounds how far
    any active particle moved along x and along y since, so the kernel
    widens its scan to keep the candidate set exact.  With `rows` =
    (first, count) only the particles of the sorted rows [first, first +
    count) get their forces, the other rows 0.  CPU tensors take the plain
    version; CUDA tensors launch `collision_forces_launch`, or
    `collision_forces_exclude_launch` with `neighbors`."""
    n = pos.shape[0]
    row0, count = (0, n) if rows is None else rows
    if not (0 <= row0 <= n and 0 <= count <= n - row0):
        raise ValueError(f"collision_forces: sorted rows [{row0}, {row0 + count}) outside "
                         f"[0, {n})")
    if pos.device.type == "cpu":
        which = None if rows is None else order.sorted_idx[row0:row0 + count]
        return collision_forces_plain(pos, active, collision_distance, repulsion, neighbors,
                                      which)
    if pos.device.type != "cuda":
        raise ValueError(f"collision_forces: unsupported device {pos.device}")
    if pos.dtype != torch.float32 or pos.shape != (n, 2) or not pos.is_contiguous():
        raise ValueError("collision_forces: pos must be contiguous (N, 2) float32")
    for name, t in (("sorted_idx", order.sorted_idx), ("sorted_cell", order.sorted_cell),
                    ("cell_start", order.cell_start)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != pos.device:
            raise ValueError(f"collision_forces: {name} must be contiguous int32 on {pos.device}")
    if order.sorted_idx.shape[0] != n or order.cell_start.shape[0] != order.n_cells + 1:
        raise ValueError("collision_forces: cell order does not match the particles")
    for name, t in (("origin", order.origin), ("disp", disp)):
        if (t.dtype != torch.float32 or t.shape != (2,) or not t.is_contiguous()
                or t.device != pos.device):
            raise ValueError(f"collision_forces: {name} must be contiguous float32 (2,) "
                             f"on {pos.device}")
    if neighbors is not None and (neighbors.dtype != torch.int32 or neighbors.shape != (n, 8)
                                  or not neighbors.is_contiguous()
                                  or neighbors.device != pos.device):
        raise ValueError(f"collision_forces: neighbors must be contiguous (N, 8) int32 "
                         f"on {pos.device}")
    lib = kernels.library()
    # a range writes only its rows' particles: the others stay 0
    out = torch.empty_like(pos) if rows is None else torch.zeros_like(pos)
    cd2 = float(np.float32(collision_distance * collision_distance))
    args = (pos.data_ptr(), order.sorted_idx.data_ptr(), order.sorted_cell.data_ptr(),
            order.cell_start.data_ptr(), order.origin.data_ptr(), disp.data_ptr(), n,
            row0, count, order.n_cells, order.side, float(collision_distance), cd2,
            float(order.bin_resolution), float(repulsion))
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    if neighbors is None:
        name = "collision"
        status = lib.collision_forces_launch(*args, out.data_ptr(), stream)
    else:
        name = "collision_exclude"
        status = lib.collision_forces_exclude_launch(*args, neighbors.data_ptr(),
                                                     out.data_ptr(), stream)
    kernels.check(status, name)
    kernels.launches[name] += 1
    return out
