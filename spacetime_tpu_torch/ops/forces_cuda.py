"""Collision forces: the per-step cell sort, the CUDA kernel's wrapper
(`csrc/collision.cu`) and its plain-torch version.

Replaces `spacetime_tpu/ops/forces_pallas.py` (`_collision_kernel`,
`build_sorted_order`, `collision_forces_pallas`).  Once per step,
`build_cell_order` stable-sorts the particles by flat halo cell id and
builds a dense `[start, end)` table over all (bdim + 2)^2 cells by one
`searchsorted`; the kernel then scans exact sorted ranges, so no window is
ever truncated.  The scan covers (2R+1)^2 cells, R = 1 at the positions
the cells were built from and wider by the particles' displacement since
(see csrc/collision.cu), so its candidate set is exact at every RK4
stage.  The TPU-only machinery — the sort-as-permutation, the
128-element alignment, `chunk_sub`, `split_windows`, the BIGPOS overscan —
does not carry over: gathers and scatters on the card are plain indexing.

Two variants, as the TPU kernel's `exclude_bonds` flag has:

  * include (`neighbors=None`): bonded pairs stay in the sum and the caller
    subtracts them (`forces.bonded_repulsion_shifted`), the lattice-padded
    scenes' path;
  * exclude (`neighbors` given): the kernel drops j = i and j in
    neighbors[i, 0..7] itself, the path of scenes without spring offsets.

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
    n_cells: int
    side: int  # cells per grid row (grid_dim + 2)
    bin_resolution: float  # cell edge, lightseconds


def build_cell_order(cell: torch.Tensor, n_cells: int, side: int,
                     bin_resolution: float) -> CellOrder:
    """Stable sort by cell id plus the dense per-cell start table.  Empty
    cells start where the next cell does, so cells [a, b] span the sorted
    rows [cell_start[a], cell_start[b + 1]); cell_start[n_cells] counts the
    active particles."""
    sorted_cell, perm = torch.sort(cell, stable=True)
    queries = torch.arange(n_cells + 1, dtype=sorted_cell.dtype, device=cell.device)
    cell_start = torch.searchsorted(sorted_cell, queries, out_int32=True)
    return CellOrder(
        sorted_idx=perm.to(torch.int32),
        sorted_cell=sorted_cell,
        cell_start=cell_start,
        n_cells=n_cells,
        side=side,
        bin_resolution=bin_resolution,
    )


def collision_forces_plain(pos: torch.Tensor, active: torch.Tensor,
                           collision_distance: float, repulsion: float,
                           neighbors: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked brute force over all active pairs with the kernel's test and
    per-pair term — exact by construction.  Bonded pairs are included,
    unless `neighbors` is given: then j = i and j in neighbors[i] are
    excluded, as the exclude variant does."""
    n = pos.shape[0]
    cd2 = collision_distance * collision_distance
    px, py = pos[:, 0], pos[:, 1]
    ids = torch.arange(n, device=pos.device)
    out = torch.zeros_like(pos)
    for a in range(0, n, PLAIN_CHUNK):
        b = min(a + PLAIN_CHUNK, n)
        dx = px[a:b, None] - px[None, :]
        dy = py[a:b, None] - py[None, :]
        dist2 = dx * dx + dy * dy
        hit = (dist2 < cd2) & (dist2 > 0.0) & active[None, :] & active[a:b, None]
        if neighbors is not None:
            hit = hit & (ids[None, :] != ids[a:b, None])
            for s in range(neighbors.shape[1]):
                hit = hit & (ids[None, :] != neighbors[a:b, s, None])
        mag = torch.where(hit, repulsion * torch.rsqrt(torch.clamp(dist2, min=1e-20)), 0.0)
        out[a:b, 0] = torch.sum(mag * dx, dim=1)
        out[a:b, 1] = torch.sum(mag * dy, dim=1)
    return out


def collision_forces(pos: torch.Tensor, active: torch.Tensor, order: CellOrder,
                     collision_distance: float, repulsion: float,
                     max_disp: torch.Tensor,
                     neighbors: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 2) collision forces: bonded pairs included, or excluded with
    self pairs when `neighbors` ((N, 8) i32) is given.  `order` was built
    from earlier positions; `max_disp` (0-d f32 on the device) bounds how
    far any particle moved per axis since, so the kernel widens its scan to
    keep the candidate set exact.  CPU tensors take the plain version;
    CUDA tensors launch `collision_forces_launch`, or
    `collision_forces_exclude_launch` with `neighbors`."""
    if pos.device.type == "cpu":
        return collision_forces_plain(pos, active, collision_distance, repulsion, neighbors)
    if pos.device.type != "cuda":
        raise ValueError(f"collision_forces: unsupported device {pos.device}")
    n = pos.shape[0]
    if pos.dtype != torch.float32 or pos.shape != (n, 2) or not pos.is_contiguous():
        raise ValueError("collision_forces: pos must be contiguous (N, 2) float32")
    for name, t in (("sorted_idx", order.sorted_idx), ("sorted_cell", order.sorted_cell),
                    ("cell_start", order.cell_start)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != pos.device:
            raise ValueError(f"collision_forces: {name} must be contiguous int32 on {pos.device}")
    if order.sorted_idx.shape[0] != n or order.cell_start.shape[0] != order.n_cells + 1:
        raise ValueError("collision_forces: cell order does not match the particles")
    if max_disp.dtype != torch.float32 or max_disp.numel() != 1 or max_disp.device != pos.device:
        raise ValueError(f"collision_forces: max_disp must be one float32 on {pos.device}")
    if neighbors is not None and (neighbors.dtype != torch.int32 or neighbors.shape != (n, 8)
                                  or not neighbors.is_contiguous()
                                  or neighbors.device != pos.device):
        raise ValueError(f"collision_forces: neighbors must be contiguous (N, 8) int32 "
                         f"on {pos.device}")
    lib = kernels.library()
    out = torch.empty_like(pos)
    cd2 = float(np.float32(collision_distance * collision_distance))
    args = (pos.data_ptr(), order.sorted_idx.data_ptr(), order.sorted_cell.data_ptr(),
            order.cell_start.data_ptr(), max_disp.data_ptr(), n, order.n_cells,
            order.side, float(collision_distance), cd2, float(order.bin_resolution),
            float(repulsion))
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    if neighbors is None:
        status = lib.collision_forces_launch(*args, out.data_ptr(), stream)
        name = "collision"
    else:
        status = lib.collision_forces_exclude_launch(*args, neighbors.data_ptr(),
                                                     out.data_ptr(), stream)
        name = "collision_exclude"
    kernels.check(status, name)
    kernels.launches[name] += 1
    return out
