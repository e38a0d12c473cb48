"""Collision binning: flat halo cell ids on a floating dense grid.

Counterpart of `cell_ids` in `spacetime_tpu/ops/grid.py`.  The hashed grid
and the dense cell table of the JAX package are off the ported path: the
collision kernel (ops/forces_cuda.py) needs only the cell ids and a
per-cell start table built from a sort.
"""

from __future__ import annotations

import torch

from ..utils.profiling import spanned


@spanned("cell sort")
def cell_ids(pos: torch.Tensor, active: torch.Tensor, grid_resolution: float,
             grid_dim: int):
    """Flat halo cell id per particle + the floating grid origin.

    The origin floats with the scene (min active position minus two cells),
    so `grid_dim` caps only the live extent (grid_dim * resolution
    lightseconds); out-of-extent particles clamp into border cells, which
    keeps near pairs co-located.  Cells span [1, grid_dim] on each axis of a
    (grid_dim + 2)^2 grid; inactive particles map to id n_cells, past it.
    """
    side = grid_dim + 2
    n_cells = side * side
    px, py = pos[:, 0], pos[:, 1]
    # a Python scalar, not a tensor made from one: no host-to-device copy,
    # which a captured CUDA graph could not hold
    ox = torch.where(active, px, 3.0e38).min() - 2.0 * grid_resolution
    oy = torch.where(active, py, 3.0e38).min() - 2.0 * grid_resolution
    # clamp in float before the int cast: parked 1e9 padding would overflow i32
    cx = torch.floor((px - ox) / grid_resolution).clamp(0, grid_dim - 1).to(torch.int32) + 1
    cy = torch.floor((py - oy) / grid_resolution).clamp(0, grid_dim - 1).to(torch.int32) + 1
    cell = torch.where(active, cy * side + cx, torch.full_like(cx, n_cells))
    return cell, torch.stack([ox, oy])
