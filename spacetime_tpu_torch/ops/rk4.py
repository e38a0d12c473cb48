"""Relativistic RK4 step with the reference's stage dataflow.

Counterpart of the sorted-window, shifted-spring branch of
`spacetime_tpu/ops/rk4.py` `physics_step`.  The scheme's quirks are kept:

  * every stage's acceleration uses the step's ORIGINAL velocity;
  * intermediate positions advance with the newly updated velocity;
  * only forces are accumulated (f0 + 2 f1 + 2 f2 + f3); the final combine is
    vel = vel0 + r_acc(facc, vel0) h/6, pos = pos0 + vel h;
  * |v| >= c is clamped to max_speed after the combine;
  * bonds longer than the break threshold at the START positions break
    symmetrically; the stages see the pre-break bond table.

The cell sort is built once from the start-of-step positions and shared by
all four force evaluations; each evaluation passes the collision kernel the
largest displacement since, which widens its scan so no contact that forms
during the step is missed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import relativity
from ..constants import PhysicsParams
from ..state import Particles
from . import forces as forces_ops
from . import forces_cuda
from . import grid as grid_ops


class StepAux(NamedTuple):
    """Per-step diagnostics, as 0-d tensors on the particles' device."""

    grid_overflow: torch.Tensor  # candidates dropped by a cell-capacity cap
    bonds_broken: torch.Tensor  # bonds removed this step (directed count)
    # elements clipped off the collision windows; the CUDA kernel scans exact
    # per-cell ranges with no cap, so this is always 0 — kept so callers that
    # check the JAX package's diagnostics keep working
    window_truncated: torch.Tensor


def _advance(pos0, vel0, forces, rest_mass, h_scale):
    """One intermediate-state update: acceleration from the ORIGINAL
    velocity, position from the NEW velocity."""
    acc = relativity.r_acc(forces, vel0, rest_mass)
    new_vel = vel0 + acc * h_scale
    new_pos = pos0 + new_vel * h_scale
    return new_pos, new_vel


def break_bonds_shifted(pos, neighbors, offsets, threshold):
    """Symmetric bond breaking from `pos`; bonded partners are read by the
    shifted rule of ops/forces.py.  Returns (neighbors, bonds_broken)."""
    sel, dx, dy = forces_ops._bonded_deltas(pos[:, 0], pos[:, 1], neighbors, offsets)
    dist = torch.sqrt(dx * dx + dy * dy)
    broke = sel & (dist > threshold)
    return torch.where(broke, -1, neighbors), broke.sum(dtype=torch.int32)


def physics_step(
    particles: Particles,
    params: PhysicsParams,
    rest_lengths: torch.Tensor,
    grid_dim: int,
    spring_offsets: torch.Tensor,
    bin_resolution: float,
) -> tuple[Particles, StepAux]:
    """Cell sort + RK4 for one frame.  `spring_offsets` is the (8, D) table
    of forces.spring_offsets_tensor; `bin_resolution` (>= the collision
    distance) sets the collision binning, whose grid dim rescales so the
    live extent stays grid_dim * grid_resolution."""
    h = params.h
    pos0, vel0 = particles.pos, particles.vel
    nbr, m, active = particles.neighbors, particles.rest_mass, particles.active
    if particles.rest_len is not None:
        rest_lengths = particles.rest_len

    act = active[:, None]
    if bin_resolution < params.collision_distance - 1e-9:
        raise ValueError("bin_resolution below collision_distance breaks window coverage")
    bdim = max(1, int(round(grid_dim * params.grid_resolution / bin_resolution)))
    cell, _origin = grid_ops.cell_ids(pos0, active, bin_resolution, bdim)
    order = forces_cuda.build_cell_order(cell, (bdim + 2) ** 2, bdim + 2, bin_resolution)
    cd = params.collision_distance
    rep = params.collision_repulsion_coefficient

    def F(pos):
        # how far any particle moved per axis since the cells were built
        max_disp = torch.where(act, (pos - pos0).abs(), 0.0).amax()
        coll = forces_cuda.collision_forces(pos, active, order, cd, rep, max_disp)
        px, py = pos[:, 0], pos[:, 1]
        sfx, sfy = forces_ops.spring_forces_shifted(
            px, py, nbr, spring_offsets, rest_lengths, params.k
        )
        bfx, bfy = forces_ops.bonded_repulsion_shifted(
            px, py, nbr, spring_offsets, cd, rep
        )
        return coll + torch.stack([sfx - bfx, sfy - bfy], dim=-1)

    f0 = F(pos0)
    p1, _ = _advance(pos0, vel0, f0, m, h / 2.0)
    f1 = F(p1)
    p2, _ = _advance(pos0, vel0, f1, m, h / 2.0)
    f2 = F(p2)
    p3, _ = _advance(pos0, vel0, f2, m, h)
    f3 = F(p3)
    facc = f0 + 2.0 * f1 + 2.0 * f2 + f3
    acc = relativity.r_acc(facc, vel0, m)
    vel = vel0 + acc * (h / 6.0)
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    vel = torch.where(
        speed >= 1.0, vel / torch.clamp(speed, min=1e-20) * params.max_speed, vel
    )
    pos = pos0 + vel * h
    new_neighbors, n_broken = break_bonds_shifted(
        pos0, nbr, spring_offsets, params.bond_break_threshold
    )

    new = dataclasses.replace(
        particles,
        pos=torch.where(act, pos, pos0),
        vel=torch.where(act, vel, vel0),
        neighbors=new_neighbors,
    )
    zero = torch.zeros((), dtype=torch.int32, device=pos0.device)
    return new, StepAux(grid_overflow=zero, bonds_broken=n_broken,
                        window_truncated=zero)
