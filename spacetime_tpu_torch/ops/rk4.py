"""Relativistic RK4 step with the reference's stage dataflow.

Counterpart of the sorted-window branch of `spacetime_tpu/ops/rk4.py`
`physics_step`, with both of its bond layouts:

  * shifted springs (`spring_offsets` given, lattice-padded scenes): the
    collision kernel's include variant, with the bonded pairs' repulsion
    subtracted outside it (`forces.bonded_repulsion_shifted`);
  * row gathers (`spring_offsets=None`, any bond graph): the collision
    kernel's exclude variant, which drops self and bonded pairs itself,
    plus `forces.spring_forces_rows`.

Materials (ops/materials.py) scale the stiffness (pairwise mean), add bond
damping against the step's original velocities, scale the break threshold
(pairwise min) and creep the per-bond rest lengths.  The scheme's quirks
are kept:

  * every stage's acceleration uses the step's ORIGINAL velocity;
  * intermediate positions advance with the newly updated velocity;
  * only forces are accumulated (f0 + 2 f1 + 2 f2 + f3); the final combine is
    vel = vel0 + r_acc(facc, vel0) h/6, pos = pos0 + vel h;
  * |v| >= c is clamped to max_speed after the combine;
  * bonds longer than the break threshold at the START positions break
    symmetrically; the stages see the pre-break bond table;
  * plastic creep updates `rest_len` from the START positions after the
    combine, like bond breaking.

The cell sort is built once from the start-of-step positions and shared by
all four force evaluations; each evaluation passes the collision kernel the
largest displacement since along each axis, which widens its scan so no
contact that forms during the step is missed.

`integrator="euler"` is the reference's deprecated Euler path: one force
evaluation at the start positions, the position advanced with the OLD
velocity, no speed clamp, no bond breaking and no creep (bonds_broken 0).
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
from ..utils import logging as logmod


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


def _break(bonded, j, pos, neighbors, threshold, break_scale):
    dx = pos[:, None, 0] - pos[j, 0]
    dy = pos[:, None, 1] - pos[j, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    thr = threshold
    if break_scale is not None:
        thr = threshold * torch.minimum(break_scale[:, None], break_scale[j])
    broke = bonded & (dist > thr)
    return torch.where(broke, -1, neighbors), broke.sum(dtype=torch.int32)


def break_bonds(pos, neighbors, threshold, break_scale=None):
    """Symmetric bond breaking from `pos` over every valid slot (any bond
    graph).  `break_scale` (N,) optionally scales the threshold per
    particle; the pair takes the endpoint MIN, so both endpoints agree.
    Returns (neighbors, bonds_broken)."""
    return _break(*forces_ops._row_slots(neighbors), pos, neighbors, threshold, break_scale)


def break_bonds_shifted(pos, neighbors, offsets, threshold, break_scale=None):
    """break_bonds with the bonded partners read by the shifted rule of
    ops/forces.py.  Returns (neighbors, bonds_broken)."""
    return _break(*forces_ops._bonded_slots(neighbors, offsets), pos, neighbors, threshold,
                  break_scale)


def physics_step(
    particles: Particles,
    params: PhysicsParams,
    rest_lengths: torch.Tensor,
    grid_dim: int,
    spring_offsets,
    bin_resolution: float,
    materials=None,
    integrator: str = "rk4",
) -> tuple[Particles, StepAux]:
    """Cell sort + RK4 (or Euler, `integrator="euler"`) for one frame.  `spring_offsets` is the (8, D) table
    of forces.spring_offsets_tensor, or None for the row-gather physics;
    `bin_resolution` (>= the collision distance) sets the collision
    binning, whose grid dim rescales so the live extent stays
    grid_dim * grid_resolution.  `materials` is an optional
    ops.materials.ParticleMaterials."""
    if integrator not in ("rk4", "euler"):
        raise ValueError(f"unknown integrator: {integrator}")
    h = params.h
    pos0, vel0 = particles.pos, particles.vel
    nbr, m, active = particles.neighbors, particles.rest_mass, particles.active
    if particles.rest_len is not None:  # plastic-creep state overrides the slots
        rest_lengths = particles.rest_len

    act = active[:, None]
    if bin_resolution < params.collision_distance - 1e-9:
        raise ValueError("bin_resolution below collision_distance breaks window coverage")
    bdim = max(1, int(round(grid_dim * params.grid_resolution / bin_resolution)))
    cell, origin = grid_ops.cell_ids(pos0, active, bin_resolution, bdim)
    order = forces_cuda.build_cell_order(cell, origin, (bdim + 2) ** 2, bdim + 2,
                                         bin_resolution)
    cd = params.collision_distance
    rep = params.collision_repulsion_coefficient
    k_pp = materials.k_scale if materials is not None else None
    c_pp = materials.damping if materials is not None else None
    rows = spring_offsets is None
    # the exclude variant reads the bond table as (N, 8) int32 rows
    nbr_rows = nbr.contiguous() if rows else None

    def F(pos):
        # how far any particle moved along x and along y since the cells
        # were built
        disp = torch.where(act, (pos - pos0).abs(), 0.0).amax(dim=0)
        coll = forces_cuda.collision_forces(pos, active, order, cd, rep, disp,
                                            neighbors=nbr_rows)
        px, py = pos[:, 0], pos[:, 1]
        if rows:
            sfx, sfy = forces_ops.spring_forces_rows(
                px, py, nbr, rest_lengths, params.k, k_pp=k_pp, c_pp=c_pp,
                vx=vel0[:, 0] if c_pp is not None else None,
                vy=vel0[:, 1] if c_pp is not None else None,
            )
        else:
            sfx, sfy = forces_ops.spring_forces_shifted(
                px, py, nbr, spring_offsets, rest_lengths, params.k, k_pp=k_pp
            )
            bfx, bfy = forces_ops.bonded_repulsion_shifted(
                px, py, nbr, spring_offsets, cd, rep
            )
            sfx, sfy = sfx - bfx, sfy - bfy
            if c_pp is not None:
                dfx, dfy = forces_ops.bond_damping_shifted(
                    px, py, vel0[:, 0], vel0[:, 1], nbr, spring_offsets, c_pp
                )
                sfx, sfy = sfx + dfx, sfy + dfy
        return coll + torch.stack([sfx, sfy], dim=-1)

    zero = torch.zeros((), dtype=torch.int32, device=pos0.device)
    f0 = F(pos0)
    if integrator == "euler":
        acc = relativity.r_acc(f0, vel0, m)
        new = dataclasses.replace(
            particles,
            pos=torch.where(act, pos0 + vel0 * h, pos0),
            vel=torch.where(act, vel0 + acc * h, vel0),
        )
        return new, StepAux(grid_overflow=zero, bonds_broken=zero, window_truncated=zero)
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
    brk_pp = materials.break_scale if materials is not None else None
    if rows:
        new_neighbors, n_broken = break_bonds(
            pos0, nbr, params.bond_break_threshold, break_scale=brk_pp
        )
    else:
        new_neighbors, n_broken = break_bonds_shifted(
            pos0, nbr, spring_offsets, params.bond_break_threshold, break_scale=brk_pp
        )

    # plastic creep (a stage-4 state update, like bond breaking): bonds
    # stretched past their yield strain at the step's START positions
    # lengthen permanently toward their current length
    new_rest = particles.rest_len
    creep = materials is not None and materials.creep_rate is not None
    if creep and new_rest is None:
        logmod.get().warning(
            "materials.creep_rate is set but particles.rest_len is None; plastic creep "
            "is DISABLED — call state.with_rest_len(particles, params.rest_lengths()) "
            "before stepping")
    elif creep and rows:
        new_rest = forces_ops.creep_rest_lengths_rows(
            pos0, nbr, new_rest, materials.creep_rate, materials.yield_strain, h)
    elif creep:
        new_rest = forces_ops.creep_rest_lengths_shifted(
            pos0[:, 0], pos0[:, 1], nbr, spring_offsets, new_rest, materials.creep_rate,
            materials.yield_strain, h)

    new = dataclasses.replace(
        particles,
        pos=torch.where(act, pos, pos0),
        vel=torch.where(act, vel, vel0),
        neighbors=new_neighbors,
        rest_len=new_rest,
    )
    return new, StepAux(grid_overflow=zero, bonds_broken=n_broken,
                        window_truncated=zero)
