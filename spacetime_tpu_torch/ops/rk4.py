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
  * plastic creep updates `rest_len` from the START positions, like bond
    breaking; the stages see the pre-creep rest lengths.

The cell sort is built once from the start-of-step positions and shared by
all four force evaluations; each evaluation passes the collision kernel the
largest displacement since along each axis, which widens its scan so no
contact that forms during the step is missed.

Around each evaluation's collision launch, `bond_stage` does the rest of
the per-particle arithmetic: the bonded forces, the force accumulator, the
next evaluation's positions and their displacement; the first evaluation,
which reads the start positions, also breaks bonds and creeps rest lengths
into new tables.  `step_finish` makes the final combine.  CPU tensors take
their plain versions here (ops/forces.py's functions); CUDA tensors launch
csrc/step.cu's kernels (ops/step_cuda.py), one a force evaluation and one
a step, bit-equal to the plain versions in the bonded sum, the broken bonds
and the crept rest lengths.

`integrator="euler"` is the reference's deprecated Euler path: one force
evaluation at the start positions, the position advanced with the OLD
velocity, no speed clamp, no bond breaking and no creep (bonds_broken 0).

On a mesh (`mesh`, parallel/; the JAX step under GSPMD,
`spacetime_tpu/ops/rk4.py:217, 279`) the particles are this rank's block.
Each force evaluation reads the global positions: at the first, one
all-gather brings every rank's positions, velocities and active flags
(and, for the row-gather physics, its bond rows, whose int32 bits ride in
the same f32 buffer); at each later one, one all-gather of the stage's
positions.  Every rank builds the same cell order from them (JAX
replicates its sorted planes), launches the collision kernel over its
share of the sorted rows, and one reduce-scatter sums the forces to their
owners.  Springs, damping, bond breaking and creep run on the block's
rows against the global planes, and one all-reduce sums the StepAux
counters.  Each particle's result is the single-device step's, bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import relativity
from ..constants import PhysicsParams
from ..parallel import comm
from ..state import Particles
from . import forces as forces_ops
from . import forces_cuda
from . import grid as grid_ops
from . import step_cuda
from ..utils import logging as logmod
from ..utils.profiling import spanned


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


def _break(bonded, j, pos, neighbors, threshold, break_scale, row0=0):
    own = slice(row0, row0 + bonded.shape[0])
    dx = pos[own, None, 0] - pos[j, 0]
    dy = pos[own, None, 1] - pos[j, 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    thr = threshold
    if break_scale is not None:
        thr = threshold * torch.minimum(break_scale[own, None], break_scale[j])
    broke = bonded & (dist > thr)
    return torch.where(broke, -1, neighbors), broke.sum(dtype=torch.int32)


def break_bonds(pos, neighbors, threshold, break_scale=None, row0=0):
    """Symmetric bond breaking from `pos` over every valid slot (any bond
    graph).  `break_scale` (N,) optionally scales the threshold per
    particle; the pair takes the endpoint MIN, so both endpoints agree.
    On a mesh `neighbors` holds the rows from global row `row0` and `pos`
    and `break_scale` are global.  Returns (neighbors, bonds_broken)."""
    return _break(*forces_ops._row_slots(neighbors), pos, neighbors, threshold, break_scale,
                  row0)


def break_bonds_shifted(pos, neighbors, offsets, threshold, break_scale=None, row0=0):
    """break_bonds with the bonded partners read by the shifted rule of
    ops/forces.py.  Returns (neighbors, bonds_broken)."""
    return _break(*forces_ops._bonded_slots(neighbors, offsets, row0), pos, neighbors,
                  threshold, break_scale, row0)




class StepPlanes(NamedTuple):
    """What a step's per-particle arithmetic reads, fixed for the step.
    Global planes cover every particle; block planes the B rows of this
    mesh rank from global row `row0` (on one device, all of them)."""

    pos0: torch.Tensor  # (B, 2) block start positions
    gpos0: torch.Tensor  # (N, 2) global start positions
    vel0: torch.Tensor  # (B, 2) block start velocities
    gvel0: torch.Tensor  # (N, 2) global start velocities (the damping reads them)
    rest_mass: torch.Tensor  # (B,)
    active: torch.Tensor  # (B,) bool
    neighbors: torch.Tensor  # (B, 8) i32
    offsets: Optional[torch.Tensor]  # (8, D) i32 shifted table; None: any bond graph
    rest: torch.Tensor  # (8,) per slot or (B, 8) per bond
    row0: int = 0
    k_pp: Optional[torch.Tensor] = None  # (N,) materials.k_scale
    c_pp: Optional[torch.Tensor] = None  # (N,) materials.damping
    break_scale: Optional[torch.Tensor] = None  # (N,)
    creep_rate: Optional[torch.Tensor] = None  # (N,); set: `rest` creeps (per bond)
    yield_strain: Optional[torch.Tensor] = None  # (N,)


class StageOut(NamedTuple):
    """What one force evaluation (`bond_stage`) returns."""

    facc: torch.Tensor  # (B, 2) the forces summed so far, f0 + 2 f1 + 2 f2 + f3
    next_pos: Optional[torch.Tensor]  # (B, 2) the next evaluation's positions
    neighbors: Optional[torch.Tensor]  # (B, 8) after bond breaking (with `broken`)
    rest_len: Optional[torch.Tensor]  # (B, 8) after creep (with `broken` and creep)


def bonded_forces_plain(planes: StepPlanes, params: PhysicsParams, gpos):
    """(fx, fy), each (B,): the block's bonded forces at the global
    positions `gpos` (with offsets, springs less the bonded pairs'
    repulsion that the collision kernel's include variant counted, plus
    damping; without, spring_forces_rows)."""
    px, py = gpos[:, 0], gpos[:, 1]
    nbr, rest, row0 = planes.neighbors, planes.rest, planes.row0
    k_pp, c_pp = planes.k_pp, planes.c_pp
    if planes.offsets is None:
        return forces_ops.spring_forces_rows(
            px, py, nbr, rest, params.k, k_pp=k_pp, c_pp=c_pp,
            vx=planes.gvel0[:, 0] if c_pp is not None else None,
            vy=planes.gvel0[:, 1] if c_pp is not None else None, row0=row0,
        )
    offsets = planes.offsets
    sfx, sfy = forces_ops.spring_forces_shifted(px, py, nbr, offsets, rest, params.k,
                                                k_pp=k_pp, row0=row0)
    bfx, bfy = forces_ops.bonded_repulsion_shifted(
        px, py, nbr, offsets, params.collision_distance,
        params.collision_repulsion_coefficient, row0=row0)
    sfx, sfy = sfx - bfx, sfy - bfy
    if c_pp is not None:
        dfx, dfy = forces_ops.bond_damping_shifted(
            px, py, planes.gvel0[:, 0], planes.gvel0[:, 1], nbr, offsets, c_pp, row0=row0)
        sfx, sfy = sfx + dfx, sfy + dfy
    return sfx, sfy


def bond_stage_plain(planes: StepPlanes, params: PhysicsParams, gpos, coll, facc,
                     weight: int, h_adv=None, disp=None, broken=None) -> StageOut:
    """`bond_stage` in plain torch (see there)."""
    fx, fy = bonded_forces_plain(planes, params, gpos)
    f = coll + torch.stack([fx, fy], dim=-1)
    if weight == 0:
        facc = f
    else:
        facc = facc + (2.0 * f if weight == 2 else f)
    nxt = None
    if h_adv is not None:
        nxt, _ = _advance(planes.pos0, planes.vel0, f, planes.rest_mass, h_adv)
        if disp is not None:
            moved = torch.where(planes.active[:, None], (nxt - planes.pos0).abs(), 0.0)
            disp.copy_(torch.maximum(disp, moved.amax(dim=0)))
    nbr = rest = None
    if broken is not None:
        if planes.offsets is None:
            nbr, n = break_bonds(planes.gpos0, planes.neighbors, params.bond_break_threshold,
                                 break_scale=planes.break_scale, row0=planes.row0)
            if planes.creep_rate is not None:
                rest = forces_ops.creep_rest_lengths_rows(
                    planes.gpos0, planes.neighbors, planes.rest, planes.creep_rate,
                    planes.yield_strain, params.h, row0=planes.row0)
        else:
            nbr, n = break_bonds_shifted(
                planes.gpos0, planes.neighbors, planes.offsets, params.bond_break_threshold,
                break_scale=planes.break_scale, row0=planes.row0)
            if planes.creep_rate is not None:
                rest = forces_ops.creep_rest_lengths_shifted(
                    planes.gpos0[:, 0], planes.gpos0[:, 1], planes.neighbors, planes.offsets,
                    planes.rest, planes.creep_rate, planes.yield_strain, params.h,
                    row0=planes.row0)
        broken.add_(n)
    return StageOut(facc, nxt, nbr, rest)


@spanned("bond stage")
def bond_stage(planes: StepPlanes, params: PhysicsParams, gpos, coll, facc, weight: int,
               h_adv=None, disp=None, broken=None) -> StageOut:
    """One force evaluation of the block at the global positions `gpos`,
    after its collision forces `coll` ((B, 2)): f = coll + bonded forces,
    summed into the accumulator `facc` with `weight` (0: the first, facc
    = f; 2: facc + 2 f; 1: facc + f).  With `h_adv` the next evaluation's
    positions, advanced by h_adv from the start (`_advance`); with `disp`
    ((2,) f32) their largest per-axis displacement from the start over
    the active rows is max-folded into it.  With `broken` (() i32; the
    first evaluation, whose `gpos` is `planes.gpos0`) bonds break into a new
    table, their count added into `broken`, and `rest` creeps where
    `planes.creep_rate` is set.  CPU tensors take the plain version, CUDA
    tensors one launch of csrc/step.cu's bond_stage_kernel."""
    if gpos.device.type == "cpu":
        return bond_stage_plain(planes, params, gpos, coll, facc, weight, h_adv, disp, broken)
    if gpos.device.type != "cuda":
        raise ValueError(f"bond_stage: unsupported device {gpos.device}")
    return StageOut(*step_cuda.bond_stage_launch(planes, params, gpos, coll, facc, weight,
                                                 h_adv, disp, broken))


def step_finish_plain(planes: StepPlanes, params: PhysicsParams, facc, euler: bool = False):
    """`step_finish` in plain torch (see there)."""
    pos0, vel0, act = planes.pos0, planes.vel0, planes.active[:, None]
    h = params.h
    acc = relativity.r_acc(facc, vel0, planes.rest_mass)
    if euler:
        return (torch.where(act, pos0 + vel0 * h, pos0),
                torch.where(act, vel0 + acc * h, vel0))
    vel = vel0 + acc * (h / 6.0)
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    vel = torch.where(
        speed >= 1.0, vel / torch.clamp(speed, min=1e-20) * params.max_speed, vel
    )
    pos = pos0 + vel * h
    return torch.where(act, pos, pos0), torch.where(act, vel, vel0)


@spanned("step finish")
def step_finish(planes: StepPlanes, params: PhysicsParams, facc, euler: bool = False):
    """The block's (pos, vel) after the step from the summed forces `facc`:
    vel = vel0 + r_acc(facc, vel0) h/6, |v| >= c clamped to max_speed,
    pos = pos0 + vel h; with `euler` (facc = f0) pos = pos0 + vel0 h and
    vel = vel0 + r_acc(f0, vel0) h, unclamped.  Inactive rows keep their
    state.  CPU tensors take the plain version, CUDA tensors one launch of
    csrc/step.cu's step_finish_kernel."""
    if facc.device.type == "cpu":
        return step_finish_plain(planes, params, facc, euler)
    if facc.device.type != "cuda":
        raise ValueError(f"step_finish: unsupported device {facc.device}")
    return step_cuda.step_finish_launch(planes, params, facc, euler)


def physics_step(
    particles: Particles,
    params: PhysicsParams,
    rest_lengths: torch.Tensor,
    grid_dim: int,
    spring_offsets,
    bin_resolution: float,
    materials=None,
    integrator: str = "rk4",
    mesh=None,
) -> tuple[Particles, StepAux]:
    """Cell sort + RK4 (or Euler, `integrator="euler"`) for one frame.
    `spring_offsets` is the (8, D) table of forces.spring_offsets_tensor,
    or None for the row-gather physics; `bin_resolution` (>= the collision
    distance) sets the collision binning, whose grid dim rescales so the
    live extent stays grid_dim * grid_resolution.  `materials` is an
    optional ops.materials.ParticleMaterials (global planes on a mesh).
    With `mesh` (parallel.mesh.Mesh) `particles` is this rank's block (see
    the module docstring)."""
    if integrator not in ("rk4", "euler"):
        raise ValueError(f"unknown integrator: {integrator}")
    h = params.h
    pos0, vel0 = particles.pos, particles.vel
    nbr, active = particles.neighbors, particles.active
    if particles.rest_len is not None:  # plastic-creep state overrides the slots
        rest_lengths = particles.rest_len

    if bin_resolution < params.collision_distance - 1e-9:
        raise ValueError("bin_resolution below collision_distance breaks window coverage")
    rows = spring_offsets is None
    # the global planes every rank reads (this device's own on one device)
    if mesh is None:
        row0, gather = 0, (lambda x: x)
        gpos0, gvel0, gact = pos0, vel0, active
        # the exclude variant reads the bond table as (N, 8) int32 rows
        gnbr = nbr.contiguous() if rows else None
        coll_rows = None
    else:
        row0 = mesh.rank * pos0.shape[0]
        gather = lambda x: comm.all_gather(x, mesh)  # noqa: E731
        cols = [pos0, vel0, active[:, None].to(torch.float32)]
        if rows:
            cols.append(nbr.contiguous().view(torch.float32))  # the int32 bits ride along
        g = gather(torch.cat(cols, dim=1))
        gpos0, gvel0, gact = g[:, 0:2].contiguous(), g[:, 2:4], g[:, 4] > 0.5
        gnbr = g[:, 5:13].contiguous().view(torch.int32) if rows else None
        coll_rows = comm.block(g.shape[0], mesh.rank, mesh.size)
    bdim = max(1, int(round(grid_dim * params.grid_resolution / bin_resolution)))
    cell, origin = grid_ops.cell_ids(gpos0, gact, bin_resolution, bdim)
    order = forces_cuda.build_cell_order(cell, origin, (bdim + 2) ** 2, bdim + 2,
                                         bin_resolution)
    cd = params.collision_distance
    rep = params.collision_repulsion_coefficient
    rk4 = integrator == "rk4"

    # plastic creep (a stage-4 state update, like bond breaking): bonds
    # stretched past their yield strain at the step's START positions
    # lengthen permanently toward their current length
    creep = rk4 and materials is not None and materials.creep_rate is not None
    if creep and particles.rest_len is None:
        logmod.get().warning(
            "materials.creep_rate is set but particles.rest_len is None; plastic creep "
            "is DISABLED — call state.with_rest_len(particles, params.rest_lengths()) "
            "before stepping")
        creep = False
    c_pp = materials.damping if materials is not None else None
    planes = StepPlanes(
        pos0=pos0, gpos0=gpos0, vel0=vel0,
        gvel0=gvel0.contiguous() if c_pp is not None else gvel0,
        rest_mass=particles.rest_mass, active=active, neighbors=nbr.contiguous(),
        offsets=spring_offsets, rest=rest_lengths, row0=row0,
        k_pp=materials.k_scale if materials is not None else None, c_pp=c_pp,
        break_scale=materials.break_scale if materials is not None else None,
        creep_rate=materials.creep_rate if creep else None,
        yield_strain=materials.yield_strain if creep else None,
    )
    # the collision kernel's widening at each force evaluation (row s of
    # `disp`: how far any particle moved along x and along y since the
    # cells were built, 0 at the first) and the bonds broken, in one
    # buffer.  On one device each evaluation folds its next positions into
    # the next row; on a mesh the gathered planes are reduced (a block's
    # own maximum would miss the other ranks')
    counts = torch.zeros(9, dtype=torch.int32, device=pos0.device)
    disp, broken = counts[:8].view(torch.float32).view(4, 2), counts[8]
    # (accumulator weight, advance) of each force evaluation: f0 + 2 f1 +
    # 2 f2 + f3, the positions advanced by h/2, h/2 and h between them
    schedule = ((0, h / 2.0), (2, h / 2.0), (2, h), (1, None)) if rk4 else ((0, None),)
    gpos, facc = gpos0, None
    new_neighbors, new_rest = nbr, particles.rest_len
    for s, (weight, h_adv) in enumerate(schedule):
        if mesh is None:
            d = disp[s]
        else:
            d = torch.where(gact[:, None], (gpos - gpos0).abs(), 0.0).amax(dim=0)
        coll = forces_cuda.collision_forces(gpos, gact, order, cd, rep, d, neighbors=gnbr,
                                            rows=coll_rows)
        if mesh is not None:
            coll = comm.reduce_scatter(coll, mesh)
        out = bond_stage(planes, params, gpos, coll, facc, weight, h_adv,
                         disp=disp[s + 1] if mesh is None and h_adv is not None else None,
                         broken=broken if rk4 and s == 0 else None)
        facc = out.facc
        if out.neighbors is not None:
            new_neighbors = out.neighbors
        if out.rest_len is not None:
            new_rest = out.rest_len
        if out.next_pos is not None:
            gpos = gather(out.next_pos)
    pos, vel = step_finish(planes, params, facc, euler=not rk4)

    def summed(aux: StepAux) -> StepAux:
        """The counters summed over the mesh's ranks (one all-reduce)."""
        if mesh is None:
            return aux
        return StepAux(*comm.all_reduce(torch.stack(list(aux)), mesh).unbind())

    zero = torch.zeros((), dtype=torch.int32, device=pos0.device)
    new = dataclasses.replace(particles, pos=pos, vel=vel, neighbors=new_neighbors,
                              rest_len=new_rest)
    return new, summed(StepAux(grid_overflow=zero, bonds_broken=broken,
                               window_truncated=zero))
