"""The particle-axis layout, the state's scatter and gather, and the raw
sharded API: `make_sharded_step` and `make_sharded_frame`.

Counterpart of `spacetime_tpu/parallel/sharding.py`.  JAX binds shardings
to a jitted frame and lets GSPMD partition it; here every rank runs the
frame on its own block and the ops modules call the collectives they need
(parallel/__init__.py lists them).  The layout (JAX's
`particle_sharding` / `worldline_sharding`):

  * each (N, ...) particle array: rank r holds rows [r B, (r + 1) B),
    B = N / size, N padded to a multiple of the world size with inactive
    particles (`pad_particles`);
  * the ring's (2T, N) planes: rank r holds the same columns; `times`,
    `cursor` and `frames_in_use` are replicated;
  * the image: each rank shades a band of view-cell rows, and every rank
    ends the frame with the whole image.

`shard_state` places host-built (or single-device) state onto the mesh,
`gather_state` brings it back (checkpoints, `multihost.allgather`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ..ops import worldline as wl
from ..state import Particles
from . import comm
from .mesh import Mesh, pad_to_multiple

# what a padding particle holds in each field (state.pack_particles' fill)
_PAD_FILL = {"pos": 1.0e9, "vel": 0.0, "rest_mass": 1.0, "neighbors": -1, "object_index": 0,
             "particle_id": -1, "active": False, "rest_len": 0.0}


def particle_block(n: int, mesh: Mesh) -> Tuple[int, int]:
    """(lo, hi): the rows of an `n`-row particle array that this rank
    holds (`n` a multiple of the world size)."""
    if n % mesh.size:
        raise ValueError(f"particle_block: {n} rows do not split over {mesh.size} ranks "
                         "(pad_particles first)")
    b = n // mesh.size
    return mesh.rank * b, (mesh.rank + 1) * b


def pad_particles(particles: Particles, multiple: int) -> Particles:
    """`particles` with its capacity padded to a multiple of `multiple` by
    inactive particles (parked at 1e9, no bonds), as a scene's own padding
    is."""
    n = particles.capacity
    extra = pad_to_multiple(n, multiple) - n
    if extra == 0:
        return particles
    grow = {}
    for f in dataclasses.fields(particles):
        x = getattr(particles, f.name)
        if x is not None:
            pad = torch.full((extra,) + tuple(x.shape[1:]), _PAD_FILL[f.name], dtype=x.dtype,
                             device=x.device)
            grow[f.name] = torch.cat([x, pad])
    return dataclasses.replace(particles, **grow)


def pad_ring(buf: wl.WorldlineBuffer, n: int) -> wl.WorldlineBuffer:
    """`buf` with its particle columns padded to `n` (positions parked at
    1e9, velocities 0: what a push stores for a particle not present)."""
    extra = n - buf.num_particles
    if extra == 0:
        return buf
    col = lambda plane, fill: torch.cat(  # noqa: E731
        [plane, torch.full((plane.shape[0], extra), fill, dtype=plane.dtype,
                           device=plane.device)], dim=1)
    return dataclasses.replace(buf, pos_x=col(buf.pos_x, 1e9), pos_y=col(buf.pos_y, 1e9),
                               vel_x=col(buf.vel_x, 0.0), vel_y=col(buf.vel_y, 0.0))


def shard_particles(particles: Particles, mesh: Mesh) -> Particles:
    """This rank's block of the (full, equal on every rank) particles,
    padded to a multiple of the world size, as tensors of its own on the
    mesh's device."""
    particles = pad_particles(particles, mesh.size)
    lo, hi = particle_block(particles.capacity, mesh)
    return dataclasses.replace(particles, **{
        f.name: getattr(particles, f.name)[lo:hi].to(mesh.device).clone()
        for f in dataclasses.fields(particles) if getattr(particles, f.name) is not None})


def shard_ring(buf: wl.WorldlineBuffer, mesh: Mesh, n: int) -> wl.WorldlineBuffer:
    """This rank's columns of the (full) ring padded to `n` particles; the
    clock and cursor replicated."""
    buf = pad_ring(buf, n)
    lo, hi = particle_block(n, mesh)
    cols = lambda plane: plane[:, lo:hi].to(mesh.device).contiguous().clone()  # noqa: E731
    rep = lambda x: x.to(mesh.device).clone()  # noqa: E731
    return wl.WorldlineBuffer(pos_x=cols(buf.pos_x), pos_y=cols(buf.pos_y),
                              vel_x=cols(buf.vel_x), vel_y=cols(buf.vel_y),
                              times=rep(buf.times), cursor=rep(buf.cursor),
                              frames_in_use=rep(buf.frames_in_use))


def shard_state(particles: Particles, buf: wl.WorldlineBuffer, mesh: Mesh):
    """(particles, ring) of this rank from the full state that every rank
    holds (a deterministic scene build, or a checkpoint): the JAX
    package's `shard_state` / `multihost.host_state`."""
    p = shard_particles(particles, mesh)
    return p, shard_ring(buf, mesh, p.capacity * mesh.size)


def gather_particles(particles: Particles, mesh: Mesh, capacity: int | None = None
                     ) -> Particles:
    """The full particles on every rank (one all-gather a field), cut back
    to `capacity` rows (the unpadded one) if given."""
    n = capacity if capacity is not None else particles.capacity * mesh.size
    out = {}
    for f in dataclasses.fields(particles):
        x = getattr(particles, f.name)
        if x is not None:
            flat = x.to(torch.uint8) if x.dtype == torch.bool else x
            g = comm.all_gather(flat, mesh)[:n]
            out[f.name] = g.to(torch.bool) if x.dtype == torch.bool else g
    return dataclasses.replace(particles, **out)


def gather_ring(buf: wl.WorldlineBuffer, mesh: Mesh, capacity: int | None = None
                ) -> wl.WorldlineBuffer:
    """The full ring on every rank (each plane's columns all-gathered), cut
    back to `capacity` particles if given.  For checkpoints only: the
    frame never moves a ring plane."""
    b = buf.num_particles
    n = capacity if capacity is not None else b * mesh.size

    def cols(plane):
        g = comm.all_gather(plane.t().contiguous(), mesh)  # (size * B, 2T)
        return g[:n].t().contiguous()

    return dataclasses.replace(buf, pos_x=cols(buf.pos_x), pos_y=cols(buf.pos_y),
                               vel_x=cols(buf.vel_x), vel_y=cols(buf.vel_y))


def gather_state(particles: Particles, buf: wl.WorldlineBuffer, mesh: Mesh,
                 capacity: int | None = None):
    """(particles, ring) in full on every rank, cut to `capacity`: the
    inverse of shard_state."""
    return gather_particles(particles, mesh, capacity), gather_ring(buf, mesh, capacity)


def make_sharded_step(model, mesh: Mesh, materials=None, production_kernels: bool = True
                      ) -> Callable[[Particles], Particles]:
    """The physics step alone on the mesh: fn(particles) -> particles, on
    this rank's block.  `model` is a SoftbodyModel of the global (padded)
    capacity, `materials` its global planes (replicated).  The collision
    kernel runs on each rank's sorted rows (its plain version for CPU
    tensors); `production_kernels` is _check_production's."""
    _check_production(production_kernels, mesh)
    model = _on_mesh(model, mesh)

    def step(particles: Particles) -> Particles:
        return model.step(particles, materials)[0]

    return step


def make_sharded_frame(model, objects, render_params, width: int, height: int, mesh: Mesh,
                       materials=None, production_kernels: bool = True,
                       render_mode: str = "retarded", defects=None, hole=None,
                       defect_source=None, defect_g: float = 0.0,
                       defect_retarded: bool = False, wl3d=None, object_index=None):
    """One frame on the mesh — the physics step, the worldline push and
    the render — as fn(particles, buf, cam, t) -> (particles, buf, img):
    `particles` and `buf` this rank's block (shard_state), `cam` and `t`
    replicated, `img` the whole (H, W, 3) image on every rank.  The ring is
    updated in place.  `render_mode` (JAX's names and arguments) is
    "retarded" (instant with `render_params.retarded` False), "conical"
    (`defects`, ops.curved.ConicalDefect or a tuple of them, and/or the
    matter-sourced `defect_source` with `defect_g` and `defect_retarded`),
    "btz" (`hole`, ops.btz.BTZBlackHole), "points" (with `object_index`,
    the replicated global object index: replicated_object_index) or
    "worldline3d" (`wl3d`).  CUDA tensors launch the kernels, CPU tensors
    take their plain versions; the curved modes' own passes are plain torch
    either way.  `production_kernels` is _check_production's."""
    from ..ops import btz, curved, gravity, points_cuda, raytrace, worldline3d

    modes = ("retarded", "conical", "btz", "points", "worldline3d")
    if render_mode not in modes:
        raise ValueError(f"make_sharded_frame: render_mode {render_mode!r} is not one of "
                         f"{modes}")
    if render_mode == "conical" and defects is None and defect_source is None:
        raise ValueError("render_mode='conical' requires defects or defect_source")
    if render_mode == "btz" and hole is None:
        raise ValueError("render_mode='btz' requires hole")
    if render_mode == "points" and object_index is None:
        raise ValueError("render_mode='points' on a mesh needs the replicated object_index")
    if render_mode == "worldline3d" and wl3d is None:
        raise ValueError("render_mode='worldline3d' requires wl3d params")
    _check_production(production_kernels, mesh)
    model = _on_mesh(model, mesh)

    def frame(particles: Particles, buf: wl.WorldlineBuffer, cam, t):
        particles, _aux = model.step(particles, materials)
        buf = wl.push_frame(buf, particles, t)
        if render_mode == "conical":
            all_defects = () if defects is None else (
                tuple(defects) if isinstance(defects, (tuple, list)) else (defects,))
            if defect_source:
                all_defects += gravity.source_defects(
                    defect_source, particles, buf, cam, float(model.params.h), defect_g,
                    defect_retarded, max_age=render_params.max_age, mesh=mesh)
            img = curved.render_retarded_conical(buf, particles.object_index, objects, cam,
                                                 all_defects, width, height, render_params,
                                                 planar=True, mesh=mesh)
        elif render_mode == "btz":
            img = btz.render_btz_with_diag(buf, particles.object_index, objects, cam, hole,
                                           width, height, render_params, planar=True,
                                           mesh=mesh)[0]
        elif render_mode == "points":
            img = points_cuda.render_points_mesh(particles, objects, cam, width, height, mesh,
                                                 object_index)
        elif render_mode == "worldline3d":
            img = worldline3d.render_worldline3d(
                buf, particles.object_index, objects, cam, width, height, wl3d,
                active=particles.active, boundary=wl.boundary_mask(particles), planar=True,
                mesh=mesh)
        else:
            # no boundary retina, as JAX's raw frame (the Engine passes one)
            img = raytrace.render_retarded(buf, particles.object_index, objects, cam, width,
                                           height, render_params, planar=True, mesh=mesh)
        return particles, buf, img.permute(1, 2, 0)

    return frame


def _check_production(production_kernels: bool, mesh: Mesh) -> None:
    """JAX's `production_kernels=False` picks its XLA path, a second
    production path the port does not have: CUDA tensors always launch the
    kernels.  The flag stays for JAX's signature; False on a CUDA mesh
    raises rather than run something else than was asked."""
    if not production_kernels and torch.device(mesh.device).type == "cuda":
        raise ValueError("production_kernels=False: the port has no path besides its "
                         "kernels on the card (their plain versions run on CPU tensors only)")


def _on_mesh(model, mesh: Mesh):
    """A SoftbodyModel like `model` whose step runs on `mesh` (the JAX
    raw API's dataclasses.replace(model, shard=...))."""
    from ..models.softbody import SoftbodyModel

    offsets = model.spring_offsets
    out = SoftbodyModel(model.capacity, None, model.params, integrator=model.integrator,
                        mesh=mesh)
    out.spring_offsets = None if offsets is None else offsets.to(mesh.device)
    return out


def replicated_object_index(particles: Particles, mesh: Mesh) -> torch.Tensor:
    """The global object index on every rank (one all-gather): what the
    point view's resolve pass reads."""
    return comm.all_gather(particles.object_index, mesh)
