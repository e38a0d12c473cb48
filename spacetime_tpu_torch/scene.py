"""Scene construction: image -> softbody import and procedural blobs.

Counterpart of `spacetime_tpu/scene.py`.  Everything here is numpy until
`SceneBuilder.build` packs the state onto a device, so the port's scene
arrays equal the JAX package's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import constants
from . import device as device_mod
from .state import Objects, Particles, concat_particle_arrays, make_objects, pack_particles
from .utils.png import read_png

# Neighbor slot offsets in slot order: immediate left/up/right/down, then
# diagonal tl/tr/bl/br
NEIGHBOR_OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, 0),
    (0, -1),
    (1, 0),
    (0, 1),
    (-1, -1),
    (1, -1),
    (-1, 1),
    (1, 1),
)


def mask_to_softbody(
    mask: np.ndarray,
    object_index: int,
    ground_pos_offset: Sequence[float],
    starting_ground_vel: Sequence[float],
    spacing: float = constants.IMMEDIATE_NEIGHBOR_DIST,
    lattice_pad: bool = False,
) -> dict:
    """Build one softbody from a boolean occupancy grid (H, W).

    Returns host-side arrays with object-local neighbor indices.
    `lattice_pad=True` crops the mask to its occupancy bbox and emits a slot
    for every bbox pixel (non-mask pixels become inactive slots at 1e9 with
    no bonds), so slot s of particle i bonds to i + d_s for a per-object
    constant d_s — the layout the shifted spring reads need
    (ops/forces.spring_forces_shifted).
    """
    mask = np.asarray(mask, bool)
    if lattice_pad and mask.any():
        ys_nz, xs_nz = np.nonzero(mask)
        y0, y1 = int(ys_nz.min()), int(ys_nz.max())
        x0, x1 = int(xs_nz.min()), int(xs_nz.max())
        if (y0, x0) != (0, 0) or (y1, x1) != (mask.shape[0] - 1,
                                              mask.shape[1] - 1):
            mask = mask[y0:y1 + 1, x0:x1 + 1]
            ground_pos_offset = (
                float(ground_pos_offset[0]) + x0 * float(spacing),
                float(ground_pos_offset[1]) + y0 * float(spacing),
            )
    h, w = mask.shape
    if lattice_pad:
        n = h * w
        ys, xs = np.divmod(np.arange(n, dtype=np.int32), w)
        flat = mask.reshape(-1)
        neighbors = np.full((n, 8), -1, np.int32)
        for slot, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
            nx, ny = xs + dx, ys + dy
            in_b = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
            tgt = np.where(in_b, ny * w + nx, 0)
            ok = in_b & flat & flat[tgt]
            neighbors[:, slot] = np.where(ok, tgt, -1)
        far = np.float32(1.0e9)
        pos = np.stack(
            [
                np.where(flat, xs.astype(np.float32) * spacing
                         + np.float32(ground_pos_offset[0]), far),
                np.where(flat, ys.astype(np.float32) * spacing
                         + np.float32(ground_pos_offset[1]), far),
            ],
            axis=-1,
        )
        vel = np.where(
            flat[:, None],
            np.asarray(starting_ground_vel, np.float32)[None, :],
            np.float32(0.0),
        ).astype(np.float32)
        return {
            "pos": pos,
            "vel": vel,
            "neighbors": neighbors,
            "object_index": np.full((n,), object_index, np.int32),
            "active": flat.copy(),
        }
    ys, xs = np.nonzero(mask)
    order = np.argsort(ys * w + xs, kind="stable")
    ys, xs = ys[order], xs[order]
    n = xs.shape[0]
    index_of = np.full((h + 2, w + 2), -1, np.int32)  # +1 halo so x±1 never wraps
    index_of[ys + 1, xs + 1] = np.arange(n, dtype=np.int32)

    neighbors = np.full((n, 8), -1, np.int32)
    for slot, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
        neighbors[:, slot] = index_of[ys + 1 + dy, xs + 1 + dx]

    pos = np.stack(
        [
            xs.astype(np.float32) * spacing + np.float32(ground_pos_offset[0]),
            ys.astype(np.float32) * spacing + np.float32(ground_pos_offset[1]),
        ],
        axis=-1,
    )
    vel = np.tile(np.asarray(starting_ground_vel, np.float32), (n, 1))
    return {
        "pos": pos,
        "vel": vel,
        "neighbors": neighbors,
        "object_index": np.full((n,), object_index, np.int32),
    }


def image_to_softbody(
    path_or_array,
    object_index: int,
    ground_pos_offset: Sequence[float],
    starting_ground_vel: Sequence[float],
    lattice_pad: bool = False,
) -> dict:
    """PNG (or (H, W, 3) array) -> softbody; non-black pixels become
    particles.  The PNG is read by `read_png` (utils/png.py: zlib and
    struct, no pillow), which gives what pillow's `convert("RGB")` gives."""
    rgb = path_or_array if isinstance(path_or_array, np.ndarray) else read_png(path_or_array)
    mask = np.any(rgb != 0, axis=-1)
    return mask_to_softbody(
        mask, object_index, ground_pos_offset, starting_ground_vel,
        lattice_pad=lattice_pad,
    )


def disc_mask(radius_px: int) -> np.ndarray:
    """Filled disc occupancy grid."""
    d = 2 * radius_px + 1
    yy, xx = np.mgrid[0:d, 0:d]
    return (xx - radius_px) ** 2 + (yy - radius_px) ** 2 <= radius_px**2


def box_mask(w_px: int, h_px: int) -> np.ndarray:
    """Filled w x h rectangle occupancy grid."""
    return np.ones((h_px, w_px), bool)


def disc_softbody(radius_px, object_index, offset, vel, lattice_pad=False) -> dict:
    return mask_to_softbody(
        disc_mask(radius_px), object_index, offset, vel, lattice_pad=lattice_pad
    )


def radius_for_count(count: int) -> int:
    """Disc radius (px) whose filled-disc particle count is close to `count`."""
    r = max(1, int(round(np.sqrt(count / np.pi))))
    best_r, best_err = r, abs(disc_mask(r).sum() - count)
    for rr in range(max(1, r - 2), r + 3):
        err = abs(disc_mask(rr).sum() - count)
        if err < best_err:
            best_r, best_err = rr, err
    return best_r


@dataclasses.dataclass
class SceneBuilder:
    """Accumulates softbodies, then packs the state onto a device."""

    bodies: List[dict] = dataclasses.field(default_factory=list)
    object_specs: List[dict] = dataclasses.field(default_factory=list)

    def add(self, body: dict, base_color=None, material_index: int = 0) -> "SceneBuilder":
        offset = sum(b["pos"].shape[0] for b in self.bodies)
        self.bodies.append(body)
        spec = {"offset": offset, "material_index": material_index}
        if base_color is not None:
            spec["base_color"] = base_color
        self.object_specs.append(spec)
        return self

    def num_particles(self) -> int:
        return sum(b["pos"].shape[0] for b in self.bodies)

    def build(self, capacity: Optional[int] = None, device="cpu") -> Tuple[Particles, Objects]:
        pos, vel, nbr, obj, ids, act = concat_particle_arrays(self.bodies)
        particles = pack_particles(
            pos, vel, nbr, obj, particle_id=ids, capacity=capacity, active=act,
            device=device,
        )
        objects = make_objects(constants.MAX_OBJECTS, self.object_specs, device=device)
        return particles, objects


def two_blob_collision_scene(radius_px: int = 135, capacity: Optional[int] = None,
                             device=None) -> Tuple[Particles, Objects]:
    """The reference's demo scene: two blobs on a collision course at 0.14c
    closing speed (the first at (0, 0) moving (0.1, 0.1), the second at
    (1.2, 0.8) moving (-0.1, -0.1)), here procedural discs of radius
    `radius_px`, blue and red.  `device` None means cuda:0 (raises without
    CUDA)."""
    sb = SceneBuilder()
    sb.add(disc_softbody(radius_px, 0, (0.0, 0.0), (0.1, 0.1)), base_color=(0.0, 0.0, 1.0))
    sb.add(disc_softbody(radius_px, 1, (1.2, 0.8), (-0.1, -0.1)), base_color=(1.0, 0.0, 0.0))
    return sb.build(capacity, device=device_mod.resolve(device))


def single_blob_scene(count: int = 4000, capacity: Optional[int] = None, vel=(0.1, 0.1),
                      device=None) -> Tuple[Particles, Objects]:
    """One blue disc of about `count` particles at (0.3, 0.3) moving `vel`
    (the default count is the reference's small fast test image's, 3,965
    particles).  `device` None means cuda:0 (raises without CUDA)."""
    sb = SceneBuilder()
    sb.add(disc_softbody(radius_for_count(count), 0, (0.3, 0.3), vel),
           base_color=(0.0, 0.0, 1.0))
    return sb.build(capacity, device=device_mod.resolve(device))
