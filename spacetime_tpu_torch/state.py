"""Simulation state: dataclasses of tensors (structure-of-arrays).

Counterpart of `spacetime_tpu/state.py`.  Neighbor indices are global
particle indices with -1 sentinels: slots 0-3 are the immediate
(left/up/right/down) bonds, slots 4-7 the diagonal (tl/tr/bl/br) bonds.
`N` is a padded capacity; `active` masks the real particles, and padding
particles are parked at 1e9 with no bonds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .constants import NUM_NEIGHBORS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field moved to `device`."""
    return dataclasses.replace(
        obj,
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass(frozen=True)
class Particles:
    """SoA particle state. All tensors have leading dim N (padded capacity)."""

    pos: torch.Tensor  # (N, 2) f32 — ground-frame position, lightseconds
    vel: torch.Tensor  # (N, 2) f32 — ground-frame velocity, fraction of c
    rest_mass: torch.Tensor  # (N,) f32
    neighbors: torch.Tensor  # (N, 8) i32 — global indices, -1 = no bond
    object_index: torch.Tensor  # (N,) i32
    particle_id: torch.Tensor  # (N,) i32
    active: torch.Tensor  # (N,) bool — False for padding slots
    rest_len: Optional[torch.Tensor] = None  # (N, 8) f32 per-bond rest lengths

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "Particles":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class Objects:
    """Per-object table: offset, material index and renderer albedo."""

    offset: torch.Tensor  # (MAX_OBJECTS,) i32
    material_index: torch.Tensor  # (MAX_OBJECTS,) i32
    base_color: torch.Tensor  # (MAX_OBJECTS, 3) f32

    def to(self, device) -> "Objects":
        return _to(self, device)


def make_objects(max_objects: int, specs=None, device="cpu") -> Objects:
    """Build an Objects table from a list of {offset, material_index,
    base_color} dicts.  Default palette: object 0 blue, the others red."""
    offset = np.zeros((max_objects,), np.int32)
    material = np.zeros((max_objects,), np.int32)
    color = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (max_objects, 1))
    if max_objects > 0:
        color[0] = (0.0, 0.0, 1.0)
    for i, spec in enumerate(specs or []):
        offset[i] = spec.get("offset", 0)
        material[i] = spec.get("material_index", 0)
        if "base_color" in spec:
            color[i] = spec["base_color"]
    return Objects(
        offset=torch.from_numpy(offset).to(device),
        material_index=torch.from_numpy(material).to(device),
        base_color=torch.from_numpy(color).to(device),
    )


def pack_particles(
    pos: np.ndarray,
    vel: np.ndarray,
    neighbors: np.ndarray,
    object_index: np.ndarray,
    rest_mass: Optional[np.ndarray] = None,
    particle_id: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    pad_multiple: int = 256,
    active: Optional[np.ndarray] = None,
    device="cpu",
) -> Particles:
    """Pad host-side arrays to a static capacity and move them to `device`."""
    n = pos.shape[0]
    cap = capacity if capacity is not None else _round_up(max(n, pad_multiple), pad_multiple)
    if n > cap:
        raise ValueError(f"{n} particles exceed capacity {cap}")
    if rest_mass is None:
        rest_mass = np.ones((n,), np.float32)
    if particle_id is None:
        particle_id = np.arange(n, dtype=np.int32)
    if active is None:
        active = np.ones((n,), bool)

    def pad(a, fill):
        out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    far = 1.0e9
    return Particles(
        pos=pad(pos.astype(np.float32), far),
        vel=pad(vel.astype(np.float32), 0.0),
        rest_mass=pad(rest_mass.astype(np.float32), 1.0),
        neighbors=pad(neighbors.astype(np.int32), -1),
        object_index=pad(object_index.astype(np.int32), 0),
        particle_id=pad(particle_id.astype(np.int32), -1),
        active=pad(np.asarray(active, bool), False),
    )


def with_rest_len(particles: Particles, slot_rest_lengths) -> Particles:
    """Per-bond rest-length state: every bond starts at its slot's rest
    length (constants.PhysicsParams.rest_lengths)."""
    n = particles.capacity
    rl = torch.as_tensor(
        np.asarray(slot_rest_lengths, np.float32), device=particles.device
    )
    return dataclasses.replace(
        particles, rest_len=rl[None, :].expand(n, NUM_NEIGHBORS).contiguous()
    )


def concat_particle_arrays(parts):
    """Concatenate host-side particle dicts (from scene import), rebasing
    neighbor indices to global.

    Returns (pos, vel, neighbors, object_index, particle_id, active)."""
    pos, vel, nbr, obj, ids, act = [], [], [], [], [], []
    base = 0
    for p in parts:
        n = p["pos"].shape[0]
        pos.append(p["pos"])
        vel.append(p["vel"])
        nb = p["neighbors"].copy()
        nb[nb >= 0] += base
        nbr.append(nb)
        obj.append(p["object_index"])
        ids.append(np.arange(base, base + n, dtype=np.int32))
        act.append(np.asarray(p.get("active", np.ones((n,), bool)), bool))
        base += n
    if not pos:
        z2 = np.zeros((0, 2), np.float32)
        return (
            z2,
            z2,
            np.zeros((0, NUM_NEIGHBORS), np.int32),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
            np.zeros((0,), bool),
        )
    return (
        np.concatenate(pos),
        np.concatenate(vel),
        np.concatenate(nbr),
        np.concatenate(obj),
        np.concatenate(ids),
        np.concatenate(act),
    )
