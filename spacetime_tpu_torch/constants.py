"""Physics constants for the 2+1D special-relativistic softbody engine.

Copied from `spacetime_tpu/constants.py` (importing it would pull in jax):
c = 1 units, distances in lightseconds, times in seconds.  A test asserts
every value equals the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

C: float = 1.0
C2: float = C * C

H: float = 0.005
K: float = 15000.0
IMMEDIATE_NEIGHBOR_DIST: float = 0.0035
DIAGONAL_NEIGHBOR_DIST: float = IMMEDIATE_NEIGHBOR_DIST * math.sqrt(2.0)
GRID_RESOLUTION: float = 0.005
COLLISION_DISTANCE: float = 0.002
COLLISION_REPULSION_COEFFICIENT: float = 100.0
BOND_BREAK_THRESHOLD: float = 0.01

MAX_PARTICLES: int = 1 << 20
MAX_OBJECTS: int = 1024

# |v| is clamped to this after the final RK4 combine
MAX_SPEED: float = 0.9999

# bond slots per particle: 4 immediate (left/up/right/down), 4 diagonal
NUM_NEIGHBORS: int = 8


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Runtime-overridable physics parameters."""

    h: float = H
    k: float = K
    immediate_neighbor_dist: float = IMMEDIATE_NEIGHBOR_DIST
    diagonal_neighbor_dist: float = DIAGONAL_NEIGHBOR_DIST
    grid_resolution: float = GRID_RESOLUTION
    collision_distance: float = COLLISION_DISTANCE
    collision_repulsion_coefficient: float = COLLISION_REPULSION_COEFFICIENT
    bond_break_threshold: float = BOND_BREAK_THRESHOLD
    max_speed: float = MAX_SPEED

    def rest_lengths(self) -> np.ndarray:
        """Rest length per neighbor slot (8,): 4 immediate then 4 diagonal."""
        return np.array(
            [self.immediate_neighbor_dist] * 4 + [self.diagonal_neighbor_dist] * 4,
            dtype=np.float32,
        )


DEFAULT_PARAMS = PhysicsParams()
