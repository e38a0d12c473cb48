"""Softbody model: the stepping API over the ops layer.

Counterpart of `spacetime_tpu/models/softbody.py`.  The module holds the
static configuration and, as buffers, the per-slot rest lengths and the
spring-offset table; the state is a `Particles` dataclass passed in and
returned, and optional `materials` (ops/materials.py) ride along each step.
With spring offsets (lattice-padded scenes) the step reads bonds by the
shifted rule; without them (`spring_offsets=None`, any bond graph) it takes
the row-gather physics and the collision kernel's bond-excluding variant.
The collision kernel runs exactly when the particles are CUDA tensors
(ops/forces_cuda.py).  `integrator` is "rk4" (four force evaluations a
step) or "euler" (one; ops/rk4.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import device as device_mod
from ..constants import DEFAULT_PARAMS, PhysicsParams
from ..ops import forces as forces_ops
from ..ops import rk4 as rk4_ops
from ..state import Particles


GRID_DIM = 512  # the JAX model's grid_dim: the live extent is GRID_DIM * grid_resolution


def default_bin_resolution(params: PhysicsParams) -> float:
    """Collision binning resolution: 0.002 ls, floored by the collision
    distance so the 3x3 cell scan always covers every contact."""
    return max(0.002, float(params.collision_distance))


class SoftbodyModel(nn.Module):
    """Static config + step.

    `spring_offsets` (forces.derive_spring_offsets of the scene's neighbor
    table) selects the shifted-spring physics; None selects the row-gather
    physics.  `device` None means cuda:0 (device.resolve: raises without
    CUDA).
    """

    def __init__(
        self,
        capacity: int,
        spring_offsets: Optional[tuple],
        params: PhysicsParams = DEFAULT_PARAMS,
        device=None,
        integrator: str = "rk4",
    ):
        super().__init__()
        device = device_mod.resolve(device)
        self.capacity = capacity
        self.params = params
        self.grid_dim = GRID_DIM
        self.integrator = integrator
        self.bin_resolution = default_bin_resolution(params)
        self.register_buffer(
            "rest_lengths", torch.from_numpy(params.rest_lengths()).to(device)
        )
        self.register_buffer(
            "spring_offsets",
            None if spring_offsets is None
            else forces_ops.spring_offsets_tensor(spring_offsets, device),
        )

    def step(self, particles: Particles, materials=None
             ) -> tuple[Particles, rk4_ops.StepAux]:
        """One physics frame: cell sort + the integrator's step."""
        return rk4_ops.physics_step(
            particles, self.params, self.rest_lengths, self.grid_dim,
            self.spring_offsets, self.bin_resolution, materials=materials,
            integrator=self.integrator,
        )

    def step_n(self, particles: Particles, n_steps: int, materials=None
               ) -> tuple[Particles, rk4_ops.StepAux]:
        """`n_steps` frames; returns the last frame's diagnostics."""
        aux = None
        for _ in range(n_steps):
            particles, aux = self.step(particles, materials)
        return particles, aux
