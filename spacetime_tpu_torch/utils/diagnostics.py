"""Physical diagnostics: relativistic totals over the particle system
(counterpart of `spacetime_tpu/utils/diagnostics.py`), for regression tests
of conservation and for instrumenting runs (momentum drift, heating)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import relativity
from ..state import Particles


class Totals(NamedTuple):
    momentum: torch.Tensor  # (2,) total relativistic momentum
    energy: torch.Tensor  # () total relativistic energy (sum gamma m0 c^2)
    kinetic: torch.Tensor  # () total relativistic kinetic energy
    rest_mass: torch.Tensor  # () total rest mass
    max_speed: torch.Tensor  # () max |v| over active particles
    n_bonds: torch.Tensor  # () live (directed) bond count


def totals(particles: Particles) -> Totals:
    act = particles.active
    vel = torch.where(act[:, None], particles.vel, 0.0)
    m0 = torch.where(act, particles.rest_mass, 0.0)
    speed = torch.linalg.vector_norm(vel, dim=-1)
    return Totals(
        momentum=relativity.r_momentum(vel, m0).sum(dim=0),
        energy=relativity.r_energy(vel, m0).sum(),
        kinetic=relativity.r_ke(vel, m0).sum(),
        rest_mass=m0.sum(),
        max_speed=torch.where(act, speed, 0.0).max(),
        n_bonds=((particles.neighbors >= 0) & act[:, None]).sum(),
    )
