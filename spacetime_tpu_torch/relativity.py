"""Special-relativity helpers (c = 1 units) used by the ported slice.

Counterpart of `spacetime_tpu/relativity.py`: `gamma` and `r_acc` drive the
RK4 step; the Doppler factors drive the renderer's shading; the mass,
momentum and energy feed utils/diagnostics.py.  Functions take `(..., 2)`
tensors and broadcast.
"""

from __future__ import annotations

import torch

from .constants import C2


def gamma(speed: torch.Tensor) -> torch.Tensor:
    """Lorentz factor from |v|."""
    return 1.0 / torch.sqrt(1.0 - speed * speed / C2)


def gamma_v(vel: torch.Tensor) -> torch.Tensor:
    """Lorentz factor from a velocity vector `(..., 2)`."""
    return gamma(torch.linalg.vector_norm(vel, dim=-1))


def r_mass(vel: torch.Tensor, rest_mass: torch.Tensor) -> torch.Tensor:
    """Relativistic mass m = gamma * m0."""
    return gamma_v(vel) * rest_mass


def r_momentum(vel: torch.Tensor, rest_mass: torch.Tensor) -> torch.Tensor:
    """Relativistic momentum p = m v."""
    return r_mass(vel, rest_mass)[..., None] * vel


def r_energy(vel: torch.Tensor, rest_mass: torch.Tensor) -> torch.Tensor:
    """Relativistic energy E = m c^2."""
    return r_mass(vel, rest_mass) * C2


def r_ke(vel: torch.Tensor, rest_mass: torch.Tensor) -> torch.Tensor:
    """Relativistic kinetic energy E - m0 c^2."""
    return r_energy(vel, rest_mass) - rest_mass * C2


def r_acc(force: torch.Tensor, vel: torch.Tensor, rest_mass: torch.Tensor) -> torch.Tensor:
    """Acceleration under 3-force `force` at velocity `vel`:
    a = (F - (v.F) v / c^2) / (m0 * gamma)."""
    vdotf = torch.sum(vel * force, dim=-1, keepdim=True)
    g = gamma_v(vel)[..., None]
    return (force - vdotf * vel / C2) / (rest_mass[..., None] * g)


def doppler_factor(source_vel: torch.Tensor, n_hat: torch.Tensor) -> torch.Tensor:
    """Observed/emitted frequency ratio, D = 1 / (gamma (1 - beta.n_hat)),
    for a source at `source_vel` and photon direction `n_hat` (unit, source
    -> observer), observer at rest."""
    g = gamma_v(source_vel)
    beta_n = torch.sum(source_vel * n_hat, dim=-1)
    return 1.0 / (g * (1.0 - beta_n / C2))


def camera_doppler_factor(cam_vel: torch.Tensor, n_hat: torch.Tensor) -> torch.Tensor:
    """Extra factor seen by an observer moving at `cam_vel`:
    D_cam = gamma_cam (1 - beta_cam.n_hat)."""
    g = gamma_v(cam_vel)
    beta_n = torch.sum(cam_vel * n_hat, dim=-1)
    return g * (1.0 - beta_n / C2)
