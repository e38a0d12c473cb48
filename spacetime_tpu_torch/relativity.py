"""Special-relativity helpers (c = 1 units).

Counterpart of `spacetime_tpu/relativity.py`: `gamma` and `r_acc` drive the
RK4 step; the Doppler factors drive the renderer's shading; the mass,
momentum and energy feed utils/diagnostics.py; `velocity_addition_2d` and
`aberrate_direction` compose velocities and map camera-frame rays to the
ground frame.  Functions take `(..., 2)` tensors and broadcast.
"""

from __future__ import annotations

import torch

from .constants import C2

_EPS = 1e-12


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


def velocity_addition_2d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Relativistic composition of 2D velocities: the velocity of a particle
    moving at `u` in a frame that itself moves at `v` (both in the final
    frame's coordinates), by the longitudinal and transverse addition
    formulas on u's parts along and across v; `u` itself where v = 0."""
    v_sq = torch.sum(v * v, dim=-1, keepdim=True)
    safe_v_sq = torch.clamp(v_sq, min=_EPS)
    u_par = (torch.sum(u * v, dim=-1, keepdim=True) / safe_v_sq) * v
    u_perp = u - u_par
    g = gamma(torch.sqrt(v_sq[..., 0]))[..., None]
    denom = 1.0 + torch.sum(u * v, dim=-1, keepdim=True) / C2
    out = (u_par + v + u_perp / g) / denom
    return torch.where(v_sq > _EPS, out, u)


def aberrate_direction(d_hat: torch.Tensor, cam_vel: torch.Tensor) -> torch.Tensor:
    """A unit ray direction of the camera's rest frame mapped into the
    ground frame for a camera moving at `cam_vel` (relativistic
    aberration): the photon's velocity composed with the camera's, then
    normalized."""
    d = velocity_addition_2d(d_hat * 1.0, cam_vel)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=_EPS)


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
