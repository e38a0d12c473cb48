"""Closed-form image warp for the camera-frame (boosted) map view.

Counterpart of `spacetime_tpu/ops/boost.py`.  The default map view plots
every past-light-cone event at its GROUND-frame position; the boosted view
plots it in the moving camera's instantaneous rest frame.  With the camera
at x_c moving at v (|v| < 1, c = 1) and an event on its past cone at ground
offset dx (dt = -|dx|), the boost gives

    u_par  = gamma * (dx_par + v * |dx|)        (component along v-hat)
    u_perp = dx_perp                            (transverse unchanged)

and, since the past cone is Lorentz-invariant, the view is a pure,
invertible warp of the ground retarded map.  The inverse, with
a = u_par / gamma and uperp2 = |u|^2 - u_par^2, takes the positive root
r = gamma^2 (sqrt(a^2 v^2 + (a^2 + uperp2) / gamma^2) - a v) of the cone
radius, then dx_par = a - v r, dx_perp = u_perp.  The warp's Jacobian has
largest singular value gamma (1 + |v|) (`stretch`), which scales the splat
reach in ops/raytrace.py.

Every function takes tensors (or Python floats for the velocity) and keeps
the JAX package's f32 operation order and its `v < 1e-9` still-camera
select, made after the arithmetic; csrc/pixel_pass.cu repeats `unwarp_xy`
in the same order.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _vhat(vx, vy):
    v = torch.sqrt(vx * vx + vy * vy)
    inv = 1.0 / torch.clamp(v, min=_EPS)
    return v, vx * inv, vy * inv


def gamma_of(vx, vy):
    vx, vy = _f32(vx), _f32(vy)
    v2 = vx * vx + vy * vy
    return 1.0 / torch.sqrt(torch.clamp(1.0 - v2, min=_EPS))


def stretch(vx, vy):
    """Max Jacobian singular value of warp_xy: gamma * (1 + |v|)."""
    vx, vy = _f32(vx), _f32(vy)
    v = torch.sqrt(vx * vx + vy * vy)
    return gamma_of(vx, vy) * (1.0 + v)


def warp_xy(dx, dy, vx, vy):
    """Ground cone offset (dx, dy) -> camera-frame plot offset (ux, uy)."""
    vx, vy = _f32(vx).to(dx.device), _f32(vy).to(dx.device)
    v, vhx, vhy = _vhat(vx, vy)
    g = gamma_of(vx, vy)
    d_par = dx * vhx + dy * vhy
    r = torch.sqrt(dx * dx + dy * dy)
    # u = dx + v-hat * ((gamma - 1) * d_par + gamma * v * r)
    bump = (g - 1.0) * d_par + g * v * r
    ux = dx + vhx * bump
    uy = dy + vhy * bump
    still = v < 1e-9
    return torch.where(still, dx, ux), torch.where(still, dy, uy)


def unwarp_xy(ux, uy, vx, vy):
    """Camera-frame plot offset (ux, uy) -> ground cone offset (dx, dy)."""
    vx, vy = _f32(vx).to(ux.device), _f32(vy).to(ux.device)
    v, vhx, vhy = _vhat(vx, vy)
    g = gamma_of(vx, vy)
    u_par = ux * vhx + uy * vhy
    u2 = ux * ux + uy * uy
    uperp2 = torch.clamp(u2 - u_par * u_par, min=0.0)
    a = u_par / g
    inv_g2 = torch.clamp(1.0 - v * v, min=_EPS)  # 1/gamma^2, exact
    s = torch.sqrt(a * a * v * v + (a * a + uperp2) * inv_g2)
    r = (s - a * v) / inv_g2
    d_par = a - v * r
    dx = ux + vhx * (d_par - u_par)
    dy = uy + vhy * (d_par - u_par)
    still = v < 1e-9
    return torch.where(still, ux, dx), torch.where(still, uy, dy)
