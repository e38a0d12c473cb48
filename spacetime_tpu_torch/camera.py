"""Camera: a ground-frame position, a zoom (lightseconds per screen along the
larger window axis) and a ground-frame velocity for observer Doppler.
Counterpart of `spacetime_tpu/camera.py`."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as device_mod


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor  # (2,) f32 — ground-frame position, lightseconds
    zoom: torch.Tensor  # () f32 — lightseconds per screen (larger axis)
    vel: torch.Tensor  # (2,) f32 — ground-frame velocity

    @staticmethod
    def create(pos=(0.5, 0.5), zoom=1.0, vel=(0.0, 0.0), device=None) -> "Camera":
        """A camera from host values on `device` (None: cuda:0, raising
        without CUDA)."""
        device = device_mod.resolve(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return Camera(pos=f(pos), zoom=f(zoom), vel=f(vel))

    def to(self, device) -> "Camera":
        return Camera(pos=self.pos.to(device), zoom=self.zoom.to(device),
                      vel=self.vel.to(device))


@dataclasses.dataclass
class CameraController:
    """Host-side pan/zoom controller (the reference's `World::update_camera`):
    0.6 ls/s pan, zoom factor 1.0 per second.  It works on host floats, so a
    key press costs no device round trip."""

    pan_speed: float = 0.6
    zoom_factor: float = 1.0

    def update(self, pos, zoom, keys, dt: float):
        """(pos, zoom) after one frame of `keys` (booleans left/right/up/down/
        z/x); `pos` is (2,) np.float32, `zoom` np.float32, updated in f32 as
        the JAX controller does."""
        dx = (keys.get("right", False) - keys.get("left", False)) * dt * self.pan_speed
        dy = (keys.get("down", False) - keys.get("up", False)) * dt * self.pan_speed
        dz = (keys.get("x", False) - keys.get("z", False)) * dt * self.zoom_factor
        return (pos + np.asarray([dx, dy], np.float32),
                np.maximum(zoom + np.float32(dz), np.float32(1e-3)))


def stack_cameras(cams) -> Camera:
    """One batched Camera of a sequence of Cameras (each field gains a
    leading B axis), for raytrace.render_views."""
    cams = list(cams)
    if not cams:
        raise ValueError("stack_cameras needs at least one camera")
    return Camera(pos=torch.stack([c.pos for c in cams]),
                  zoom=torch.stack([c.zoom for c in cams]),
                  vel=torch.stack([c.vel for c in cams]))


def pixel_centers(width: int, height: int, cam: Camera) -> torch.Tensor:
    """Ground-frame positions of pixel centers, (H, W, 2)."""
    larger = max(width, height)
    scale = cam.zoom / larger
    dev = cam.pos.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - (width - 1) / 2.0) * scale
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - (height - 1) / 2.0) * scale
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx + cam.pos[0], yy + cam.pos[1]], dim=-1)


def world_to_pixel(pos: torch.Tensor, width: int, height: int, cam: Camera) -> torch.Tensor:
    """Ground-frame (..., 2) -> fractional pixel coords (..., 2) [x, y], in
    the JAX function's f32 order."""
    larger = max(width, height)
    scale = larger / cam.zoom  # pixels per lightsecond
    rel = (pos - cam.pos) * scale
    # per component with host scalars: no host-to-device copy (and sync)
    return torch.stack([rel[..., 0] + (width - 1) / 2.0, rel[..., 1] + (height - 1) / 2.0],
                       dim=-1)
