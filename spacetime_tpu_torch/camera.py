"""Camera: a ground-frame position, a zoom (lightseconds per screen along the
larger window axis) and a ground-frame velocity for observer Doppler.
Counterpart of `spacetime_tpu/camera.py`."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor  # (2,) f32 — ground-frame position, lightseconds
    zoom: torch.Tensor  # () f32 — lightseconds per screen (larger axis)
    vel: torch.Tensor  # (2,) f32 — ground-frame velocity

    @staticmethod
    def create(pos=(0.5, 0.5), zoom=1.0, vel=(0.0, 0.0), device="cpu") -> "Camera":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return Camera(pos=f(pos), zoom=f(zoom), vel=f(vel))

    def to(self, device) -> "Camera":
        return Camera(pos=self.pos.to(device), zoom=self.zoom.to(device),
                      vel=self.vel.to(device))


def pixel_centers(width: int, height: int, cam: Camera) -> torch.Tensor:
    """Ground-frame positions of pixel centers, (H, W, 2)."""
    larger = max(width, height)
    scale = cam.zoom / larger
    dev = cam.pos.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - (width - 1) / 2.0) * scale
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - (height - 1) / 2.0) * scale
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx + cam.pos[0], yy + cam.pos[1]], dim=-1)
