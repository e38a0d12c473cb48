"""Non-relativistic point renderer: the reference's shipped debug view.

Counterpart of `spacetime_tpu/ops/rasterize.py`, the Engine's points mode:
every particle is one pixel straight from the physics state, camera pan +
zoom, coloured by object, white background, no light-travel delay.  The
work is ops/points_cuda.py: its CUDA kernel for CUDA tensors, its plain
version for CPU ones.  Overlapping particles resolve to the lowest index
(the reference's point pipeline leaves the order unspecified).
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..state import Objects, Particles
from . import points_cuda


def render_points(particles: Particles, objects: Objects, cam: Camera,
                  width: int = 1280, height: int = 720, planar: bool = False) -> torch.Tensor:
    """(H, W, 3) f32 image in [0, 1], white background, or (3, H, W) with
    `planar`."""
    img = points_cuda.render_points(particles, objects, cam, width, height)
    return img if planar else img.permute(1, 2, 0)
