"""3D spacetime view of the worldline ring.

Counterpart of `spacetime_tpu/ops/worldline3d.py`: an orthographic view of
every stored worldline sample as a point in (x, y, t)-space, with a free
azimuth and elevation, the nearest sample winning each pixel.  The history
is read as dense (A, N) planes from the mirrored ring (one `index_select`
by the device cursor); hidden-surface removal is one
`scatter_reduce_(..., "amin", include_self=True)` of int32 keys packing
(quantized depth << 15 | r5 << 10 | g5 << 5 | b5) into a buffer filled
with _BG, so the winner carries its own colour.  Samples fade toward the
white background with lookback.  All of it is plain torch on every device,
as the JAX package runs it in XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..camera import Camera
from ..state import Objects
from .worldline import WorldlineBuffer

_BG = 1 << 28  # > any packed sample (depth 12 bits | rgb 15 bits = 27 bits)
_ON_SCREEN_SENTINEL = 1e30  # masks off-screen samples out of the depth range


@dataclasses.dataclass(frozen=True)
class Worldline3DParams:
    """Static view parameters (hashable: part of the fused frame's key).

    `elevation` pi/2 looks straight down the time axis (the ordinary 2D
    view); 0 is edge-on with the past extending down-screen.  `azimuth`
    spins the spatial plane about the time axis.  `time_scale` converts one
    lightsecond of lookback into vertical lightseconds on screen."""

    azimuth: float = 0.65  # radians about the t axis
    elevation: float = 0.95  # radians; pi/2 = top-down
    time_scale: float = 0.35
    max_age: int = 0  # ticks of history drawn; 0 = the full ring
    age_stride: int = 1  # draw every k-th tick (cheap long-history views)
    fade: float = 0.8  # 0 = flat colors, 1 = oldest samples fully white
    shell_only: bool = True  # boundary particles only; False draws solid interiors


def _f32_trig(angle: float):
    """(cos, sin) of an f32 angle, rounded to f32 (the JAX package takes
    them of a weakly typed f32 scalar)."""
    a = torch.tensor(angle, dtype=torch.float32)
    return float(torch.cos(a)), float(torch.sin(a))


def render_worldline3d(buf: WorldlineBuffer, object_index: torch.Tensor, objects: Objects,
                       cam: Camera, width: int, height: int, params: Worldline3DParams,
                       active: Optional[torch.Tensor] = None,
                       boundary: Optional[torch.Tensor] = None,
                       planar: bool = False) -> torch.Tensor:
    """(H, W, 3) f32 image in [0, 1], or (3, H, W) with `planar`: the
    spacetime block seen side-on.  `cam.pos` / `cam.zoom` pan and scale
    the spatial axes as in the 2D modes; `boundary` ((N,) bool) selects
    the shell samples when params.shell_only."""
    t_cap = buf.capacity
    dev = buf.pos_x.device
    a_all = t_cap if params.max_age <= 0 else min(params.max_age, t_cap)
    stride = max(1, params.age_stride)
    # the stride anchors at the newest row (age 0, the present-time front
    # face of the block), so it starts at (a_all - 1) % stride
    off = (a_all - 1) % stride
    rows = buf.cursor + (1 + t_cap - a_all) + torch.arange(
        off, a_all, stride, dtype=torch.int32, device=dev)
    sx = buf.pos_x.index_select(0, rows)
    sy = buf.pos_y.index_select(0, rows)
    age = torch.arange(a_all - 1, -1, -1, dtype=torch.float32, device=dev)[off::stride, None]

    # tick spacing from the ring's two newest stored times
    t_new = buf.times.index_select(0, buf.cursor.reshape(1))[0]
    t_prev = buf.times.index_select(0, ((buf.cursor - 1) % t_cap).reshape(1))[0]
    tick = torch.where(torch.isfinite(t_prev), torch.clamp(t_new - t_prev, min=1e-9), 1.0)

    hi = torch.clamp(buf.frames_in_use - 1, max=a_all - 1).to(torch.float32)
    valid = age <= hi  # (A', 1): unwritten slots hold 1e9, masked anyway
    if active is not None:
        valid = valid & active[None, :]
    if params.shell_only and boundary is not None:
        valid = valid & boundary[None, :]

    # (x, y, t) relative to the camera centre, t = -lookback (past below)
    rx = sx - cam.pos[0]
    ry = sy - cam.pos[1]
    rt = -age * tick * params.time_scale  # (A', 1), broadcasts
    ca, sa = _f32_trig(params.azimuth)
    ce, se = _f32_trig(params.elevation)
    xr = ca * rx + sa * ry
    yr = -sa * rx + ca * ry
    u = xr
    v = yr * se - rt * ce  # elevation pi/2: v = yr (top-down)
    depth = -(yr * ce + rt * se)  # smaller = nearer; top-down: depth = age

    # a divide, as JAX does (torch's `int / tensor` multiplies by a reciprocal)
    scale = torch.full_like(cam.zoom, max(width, height)) / cam.zoom
    # clamped before the int cast (far samples would overflow i32); a value
    # at a clamp bound is off-screen either way
    xi = torch.round(u * scale + (width - 1) / 2.0).clamp(-1, width).to(torch.int32)
    yi = torch.round(v * scale + (height - 1) / 2.0).clamp(-1, height).to(torch.int32)
    inside = valid & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)

    # depth quantized over the drawn samples' own range (a zoom-based bound
    # would clamp at low elevation and let packed colour decide occlusion)
    d_lo = torch.where(inside, depth, _ON_SCREEN_SENTINEL).amin()
    d_hi = torch.where(inside, depth, -_ON_SCREEN_SENTINEL).amax()
    span = torch.clamp(d_hi - d_lo, min=1e-6)
    dq = torch.clamp(torch.round((depth - d_lo) / span * 4095.0), 0.0, 4095.0).to(torch.int32)

    # per-sample colour: the object's base colour faded toward white with age
    base = objects.base_color[object_index.long()]  # (N, 3)
    f = torch.clamp((age / torch.clamp(hi, min=1.0)) * params.fade, 0.0, 1.0)  # (A', 1)

    def chan(c):  # (N,) -> (A', N) 5-bit faded channel
        plane = c[None, :] * (1.0 - f) + f
        return torch.round(torch.clamp(plane, 0.0, 1.0) * 31.0).to(torch.int32)

    packed = (dq << 15) | (chan(base[:, 0]) << 10) | (chan(base[:, 1]) << 5) | chan(base[:, 2])
    lin = torch.where(inside, yi * width + xi, width * height)
    flat = torch.full((width * height + 1,), _BG, dtype=torch.int32, device=dev)
    flat.scatter_reduce_(0, lin.reshape(-1).long(), packed.reshape(-1), "amin",
                         include_self=True)
    flat = flat[:width * height]

    hit = flat < _BG
    img = torch.stack([torch.where(hit, ((flat >> s) & 31).to(torch.float32) / 31.0, 1.0)
                       for s in (10, 5, 0)])
    img = img.reshape(3, height, width)
    return img if planar else img.permute(1, 2, 0).contiguous()
