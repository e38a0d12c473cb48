"""The point view, in plain torch: every active particle lights the pixel
its position falls in (rounded half to even), the lowest-numbered
particle winning a pixel, in its body's colour on white.  Pixel
coordinates follow the viewer's mapping, in f32 and in this order:
(pos - cam) * (max(W, H) / zoom) + ((W - 1) / 2, (H - 1) / 2)."""

from __future__ import annotations

import torch


def render(pos, active, body, colors, cam_pos, zoom, width: int, height: int,
           dtype=torch.float32):
    """(3, H, W) f32.  `body` indexes the rows of `colors` ((bodies, 3));
    the pixel arithmetic runs in `dtype`."""
    n = pos.shape[0]
    pos, cam_pos, zoom = pos.to(dtype), cam_pos.to(dtype), zoom.to(dtype)
    rel = (pos - cam_pos) * (max(width, height) / zoom)
    x = torch.round(rel[:, 0] + (width - 1) / 2.0)
    y = torch.round(rel[:, 1] + (height - 1) / 2.0)
    inside = active & (x >= 0) & (x < width) & (y >= 0) & (y < height)
    hw = width * height
    flat = torch.where(inside, torch.where(inside, y, 0.0).long() * width
                       + torch.where(inside, x, 0.0).long(), hw)
    winner = torch.full((hw + 1,), n, dtype=torch.int64, device=pos.device)
    winner.scatter_reduce_(0, flat, torch.arange(n, device=pos.device), "amin")
    winner = winner[:hw]
    lit = winner < n
    rgb = colors[body.long()][winner.clamp(max=n - 1)]  # (hw, 3)
    img = torch.where(lit[:, None], rgb, 1.0)
    return img.T.reshape(3, height, width).contiguous()


# the check's entry points (../check.py, found by spec.mode_reference)

CONFIG_KEYS = frozenset()  # configuration keys read beyond check.CONFIG_KEYS
RENDER = {}  # the point view reads no field of the render block
FULL_RING = False  # the check reads the pushed row of the ring only


def image(s, after, ring, colors, config, dtype=torch.float32):
    """The (3, H, W) image of the frame of check.Sample `s` from the
    particles `after` its tick, and no counters (`config`, the values of
    CONFIG_KEYS, is empty)."""
    pos, zoom, _ = s.cam
    return render(after["pos"], after["active"], after["object_index"], colors, pos, zoom,
                  s.image.shape[2], s.image.shape[1], dtype), {}


def control(s, after, colors, config):
    """The bfloat16 control's image: `image` with its pixel arithmetic in
    bfloat16."""
    return image(s, after, s.ring, colors, config, torch.bfloat16)
