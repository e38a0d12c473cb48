"""The light-cone band search: the CUDA kernel's wrapper (`csrc/band.cu`)
and its plain-torch version.

Replaces `spacetime_tpu/ops/band_pallas.py` (`_band_kernel`,
`cone_band_window_pallas`) and the dense XLA sweep of
`spacetime_tpu/ops/raytrace.py` `_cone_band_window`, which the reference
runs by default.  Both versions return a `BandWindow`: per particle the
youngest age a0 entering the cone band, the oldest crossing age alast, the
count of particles whose crossing outlasts the band, and the (N, band + 1)
window of the four ring planes at ages [a0 + band - 1 .. a0 - 1] as
ascending mirrored rows.  The kernel's results are bit-equal to the plain
version's.  `RenderParams.band_kernel`, the reference's opt-in switch
between the two TPU paths, is not ported: CUDA tensors always take the
kernel.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  The kernel, like the reference's Pallas
kernel, knows only the Euclidean route: a caller with another cone metric
(`route_lengths`, the curved renderers' geodesic routes) calls the plain
sweep itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels


class BandWindow(NamedTuple):
    a0: torch.Tensor  # (N,) i32 youngest entering age (hi0 + 1 = none)
    alast: torch.Tensor  # (N,) i32 oldest crossing age (-1 = none)
    hi0: torch.Tensor  # () i32 oldest usable age
    truncated: torch.Tensor  # () i64 particles with alast >= a0 + band
    wx: torch.Tensor  # (N, band + 1) f32 window rows, ascending
    wy: torch.Tensor
    wvx: torch.Tensor
    wvy: torch.Tensor
    ages: torch.Tensor  # (N, band + 1) i32 age of each window row


def _swept_ages(buf, params) -> int:
    """The number of ages the sweep scans: max_age, capped by the ring."""
    t_cap = buf.capacity
    return t_cap if params.max_age <= 0 else min(params.max_age, t_cap)


def _sweep_bounds(buf, params):
    """(base_col, a_sw, col0, hi0): the mirrored row of age 0, the swept age
    count, the first swept row (rows col0.. hold ages a_sw - 1 .. 0) and
    the oldest usable age, clamped so that no window column (or its younger
    endpoint) reaches an unswept tick.  `a_sw` depends on the params and the
    capacity alone and is a host int; the others follow the ring's cursor
    and in-use count and are () i32 tensors on its device (csrc/band.cu
    computes the same three from them on the device)."""
    t_cap = buf.capacity
    base_col = buf.cursor + t_cap
    a_sw = _swept_ages(buf, params)
    col0 = buf.cursor + (1 + t_cap - a_sw)
    hi0 = torch.clamp(buf.frames_in_use - 1, max=min(t_cap - 1, a_sw - 1))
    return base_col, a_sw, col0, hi0


def cone_band_window_plain(buf, params, cam, route_lengths=None) -> BandWindow:
    """Each particle's cone-crossing tick band and its window, by one dense
    sweep over the swept ages.

    Because |v| < c while the cone radius grows at c per tick,
    f(age) = route(pos(age)) - age * dt is monotone, so each worldline
    crosses the cone in one contiguous band.  One dense sweep over ages
    [0, A) finds the youngest entering age a0 and the oldest crossing age;
    the window holds ages [a0 + band - 1 .. a0 - 1] as ascending mirrored
    rows, read by one gather.  Window rows outside the swept ages hold the
    ring's values there; they only feed pairs that fail the age-range
    validity.  `route_lengths(qx, qy)` is the cone metric, the Euclidean
    distance to the camera by default (curved modes pass their geodesic
    route lengths)."""
    from .raytrace import _euclid_route  # raytrace imports this module

    dt, rho, band = params.dt, params.rho, params.band
    t_cap = buf.capacity
    n = buf.num_particles
    dev = buf.pos_x.device
    thresh = rho + dt
    base_col, a_sw, col0, hi0 = _sweep_bounds(buf, params)
    route = route_lengths or _euclid_route(cam.pos[0], cam.pos[1])

    # the swept rows col0 .. col0 + a_sw - 1, gathered by a device index
    rows = col0 + torch.arange(a_sw, dtype=torch.int32, device=dev)
    sx = buf.pos_x.index_select(0, rows)
    sy = buf.pos_y.index_select(0, rows)
    age_row = torch.arange(a_sw - 1, -1, -1, dtype=torch.int32, device=dev)[:, None]
    f = route(sx, sy) - age_row.to(torch.float32) * dt
    in_range = (age_row >= 1) & (age_row <= hi0)
    enter = (f <= thresh) & in_range
    a0 = torch.where(enter, age_row, hi0 + 1).amin(dim=0)
    crossing = enter & (f >= -thresh)
    a_last = torch.where(crossing, age_row, -1).amax(dim=0)
    truncated = (a_last >= a0 + band).sum()

    w = band + 1
    start_col = torch.clamp(base_col - (a0 + band - 1), 0, 2 * t_cap - w)
    rows = start_col[:, None] + torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    ages = base_col - rows
    rows = rows.long()
    cols = torch.arange(n, device=dev)[:, None]
    window = lambda plane: plane[rows, cols]  # (N, w)
    return BandWindow(a0, a_last, hi0, truncated, window(buf.pos_x), window(buf.pos_y),
                      window(buf.vel_x), window(buf.vel_y), ages)


def cone_band_window(buf, params, cam) -> BandWindow:
    """The band window of `buf` seen from `cam` (see cone_band_window_plain).
    CPU tensors take the plain version; CUDA tensors launch
    `band_window_launch`, which reads cam.pos and the ring's cursor and
    in-use count on the device: no host sync, and a captured graph replays
    it at whatever cursor the ring has."""
    dev = buf.pos_x.device
    if dev.type == "cpu":
        return cone_band_window_plain(buf, params, cam)
    if dev.type != "cuda":
        raise ValueError(f"cone_band_window: unsupported device {dev}")
    t2, n = buf.pos_x.shape
    for name in ("pos_x", "pos_y", "vel_x", "vel_y"):
        plane = getattr(buf, name)
        if plane.dtype != torch.float32 or plane.shape != (t2, n) or not plane.is_contiguous():
            raise ValueError(f"cone_band_window: {name} must be contiguous float32 ({t2}, {n})")
    pos = cam.pos
    if (pos.dtype != torch.float32 or pos.shape != (2,) or not pos.is_contiguous()
            or pos.device != dev):
        raise ValueError(f"cone_band_window: cam.pos must be contiguous float32 (2,) on {dev}")
    band = params.band
    w = band + 1
    if w > t2:
        raise ValueError(f"cone_band_window: band {band} exceeds the ring's {t2} rows")
    for name in ("cursor", "frames_in_use"):
        t = getattr(buf, name)
        if t.dtype != torch.int32 or t.shape != () or t.device != dev:
            raise ValueError(f"cone_band_window: {name} must be an int32 () tensor on {dev}")
    a_sw = _swept_ages(buf, params)
    # one buffer for a0, alast and hi0 and one for the four windows (fewer
    # host allocations a call); each output is a contiguous part of its buffer
    ints = torch.empty((2 * n + 1,), dtype=torch.int32, device=dev)
    a0, alast, hi0 = ints[:n], ints[n:2 * n], ints[2 * n]
    wins = torch.empty((4, n, w), dtype=torch.float32, device=dev)
    ages = torch.empty((n, w), dtype=torch.int32, device=dev)
    truncated = torch.zeros((), dtype=torch.int64, device=dev)
    status = kernels.library().band_window_launch(
        buf.pos_x.data_ptr(), buf.pos_y.data_ptr(), buf.vel_x.data_ptr(), buf.vel_y.data_ptr(),
        pos.data_ptr(), buf.cursor.data_ptr(), buf.frames_in_use.data_ptr(), n, t2, a_sw,
        band, float(np.float32(params.dt)), float(np.float32(params.rho + params.dt)),
        a0.data_ptr(), alast.data_ptr(), hi0.data_ptr(), *(t.data_ptr() for t in wins),
        ages.data_ptr(), truncated.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(status, "band")
    kernels.launches["band"] += 1
    return BandWindow(a0, alast, hi0, truncated, *wins, ages)
