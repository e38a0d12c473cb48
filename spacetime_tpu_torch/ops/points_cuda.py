"""The non-relativistic point view: the CUDA kernel's wrapper
(`csrc/points.cu`) and its plain-torch version.

Replaces `spacetime_tpu/ops/points_pallas.py` (`_points_kernel`,
`_rasterize_sorted`, `render_points_pallas`), the reference's shipped
renderer: one pixel per active on-screen particle through the camera, the
LOWEST particle index winning a shared pixel, coloured by its object on a
white background.  Both versions return the planar (3, H, W) image, and
the kernel's is bit-equal to the plain version's: an integer minimum
decides every pixel, so the order of the device's atomics does not matter.

The TPU kernel caps each group's entry window at `wmax` chunks and counts
what it drops in `PointsDiag.window_truncated`; neither version here has a
cap, so the count is 0 by construction.  The field stays so callers that
read the diagnostics keep their shape.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  The kernel works in two scratch buffers
that the wrapper keeps between calls, one pair per (device, stream) for the
latest image size: a winner slot per pixel at EMPTY and an occupancy mask
of one bit a pixel at 0, which every render leaves as it found them.  A
launch that fails drops them, so the next call starts from fresh ones.

A captured CUDA graph (fused.py) holds the raw pointers of the pair of the
stream it was captured on, so that pair is made before the capture (by the
eager frame the capture follows, on the same stream) and the graph keeps a
reference to it; a render under capture that would make a pair raises.
Eager calls on other streams use their own pairs, never the graph's.

On a mesh (parallel/; `render_points_mesh`) the passes split around a
collective: each rank's winner pass (`points_winners`) writes its block's
GLOBAL particle indices into a winner plane of its own (all EMPTY, no
mask, no kept scratch), one MIN all-reduce merges the ranks' planes (an
integer minimum: exact in any order), and the resolve pass
(`points_resolve`) colours the merged plane with the replicated object
index.  The pair counts as one `points` launch, at its winner pass.  The
JAX package takes its XLA scatter on a mesh (engine.py:137-138); the port
keeps its kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..camera import world_to_pixel
from ..parallel import comm

EMPTY = 2**31 - 1  # a free winner slot (INT32_MAX, so any capacity fits below it)

# (device index, stream handle) -> (height, width, winner (H * W,) i32,
# mask (ceil(H * W / 32),) i32)
_scratch: dict = {}


class PointsDiag(NamedTuple):
    window_truncated: torch.Tensor  # () i64: always 0 (no window cap)


def render_points_plain(particles, objects, cam, width: int, height: int) -> torch.Tensor:
    """Pixel of each particle as `world_to_pixel` computes it, rounded half
    to even (torch.round, as jnp.round); the minimum particle index per
    pixel by `scatter_reduce_(..., "amin")`; then the winners' colours on
    white.  Returns (3, H, W) f32."""
    n = particles.capacity
    dev = particles.pos.device
    px = torch.round(world_to_pixel(particles.pos, width, height, cam))
    x, y = px[:, 0], px[:, 1]
    # compared as floats, so far-off-screen coordinates never reach an
    # integer conversion
    inside = particles.active & (x >= 0) & (x < width) & (y >= 0) & (y < height)
    hw = width * height
    xi = torch.where(inside, x, 0.0).long()
    yi = torch.where(inside, y, 0.0).long()
    flat = torch.where(inside, yi * width + xi, hw)  # hw = a dump slot
    winner = torch.full((hw + 1,), n, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat, torch.arange(n, device=dev), "amin")
    winner = winner[:hw]
    covered = winner < n
    color = objects.base_color[particles.object_index.long()]  # (N, 3)
    img = torch.where(covered[None, :], color[winner.clamp(max=n - 1)].T, 1.0)
    return img.reshape(3, height, width)


def scratch(dev, stream: int, width: int, height: int):
    """The (winner, mask) scratch of `dev` and `stream` for a width x height
    image: kept from the last call of that size, else made fresh (all
    EMPTY, all 0), replacing one of another size."""
    key = (dev.index, stream)
    held = _scratch.get(key)
    if held is None or held[:2] != (height, width):
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("render_points: the points scratch of the capturing stream "
                               "must exist before a CUDA graph capture (run the frame once "
                               "on that stream first)")
        hw = width * height
        held = (height, width, torch.full((hw,), EMPTY, dtype=torch.int32, device=dev),
                torch.zeros(((hw + 31) // 32,), dtype=torch.int32, device=dev))
        _scratch[key] = held
    return held[2], held[3]


def held(dev, stream: int):
    """The (winner, mask) scratch kept for `dev` and `stream`, or None."""
    held_pair = _scratch.get((dev.index, stream))
    return None if held_pair is None else held_pair[2:]


def _need(dev, t, name, dtype, shape):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `dev`."""
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"render_points: {name} must be contiguous {dtype} {shape} on {dev}")


def render_points(particles, objects, cam, width: int, height: int) -> torch.Tensor:
    """(3, H, W) point view (see render_points_plain).  CPU tensors take the
    plain version; CUDA tensors launch `points_launch` (its two kernels
    count as one launch) on the current stream's scratch."""
    dev = particles.pos.device
    if dev.type == "cpu":
        return render_points_plain(particles, objects, cam, width, height)
    if dev.type != "cuda":
        raise ValueError(f"render_points: unsupported device {dev}")
    n = particles.capacity
    _need(dev, particles.pos, "pos", torch.float32, (n, 2))
    _need(dev, particles.active, "active", torch.bool, (n,))
    _need(dev, particles.object_index, "object_index", torch.int32, (n,))
    _need(dev, objects.base_color, "base_color", torch.float32, (objects.base_color.shape[0], 3))
    _need(dev, cam.pos, "cam.pos", torch.float32, (2,))
    _need(dev, cam.zoom, "cam.zoom", torch.float32, ())
    if (width * height + 1) * 3 >= 2 ** 31:
        raise ValueError(f"render_points: a {width}x{height} image exceeds int32 pixel indices")
    lib = kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    winner, mask = scratch(dev, stream, width, height)
    out = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    status = lib.points_launch(
        particles.pos.data_ptr(), particles.active.data_ptr(), cam.pos.data_ptr(),
        cam.zoom.data_ptr(), particles.object_index.data_ptr(), objects.base_color.data_ptr(),
        n, width, height, winner.data_ptr(), mask.data_ptr(), out.data_ptr(), stream,
    )
    if status != 0:
        # pass 1 may have run without pass 2: no slot or bit may outlive it
        _scratch.pop((dev.index, stream), None)
    kernels.check(status, "points")
    kernels.launches["points"] += 1
    return out


def points_winners_plain(particles, cam, width: int, height: int, index0: int) -> torch.Tensor:
    """(H * W,) i32 winner plane of the particles numbered index0.. (a
    mesh rank's block): the lowest index whose pixel it is, EMPTY where
    none lands (render_points_plain's pixel rule)."""
    n = particles.capacity
    dev = particles.pos.device
    px = torch.round(world_to_pixel(particles.pos, width, height, cam))
    x, y = px[:, 0], px[:, 1]
    inside = particles.active & (x >= 0) & (x < width) & (y >= 0) & (y < height)
    hw = width * height
    flat = torch.where(inside, torch.where(inside, y, 0.0).long() * width
                       + torch.where(inside, x, 0.0).long(), hw)
    winner = torch.full((hw + 1,), EMPTY, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, flat, torch.arange(index0, index0 + n, dtype=torch.int32,
                                                 device=dev), "amin")
    return winner[:hw]


def points_winners(particles, cam, width: int, height: int, index0: int) -> torch.Tensor:
    """points_winners_plain for CPU tensors; CUDA tensors launch
    `points_winner_launch` (counted as a `points` launch)."""
    dev = particles.pos.device
    if dev.type == "cpu":
        return points_winners_plain(particles, cam, width, height, index0)
    if dev.type != "cuda":
        raise ValueError(f"render_points: unsupported device {dev}")
    n = particles.capacity
    _need(dev, particles.pos, "pos", torch.float32, (n, 2))
    _need(dev, particles.active, "active", torch.bool, (n,))
    _need(dev, cam.pos, "cam.pos", torch.float32, (2,))
    _need(dev, cam.zoom, "cam.zoom", torch.float32, ())
    if (width * height + 1) * 3 >= 2 ** 31 or index0 + n >= EMPTY:
        raise ValueError(f"render_points: a {width}x{height} image or {index0 + n} particles "
                         "exceed int32 indices")
    winner = torch.full((width * height,), EMPTY, dtype=torch.int32, device=dev)
    status = kernels.library().points_winner_launch(
        particles.pos.data_ptr(), particles.active.data_ptr(), cam.pos.data_ptr(),
        cam.zoom.data_ptr(), n, index0, width, height, winner.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(status, "points")
    kernels.launches["points"] += 1
    return winner


def points_resolve_plain(winner, object_index, objects, width: int, height: int):
    """(3, H, W): the winners' object colours on white."""
    covered = winner != EMPTY
    color = objects.base_color[object_index.long()[torch.where(covered, winner, 0).long()]]
    img = torch.where(covered[None, :], color.T, 1.0)
    return img.reshape(3, height, width)


def points_resolve(winner, object_index, objects, width: int, height: int):
    """points_resolve_plain for CPU tensors; CUDA tensors launch
    `points_resolve_dense_launch` (the second pass of the `points` launch
    its winners counted)."""
    dev = winner.device
    if dev.type == "cpu":
        return points_resolve_plain(winner, object_index, objects, width, height)
    if dev.type != "cuda":
        raise ValueError(f"render_points: unsupported device {dev}")
    _need(dev, winner, "winner", torch.int32, (width * height,))
    _need(dev, object_index, "object_index", torch.int32, (object_index.shape[0],))
    _need(dev, objects.base_color, "base_color", torch.float32,
          (objects.base_color.shape[0], 3))
    out = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    status = kernels.library().points_resolve_dense_launch(
        winner.data_ptr(), object_index.data_ptr(), objects.base_color.data_ptr(), width,
        height, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(status, "points")
    return out


def render_points_mesh(particles, objects, cam, width: int, height: int, mesh,
                       object_index: torch.Tensor) -> torch.Tensor:
    """(3, H, W) point view of a mesh: `particles` is this rank's block,
    `object_index` the replicated global one (see the module docstring);
    every rank gets the whole image."""
    winner = points_winners(particles, cam, width, height, mesh.rank * particles.capacity)
    winner = comm.all_reduce(winner, mesh, "min")
    return points_resolve(winner, object_index, objects, width, height)
