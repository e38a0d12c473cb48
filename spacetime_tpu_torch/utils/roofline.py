"""Roofline accounting against the H100 SXM's published peaks (counterpart
of `spacetime_tpu/utils/roofline.py`).

The JAX package rates a compiled program by XLA's static cost analysis
(`cost_of`), which has no counterpart here: PyTorch runs no whole-program
compiler that counts a frame's FLOPs and bytes.  So the port rates each
kernel by the operations and bytes its work needs, counted from its
inputs by the `*_bound` functions below (compare_kernels prints them beside
each kernel's time), against the peaks below.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# the H100 SXM's published dense peaks without sparsity (NVIDIA's data
# sheet), at the card's full power limit: f32 outside the tensor cores, and
# HBM
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# f32 operations of one ray-pair test of the retina march (csrc/retina.cu):
# a (6), b (2), |b|^2 (3), a . b (3), the clamps (3), the division (1), d
# (4), |d|^2 (3), s_hit (2), the two compares and the running minimum (3)
RETINA_OPS = 30


# f32 operations of one segment test of the pair-rows kernel (csrc/pairs.cu):
# the younger endpoint's distance (6), t_a and s_hi (3), the cone bounds
# (3), max, min and their compares (4), |x| and its compare (2), the
# view hull's max / min and compares (8)
PAIR_OPS = 26


class Roofline(NamedTuple):
    """A piece of work on the H100 SXM: the f32 operations it must do and
    the bytes it must move, each input read once and each output written
    once."""

    flops: float
    bytes_accessed: float

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the operations
        over the f32 peak and the bytes over the memory rate."""
        return max(self.flops / F32_FLOPS, self.bytes_accessed / HBM_BYTES_PER_S)

    @property
    def bound_by(self) -> str:
        """'bytes' or 'operations', whichever sets bound_s."""
        return ("bytes" if self.bytes_accessed / HBM_BYTES_PER_S >= self.flops / F32_FLOPS
                else "operations")


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move `nbytes` and do `nops` f32 operations."""
    r = Roofline(flops=nops, bytes_accessed=nbytes)
    return r.bound_s * 1e3, r.bound_by


def collision_bound(pos, active, order, cd, max_disp: float, neighbors=None):
    """The collision kernel's needed work at these inputs: pos, sorted ids
    and cells, the output (and the (N, 8) `neighbors` table of the exclude
    variant) once, the cell_start entries its ranges read; per candidate
    scanned 5 f32 operations (the distance test), per pair inside the
    cutoff 9 id compares when excluding, per contact kept 6.  The scan is
    the square of reach ceil((cd + 2 max_disp) / bin)."""
    side, bres = order.side, float(order.bin_resolution)
    r = min(max(math.ceil((np.float32(cd) + 2 * np.float32(max_disp)) / np.float32(bres)), 1),
            side)
    live = order.sorted_cell < order.n_cells
    c = order.sorted_cell[live].long()
    cy, cx = c // side, c % side
    rows = cy[:, None] + torch.arange(-r, r + 1, device=c.device)[None, :]
    ok = (rows >= 0) & (rows < side)
    lo = (rows * side + (cx - r).clamp(min=0)[:, None])[ok]
    hi = (rows * side + (cx + r).clamp(max=side - 1)[:, None] + 1)[ok]
    cs = order.cell_start.long()
    candidates = int((cs[hi] - cs[lo]).sum())
    starts = int(torch.unique(torch.cat([lo, hi])).numel())
    n = pos.shape[0]
    hits = contacts = 0
    cd2 = cd * cd
    ids = torch.arange(n, device=pos.device)
    for a in range(0, n, 2048):
        d = pos[a:a + 2048, None, :] - pos[None, :, :]
        d2 = (d * d).sum(-1)
        hit = (d2 < cd2) & (d2 > 0) & active[a:a + 2048, None] & active[None, :]
        hits += int(hit.sum())
        if neighbors is not None:
            hit &= ~(neighbors[a:a + 2048, :, None] == ids[None, None, :]).any(1)
        contacts += int(hit.sum())
    exclude = neighbors is not None
    nbytes = n * (8 + 4 + 4 + 8) + 4 * starts + 4 + (32 * n if exclude else 0)
    nops = 5 * candidates + (9 * hits if exclude else 0) + 6 * contacts
    return bound(nbytes, nops)


def pixel_bound(inputs, params, width, height):
    """The pixel pass's needed work: each referenced entry (40 B), the
    per-cell CSR bounds, the retina quads and the scalars read once, the
    planar image written once; ~18 f32 operations per (pixel, candidate of
    its cell), ~60 per pixel of shading, ~30 more for the camera-frame
    unwarp."""
    entries, cell_lo, cell_hi, sfq, scal, wc, hc, ds = inputs
    k = params.cell_px
    count = (cell_hi - cell_lo).clamp(max=params.bin_capacity).long()
    cells = torch.arange(wc * hc, device=count.device)
    pw = (width - (cells % wc) * k).clamp(0, k)
    ph = (height - (cells // wc) * k).clamp(0, k)
    cand = int((count * pw * ph).sum())
    npx = width * height
    nbytes = 40 * int(count.sum()) + 8 * wc * hc + 32 + 12 * npx
    nbytes += 4 * sfq.numel() if sfq is not None else 0
    nops = 18 * cand + (90 if params.camera_frame else 60) * npx
    return bound(nbytes, nops)


def band_bound(buf, params):
    """The band kernel's needed work: the two position planes over the
    swept ages 1..hi0 and the four planes' band + 1 window rows read once,
    a0, alast, the four windows and their ages written once; ~10 f32
    operations per (particle, swept age)."""
    from ..ops.band_cuda import _sweep_bounds

    hi0 = int(_sweep_bounds(buf, params)[3])
    n, w = buf.num_particles, params.band + 1
    nbytes = hi0 * n * 8 + w * n * 16 + 8 * n + 20 * w * n + 8
    return bound(nbytes, 10 * hi0 * n)


def points_bound(capacity: int, width: int, height: int):
    """The points kernel's needed work: pos, active and object ids read
    once, the planar image written once; ~10 f32 operations per
    particle."""
    return bound(capacity * (8 + 1 + 4) + 12 * width * height, 10 * capacity)


def retina_bound(pairs, params):
    """The retina kernel's needed work: each pair row's five fields and its
    validity read once, the ray directions read and s_first written once;
    RETINA_OPS f32 operations per ray and valid pair."""
    rows, n = pairs.pdata.shape[0], params.num_rays
    return bound(21 * rows + 12 * n, RETINA_OPS * n * int(pairs.pair_valid.sum()))


def pairs_bound(bw, params, out_rows: int, kept: int):
    """The pair-rows kernel's needed work at band window `bw`: the window's
    positions and ages read once (12 B per entry), the boundary flags, per
    kept row its velocity and object id (12 B), the out_rows rows and
    flags (41 B each) and the three counts written once; PAIR_OPS f32
    operations per segment."""
    n, w = bw.wx.shape
    nbytes = 12 * n * w + n + 12 * kept + 41 * out_rows + 24
    return bound(nbytes, PAIR_OPS * n * params.band)


def step_bounds(planes, weight: int, breaking: bool):
    """(stage bound, finish bound): the bytes bond_stage and step_finish
    must move at these planes, each read or written once (the partners'
    positions are the stage-position plane, read once), and ~20 f32
    operations a bond slot plus ~30 a particle (the advance, the
    accumulator; the finish's combine)."""
    n = planes.rest_mass.shape[0]
    # pos, pos0, vel0, mass, active, nbr, coll, the accumulator out, next
    per = 8 + 8 + 8 + 4 + 1 + 32 + 8 + 8 + 8
    per += 8 if weight else 0  # the accumulator in, after the first evaluation
    per += sum(4 for t in (planes.k_pp, planes.c_pp) if t is not None)
    per += 8 if planes.c_pp is not None else 0  # the partners' start velocities
    nbytes = n * per + 4 * planes.rest.numel()
    if breaking:
        nbytes += n * 32 + (n * 36 if planes.creep_rate is not None else 0)
        nbytes += 4 * n if planes.break_scale is not None else 0
    return bound(nbytes, n * (8 * 20 + 30)), bound(n * 45, n * 30)
