"""Retarded-time raytracer over the worldline ring (flat spacetime).

Counterpart of the flat retarded and instantaneous paths of
`spacetime_tpu/ops/raytrace.py`.  What map point p shows is what the
camera at c sees of p at coordinate time t_now: the event
(p, t_now - |p - c|) on its past light cone.  Softbodies are unions of
radius-rho discs; between stored ticks each disc sweeps a linear capsule
in (x, y, t).

Per frame (`render_retarded`):
  1. the cone band search (ops/band_cuda.py: the band kernel, csrc/band.cu,
     on the card, a dense sweep over every swept age on the CPU; the JAX
     package's module docstring, `spacetime_tpu/ops/raytrace.py:28-34`,
     still describes a binary search, but both packages sweep densely)
     finds each particle's cone-crossing tick band; its (N, band) segments
     become pair rows of 10 fields (`_F_*`), culled to the view hull.  With
     `retarded=False` (the instantaneous view) `_instant_pairs` takes its
     place: each particle's newest segment only, and no occlusion.
  2. compaction to `pair_budget`; with a boundary mask, boundary pairs go to
     the front so the occlusion retina reads a prefix of `retina_budget`.
  `_frame_pairs` does both: on the card (no mesh) the pair-rows kernel
  (ops/pairs_cuda.py, csrc/pairs.cu) writes the compacted rows from the
  band kernel's window; on the CPU and on a mesh the plain chain
  (`_band_pairs`, then `_compact_pairs`) builds all N * k rows and sorts
  them.
  3. `_retina`: the first hit per angle over the retina pairs (ops/
     retina_cuda.py: a CUDA kernel on the card, a chunked march on the CPU).
  4. `_splat_csr`: every pair splats into the view cells (k x k pixel
     blocks) its capsule can reach; a stable sort on (cell, quantized
     distance) keys yields a per-cell CSR of entries, nearest first,
     keeping `bin_capacity` per cell and an `entry_budget` prefix.
  5. the pixel pass (ops/render_cuda.py): per pixel, the nearest in-time
     capsule of its cell, Doppler/beaming shading and occlusion.

With `camera_frame` (the boosted view, ops/boost.py) the view cells and
pixels live in the camera's rest frame: step 4 splats each pair's warped
centre with its reach scaled by `boost.stretch`, the retina lookup and the
pixel pass unwarp each pixel to its ground query point, and step 1 skips
the view-hull cull, since the view's ground footprint goes beyond the
output rect.

With `0 < segments < band`, step 1 keeps each particle's first `segments`
valid crossings in age order (rank compaction) and counts the rest in
`RenderDiag.segment_dropped`.  `splat_cells=4` splats into the 2x2 cells
nearest the pair's centre instead of the 3x3 block.

`render_retina` is the observer's own 360-degree view: the band search
without the view cull, a ray march over every pair that keeps the winner's
shading fields, and aberration and Doppler shading, as a 1D strip.
`render_views` renders B cameras from one ring.

The curved renderers (ops/curved.py, ops/btz.py) reuse steps 1-4 with their own cone
metric (`_band_pairs`' `route_lengths`) and replace step 5 by a dense
per-cell route pass: `_build_view_tables` pads each cell's CSR run to
bin_capacity rows (the JAX package's `_splat_vslot` table, in the same
order), and `_cell_pixel_coords`, `_occupancy_cells`, `_field_at` and
`_assemble_image` test every pixel of a cell against its table, in blocks
of cells (`ROUTE_PASS_ELEMENTS`).

Steps 1 and 2 (on the Euclidean route), 3 (ops/retina_cuda.py) and 5 have
CUDA kernels; the splat, the route pass, the curved modes' compaction and
the retina mode's march are plain torch on every device (in the JAX
package they are XLA, not Pallas).

On a mesh (`mesh`, parallel/; the JAX render under GSPMD,
`spacetime_tpu/ops/raytrace.py:196-199, 1612-1613, 1671`) the ring holds
this rank's particle columns.  Step 1 runs on them, then one all-gather of
the pair rows in rank order (`_gather_pairs`, never a ring plane) and one
all-reduce of the band counters rebuild the single-device pair layout, so
steps 2-4 run replicated and give every rank the same CSR and the same
diagnostics.  Each rank shades its band of view-cell rows in step 5, and
one all-gather assembles the image (`_mesh_pixel_pass`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..camera import Camera, pixel_centers
from ..constants import C2
from ..parallel import comm
from ..state import Objects
from ..utils.profiling import spanned
from . import band_cuda, boost, pairs_cuda, render_cuda, retina_cuda
from .worldline import WorldlineBuffer, newest_time, row_at_age

_BIG = 3.0e38
_PI = np.float32(np.pi)
_DQ = 64  # splat-key distance-quantization levels (nearest-k bin retention)


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static renderer configuration (the JAX package's fields that the port's
    renderers read; same names, same defaults).  It is the fused frame's
    key, so every field is part of it."""

    dt: float = 0.005  # history tick spacing (= PhysicsParams.h when pushed every step)
    rho: float = 0.0026  # particle render radius
    band: int = 6  # cone-crossing ticks kept per particle
    segments: int = 0  # valid crossings kept per particle when 0 < segments < band
    bin_capacity: int = 64  # candidates kept per view cell, nearest first
    num_rays: int = 2048  # 1D retina resolution (occlusion only)
    ray_chunk: int = 8192  # pairs per chunk of the retina march
    cell_px: int = 16  # view-cell edge in pixels; k * pixel_size must be >= reach
    # cells a pair splats into: 9 (the 3x3 block) or 4 (the 2x2 nearest its
    # centre, exact while the reach is at most half a cell)
    splat_cells: int = 9
    pair_budget: int = 131072  # compact valid pairs to this many rows (0 = never)
    entry_budget: int = 0  # cap on sorted splat entries (0 = all)
    opaque: bool = True  # False = x-ray: no occlusion shading
    retarded: bool = True  # False = instantaneous view (newest segment, no occlusion)
    camera_frame: bool = False  # boosted map view (ops/boost.py); needs retarded=True
    occlusion_downsample: int = 2  # retina lookup per d x d pixel quad
    max_age: int = 0  # oldest age (ticks) the cone sweep scans; 0 = the ring
    retina_budget: int = 8192  # boundary-pair budget of the occlusion retina
    doppler: bool = True
    beaming: bool = True
    doppler_strength: float = 1.0
    spectral: bool = False  # exact blackbody Doppler photometry
    spectral_temp: float = 6500.0  # rest-frame emitter temperature (K)
    ambient: float = 0.15  # fraction of unshifted base color mixed in
    absorbed_dim: float = 0.35  # brightness of matter hidden behind other matter
    shadow: float = 0.78  # background brightness in occluded regions
    # the btz mode only (ops/btz.py): also the routes reflected once off the
    # AdS boundary; `btz_windings` extra turns around the hole per route
    # family; the full rotating-metric solve (ops/btz_exact.py) instead of
    # the slow-rotation model
    btz_reflections: bool = False
    btz_windings: int = 0
    btz_exact_spin: bool = False

    @property
    def reach(self) -> float:
        """Max capsule reach: rho + half a max-speed tick of motion."""
        return self.rho + 0.5 * self.dt


def auto_cell_px(params: RenderParams, width: int, height: int, zoom: float) -> int:
    """Smallest view-cell edge (pixels) satisfying the coverage constraint
    cell_px * pixel_size >= reach, so a capsule splatted into its 3x3 cells
    is visible from every pixel it can cover.  Like the JAX function it
    ignores `splat_cells`; `RenderDiag.cell_too_small` reports a 2x2 splat
    whose cells are under twice the reach."""
    pixel_size = zoom / max(width, height)
    return max(1, int(-(-params.reach // pixel_size)))


class RenderDiag(NamedTuple):
    pairs_used: torch.Tensor  # valid cone-crossing segments this frame
    band_truncated: torch.Tensor  # particles whose crossing outlasts the band
    bin_dropped: torch.Tensor  # splat entries beyond bin_capacity
    cell_too_small: torch.Tensor  # bool: cell_px violates the coverage constraint
    retina_dropped: object = None  # boundary pairs beyond retina_budget
    entry_dropped: object = None  # valid splat entries beyond entry_budget
    segment_dropped: object = None  # valid crossings beyond params.segments


class PairData(NamedTuple):
    """Cone-crossing segments, one row of the 10 `_F_*` fields each."""

    pdata: torch.Tensor  # (rows, 10) f32
    pair_valid: torch.Tensor  # (rows,) bool
    n_pairs: torch.Tensor  # () i64, valid pairs before any budget


_F_AX, _F_AY, _F_BX, _F_BY, _F_TA, _F_VX, _F_VY, _F_CR, _F_CG, _F_CB = range(10)

# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------


def _gamma_xy(vx, vy):
    return 1.0 / torch.sqrt(torch.clamp(1.0 - (vx * vx + vy * vy) / C2, min=1e-12))


def doppler_factor_xy(vx, vy, nx, ny):
    """Observed/emitted frequency for a source at (vx, vy), photon direction
    (nx, ny) (unit, source -> observer), static observer."""
    g = _gamma_xy(vx, vy)
    return 1.0 / (g * (1.0 - (vx * nx + vy * ny) / C2))


def camera_doppler_factor_xy(cvx, cvy, nx, ny):
    """Moving-observer factor."""
    g = _gamma_xy(cvx, cvy)
    return g * (1.0 - (cvx * nx + cvy * ny) / C2)


def floored_mod(x, m: float):
    """x mod m (m > 0) as JAX's jnp.mod computes it: the floored remainder
    in [0, m), by fmod (which truncates toward zero) and JAX's sign fix.
    torch.remainder computes x - floor(x / m) m, rounded otherwise."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _hat(x):
    """Linear hat weight max(0, 1 - |x|)."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


# representative channel wavelengths (m) and h*c/k (m*K)
_LAMBDA_RGB = (610e-9, 550e-9, 465e-9)
_HC_OVER_K = 1.43877688e-2


def planck_constants(lam: float, temp: float):
    """(x, 1 - e^-x) as f32 values for x = h c / (k lam T)."""
    x = np.float32(_HC_OVER_K / (lam * temp))
    return float(x), float(-np.expm1(-x))


def planck_channel_factor(d, lam: float, temp: float):
    """Observed/emitted blackbody intensity ratio at channel wavelength
    `lam` under total Doppler factor `d`:
    exp(x - x/D) (1 - e^-x) / (1 - e^-x/D), x = h c / (k lam T), with the
    exponent clamped to +-80 so it stays finite."""
    x, num = planck_constants(lam, temp)
    d_safe = torch.clamp(d, min=1e-3)
    expo = torch.clamp(x - x / d_safe, -80.0, 80.0)
    den = -torch.expm1(-x / d_safe)
    return torch.exp(expo) * num / torch.clamp(den, min=1e-38)


def shade_channels(cr, cg, cb, d, params: RenderParams):
    """Doppler-shift + beam three channel tensors.  Hat model: a factor D
    moves energy across the (r, g, b) bands by log2(D) channels with linear
    interpolation; spectral: exact Planck ratios (beaming inherent)."""
    if params.spectral:
        t0 = params.spectral_temp
        sr = cr * planck_channel_factor(d, _LAMBDA_RGB[0], t0)
        sg = cg * planck_channel_factor(d, _LAMBDA_RGB[1], t0)
        sb = cb * planck_channel_factor(d, _LAMBDA_RGB[2], t0)
    elif params.doppler:
        t = torch.clamp(
            torch.log2(torch.clamp(d, min=1e-6)) * params.doppler_strength, -2.5, 2.5
        )
        out = []
        for i in range(3):
            src = i - t
            out.append(_hat(src - 0) * cr + _hat(src - 1) * cg + _hat(src - 2) * cb)
        sr, sg, sb = out
    else:
        sr, sg, sb = cr, cg, cb
    if params.beaming and not params.spectral:
        boost = d * d * d
        sr, sg, sb = sr * boost, sg * boost, sb * boost
    amb = params.ambient
    mix = lambda s, c: amb * c + (1.0 - amb) * torch.clamp(s, 0.0, 1.0)
    return mix(sr, cr), mix(sg, cg), mix(sb, cb)


# ---------------------------------------------------------------------------
# Segment math
# ---------------------------------------------------------------------------


def _euclid_route(cx, cy):
    """Flat-spacetime route length: the Euclidean chord to the camera."""

    def route(qx, qy):
        dx, dy = qx - cx, qy - cy
        return torch.sqrt(dx * dx + dy * dy)

    return route


def _ray_hit_xy(cx, cy, dhx, dhy, ax, ay, bx, by, ta, t_now, dt, rho):
    """Ray from the camera along (dhx, dhy) on the past light cone of
    (cam, t_now) vs one swept capsule.  Returns (hit, s_hit)."""
    s_hi = t_now - ta
    a_x = cx + s_hi * dhx - ax
    a_y = cy + s_hi * dhy - ay
    b_x = dt * dhx + (bx - ax)
    b_y = dt * dhy + (by - ay)
    bb = b_x * b_x + b_y * b_y
    tau = torch.clamp((a_x * b_x + a_y * b_y) / torch.clamp(bb, min=1e-20), 0.0, 1.0)
    d_x = a_x - tau * b_x
    d_y = a_y - tau * b_y
    dist2 = d_x * d_x + d_y * d_y
    s_hit = s_hi - tau * dt
    hit = (dist2 <= rho * rho) & (s_hit > 0.0)
    return hit, s_hit


def _occupancy_xy(px, py, t_e, ax, ay, bx, by, ta, dt, rho):
    """Is map point (px, py) inside this segment's capsule at event time
    t_e?  Returns (inside, dist2)."""
    tau = (t_e - ta) / dt
    in_time = (tau >= -0.001) & (tau <= 1.001)
    tau_c = torch.clamp(tau, 0.0, 1.0)
    d_x = px - (ax + tau_c * (bx - ax))
    d_y = py - (ay + tau_c * (by - ay))
    dist2 = d_x * d_x + d_y * d_y
    return in_time & (dist2 <= rho * rho), dist2


# ---------------------------------------------------------------------------
# Cone band search and pair rows
# ---------------------------------------------------------------------------


def _view_grid(width, height, cam, k):
    """View-cell grid dims + geometry: (wc_img, hc_img, pixel_size, x0, y0),
    (x0, y0) the world position of pixel (0, 0)'s center."""
    wc_img = -(-width // k)
    hc_img = -(-height // k)
    larger = max(width, height)
    pixel_size = cam.zoom / larger
    x0 = cam.pos[0] - (width - 1) / 2.0 * pixel_size
    y0 = cam.pos[1] - (height - 1) / 2.0 * pixel_size
    return wc_img, hc_img, pixel_size, x0, y0


def _pair_slots(params: RenderParams) -> int:
    """Pair rows a particle owns: `segments` with rank compaction, else
    `band`."""
    return params.segments if 0 < params.segments < params.band else params.band


def _band_search(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                 t_now, width: int, height: int, params: RenderParams,
                 cull_hull: bool = True, route_lengths=None):
    """Cone-crossing segments in the (N * band) pair layout, validity
    re-checked exactly per segment and, with `cull_hull`, culled to the view
    + camera hull (never in the camera frame, whose ground footprint goes
    beyond the output rect).  With 0 < segments < band each particle keeps
    its first `segments` valid crossings, oldest first, in an
    (N * segments) layout.  `route_lengths(qx, qy) -> distance` is the cone
    metric (curved routes; their callers turn the hull cull off), the
    Euclidean distance to the camera by default.  Returns (PairData,
    band_truncated, segment_dropped), the last a () i64 device tensor with
    compaction on, else None."""
    # the cone band search: the kernel for CUDA tensors on the Euclidean
    # route, the dense sweep for CPU tensors and for any other route
    bw = (band_cuda.cone_band_window(buf, params, cam) if route_lengths is None
          else band_cuda.cone_band_window_plain(buf, params, cam, route_lengths))
    return _window_pairs(bw, obj_index, objects, cam, t_now, width, height, params, cull_hull,
                         route_lengths)


def _window_pairs(bw: band_cuda.BandWindow, obj_index, objects: Objects, cam: Camera, t_now,
                  width: int, height: int, params: RenderParams, cull_hull: bool = True,
                  route_lengths=None):
    """`_band_search` after the band window `bw`: the segment tests, rank
    compaction and pair rows."""
    dt, rho, band = params.dt, params.rho, params.band
    n = bw.wx.shape[0]
    cxm, cym = cam.pos[0], cam.pos[1]
    hi0, truncated = bw.hi0, bw.truncated
    wx, wy, wvx, wvy, ages = bw.wx, bw.wy, bw.wvx, bw.wvy, bw.ages
    route = route_lengths or _euclid_route(cxm, cym)

    # segment j: older endpoint = window column j (age a_j), younger = j + 1
    qax, qay = wx[:, :band], wy[:, :band]
    qbx, qby = wx[:, 1:], wy[:, 1:]
    pvx, pvy = wvx[:, :band], wvy[:, :band]
    age_a = ages[:, :band]
    pta = t_now - age_a.to(torch.float32) * dt

    ra = route(qax, qay)
    rb = route(qbx, qby)
    s_hi = t_now - pta
    valid = (
        (age_a >= 1)
        & (age_a <= hi0)
        & (torch.maximum(ra, rb) >= s_hi - dt - rho)
        & (torch.minimum(ra, rb) <= s_hi + rho)
        & (torch.abs(qax) < 1.0e8)
    )
    if cull_hull and not params.camera_frame:
        # straight rays: a camera -> pixel segment stays in the view + camera hull
        _, _, pixel_size, x0, y0 = _view_grid(width, height, cam, params.cell_px)
        margin = 4.0 * (rho + dt)
        vx0 = torch.minimum(x0, cxm) - margin
        vx1 = torch.maximum(x0 + width * pixel_size, cxm) + margin
        vy0 = torch.minimum(y0, cym) - margin
        vy1 = torch.maximum(y0 + height * pixel_size, cym) + margin
        valid = (
            valid
            & (torch.maximum(qax, qbx) >= vx0)
            & (torch.minimum(qax, qbx) <= vx1)
            & (torch.maximum(qay, qby) >= vy0)
            & (torch.minimum(qay, qby) <= vy1)
        )

    seg_dropped = None
    k = params.segments
    if 0 < k < band:
        # rank compaction: slot s takes the column of the particle's (s+1)-th
        # valid crossing, the number of columns whose inclusive valid count
        # is still <= s (the count never falls along a row); a particle with
        # more than k valid crossings loses its youngest
        csum = torch.cumsum(valid.to(torch.int32), dim=1)
        vcount = csum[:, -1]
        seg_dropped = torch.clamp(vcount - k, min=0).sum()
        col = torch.stack([(csum <= s).sum(dim=1) for s in range(k)], dim=1)
        col = col.clamp(max=band - 1)
        valid = vcount[:, None] > torch.arange(k, dtype=torch.int32, device=col.device)
        # JAX's masked sums leave 0 in the slots with no crossing
        sel = lambda f: torch.where(valid, torch.gather(f, 1, col), 0.0)
        qax, qay, qbx, qby = sel(qax), sel(qay), sel(qbx), sel(qby)
        pta, pvx, pvy = sel(pta), sel(pvx), sel(pvy)
        band = k

    far = 2.0e9
    keep = lambda v: torch.where(valid, v, far).reshape(-1)
    prgb = objects.base_color[obj_index.long()]  # (N, 3)
    col = lambda c: prgb[:, c, None].expand(n, band).reshape(-1)
    pdata = torch.stack(
        [
            keep(qax), keep(qay), keep(qbx), keep(qby),
            torch.where(valid, pta, 0.0).reshape(-1),
            pvx.reshape(-1), pvy.reshape(-1),
            col(0), col(1), col(2),
        ],
        dim=1,
    )
    pairs = PairData(pdata=pdata, pair_valid=valid.reshape(-1), n_pairs=valid.sum())
    return pairs, truncated, seg_dropped


# the band search in the retarded, instant and retina renders' own span;
# the curved renders call `_band_search` under their routes' spans
_band_pairs = spanned("cone sweep + pairs")(_band_search)


def _band_pairs_nocull(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                       t_now, params: RenderParams) -> PairData:
    """Band pairs without the view cull or rank compaction, (N * band) rows:
    the retina mode's panorama sees every direction."""
    params = dataclasses.replace(params, segments=0)
    return _band_pairs(buf, obj_index, objects, cam, t_now, 0, 0, params,
                       cull_hull=False)[0]


def _instant_pairs(buf: WorldlineBuffer, obj_index, objects: Objects,
                   params: RenderParams) -> PairData:
    """Pairs for the instantaneous view: only the newest segment (age 1 ->
    age 0) of each particle, i.e. "measured reality" — the filled upgrade
    of the reference's debug point renderer."""
    row = lambda plane, age: row_at_age(plane, buf, age)
    qax, qay = row(buf.pos_x, 1), row(buf.pos_y, 1)
    qbx, qby = row(buf.pos_x, 0), row(buf.pos_y, 0)
    pvx, pvy = row(buf.vel_x, 1), row(buf.vel_y, 1)
    pta = newest_time(buf) - params.dt
    valid = (torch.abs(qax) < 1.0e8) & (buf.frames_in_use >= 2)
    far = 2.0e9
    keep = lambda v: torch.where(valid, v, far)
    prgb = objects.base_color[obj_index.long()]  # (N, 3)
    pdata = torch.stack(
        [
            keep(qax), keep(qay), keep(qbx), keep(qby), pta.expand(qax.shape),
            pvx, pvy, prgb[:, 0], prgb[:, 1], prgb[:, 2],
        ],
        dim=1,
    )
    return PairData(pdata=pdata, pair_valid=valid, n_pairs=valid.sum())


def _compact_by_class(pairs: PairData, key: torch.Tensor, budget: int,
                      n_classes_kept: int) -> PairData:
    """Stable-sort rows by class `key` and keep the first `budget`; rows of
    class >= n_classes_kept (invalid) become far sentinels."""
    order = torch.sort(key, stable=True).indices[:budget]
    ok = key[order] < n_classes_kept
    pdata = torch.where(ok[:, None], pairs.pdata[order], 2.0e9)
    return PairData(pdata=pdata, pair_valid=ok, n_pairs=pairs.n_pairs)


@spanned("pair compaction")
def _compact_pairs_to_budget(pairs: PairData, budget: int) -> PairData:
    """Valid rows first, in row order, cut to `budget` rows.  `n_pairs`
    stays the pre-budget count."""
    rows = pairs.pdata.shape[0]
    if budget <= 0 or budget >= rows:
        return pairs
    key = (~pairs.pair_valid).to(torch.int32)
    return _compact_by_class(pairs, key, budget, 1)


@spanned("pair compaction")
def _compact_pairs_two_segment(pairs: PairData, first_mask, budget: int):
    """Like _compact_pairs_to_budget, but valid rows matching `first_mask`
    come first (then the other valid rows), so a prefix slice holds them.
    Returns (PairData, n_first)."""
    rows = pairs.pdata.shape[0]
    mask = pairs.pair_valid
    fm = mask & first_mask
    n_first = fm.sum()
    if budget <= 0 or budget >= rows:
        budget = rows
    key = torch.where(fm, 0, torch.where(mask, 1, 2)).to(torch.int32)
    return _compact_by_class(pairs, key, budget, 2), n_first


@spanned("cone sweep + pairs")
def _band_pair_rows(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera, t_now,
                    width: int, height: int, params: RenderParams, boundary=None):
    """Steps 1-2 on the card: the band kernel's window, then the pair-rows
    kernel's compacted rows (ops/pairs_cuda.py).  Returns (PairData,
    n_first, band_truncated, segment_dropped)."""
    bw = band_cuda.cone_band_window(buf, params, cam)
    pairs, n_first, seg_dropped = pairs_cuda.pair_rows(bw, obj_index, objects, cam, t_now,
                                                       width, height, params, boundary)
    return pairs, n_first, bw.truncated, seg_dropped


def _frame_pairs(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera, t_now,
                 width: int, height: int, params: RenderParams, boundary=None, mesh=None):
    """Steps 1-2 of a retarded frame: the pair rows compacted to
    `pair_budget`, and with `boundary` ((N,) bool, the occlusion retina's
    rows) while the retina budget is under the row count, the boundary
    particles' valid rows first.  The pair-rows kernel where
    `pairs_cuda.takes_kernel`, else the plain chain: all N * k rows
    (`_band_pairs`; on a mesh every rank's, gathered), then a stable sort by
    class (`_compact_pairs`).  Returns (PairData, n_first, band_truncated,
    segment_dropped); n_first, the boundary rows before the budget, is None
    without the split."""
    rows = buf.num_particles * _pair_slots(params) * (1 if mesh is None else mesh.size)
    if not (boundary is not None and 0 < params.retina_budget < rows):
        boundary = None
    if pairs_cuda.takes_kernel(buf.pos_x.device, params, mesh):
        return _band_pair_rows(buf, obj_index, objects, cam, t_now, width, height, params,
                               boundary)
    pairs_raw, band_truncated, segment_dropped = _band_pairs(
        buf, obj_index, objects, cam, t_now, width, height, params)
    pairs, n_first, (band_truncated, segment_dropped) = _compact_pairs(
        pairs_raw, boundary, params, mesh, (band_truncated, segment_dropped))
    return pairs, n_first, band_truncated, segment_dropped


def _compact_pairs(pairs: PairData, boundary, params: RenderParams, mesh=None, counters=()):
    """(PairData, n_first, counters): the rows of N particles
    (`_pair_slots` each) cut to `pair_budget`; with `boundary` ((N,) bool)
    by `_compact_pairs_two_segment`, the boundary particles' rows first (the
    retina reads a prefix), else by `_compact_pairs_to_budget` and None.
    On a mesh every rank's rows are gathered first and `counters` summed
    over the ranks (`_gather_pairs`); off it `counters` come back as given."""
    rmask = (None if boundary is None
             else boundary[:, None].expand(-1, _pair_slots(params)).reshape(-1))
    if mesh is not None:
        pairs, rmask, counters = _gather_pairs(mesh, pairs, rmask, counters)
    if rmask is None:
        return _compact_pairs_to_budget(pairs, params.pair_budget), None, counters
    return (*_compact_pairs_two_segment(pairs, rmask, params.pair_budget), counters)


# ---------------------------------------------------------------------------
# View-cell splat
# ---------------------------------------------------------------------------


def _splat_keys(pairs: PairData, cam: Camera, width: int, height: int,
                params: RenderParams):
    """Composite splat keys for the (view cells + 1 halo) grid: one entry per
    (pair, splat offset), key = cell * _DQ + quantized distance, so a cell's
    entries sort nearest first; unused entries get the sentinel
    n_vcells * _DQ.  Returns (key, val, wc, hc, geom, cell_too_small)."""
    k = params.cell_px
    pcap = pairs.pdata.shape[0]
    dev = pairs.pdata.device
    wc_img, hc_img, pixel_size, x0, y0 = _view_grid(width, height, cam, k)
    wc, hc = wc_img + 2, hc_img + 2
    n_vcells = wc * hc
    lam = k * pixel_size  # cell edge (world units)
    gx0 = x0 - 0.5 * pixel_size - lam
    gy0 = y0 - 0.5 * pixel_size - lam

    pd = pairs.pdata
    cx = 0.5 * (pd[:, _F_AX] + pd[:, _F_BX])
    cy = 0.5 * (pd[:, _F_AY] + pd[:, _F_BY])
    sx, sy = pd[:, _F_BX] - pd[:, _F_AX], pd[:, _F_BY] - pd[:, _F_AY]
    reach = params.rho + 0.5 * torch.sqrt(sx * sx + sy * sy)
    if params.camera_frame:
        # cells live in the boosted view: splat the pair's warped centre; a
        # ground disc of radius `reach` maps inside a warped disc of radius
        # stretch * reach
        wux, wuy = boost.warp_xy(cx - cam.pos[0], cy - cam.pos[1], cam.vel[0], cam.vel[1])
        cx = cam.pos[0] + wux
        cy = cam.pos[1] + wuy
        reach = reach * boost.stretch(cam.vel[0], cam.vel[1])
    ux, uy = (cx - gx0) / lam, (cy - gy0) / lam
    fx, fy = torch.floor(ux), torch.floor(uy)
    # clamp before the int cast (far sentinels would overflow i32); values
    # past the clamp are out of the grid for every splat offset either way
    cell_x = fx.clamp(-2, wc + 1).to(torch.int32)
    cell_y = fy.clamp(-2, hc + 1).to(torch.int32)

    if params.splat_cells == 4:
        # nearest-corner 2x2: step toward the side of the in-cell fraction
        sx_ = torch.where(ux - fx < 0.5, -1, 1).to(torch.int32)
        sy_ = torch.where(uy - fy < 0.5, -1, 1).to(torch.int32)
        offsets = [(0, 0), (sx_, 0), (0, sy_), (sx_, sy_)]
    else:
        offsets = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]  # 3x3 splat
    inv_lam2 = float(_DQ) / torch.clamp(lam * lam, min=1e-20)
    keys = []
    for dx, dy in offsets:
        ccx = cell_x + dx
        ccy = cell_y + dy
        in_grid = (ccx >= 0) & (ccx < wc) & (ccy >= 0) & (ccy < hc)
        lox = gx0 + ccx.to(torch.float32) * lam
        loy = gy0 + ccy.to(torch.float32) * lam
        nx_ = torch.minimum(torch.maximum(cx, lox), lox + lam)
        ny_ = torch.minimum(torch.maximum(cy, loy), loy + lam)
        ex, ey = nx_ - cx, ny_ - cy
        d2 = ex * ex + ey * ey
        r_ = reach + 1e-6
        use = pairs.pair_valid & in_grid & (d2 <= r_ * r_)
        dq = (d2 * inv_lam2).clamp(max=_DQ - 1).to(torch.int32).clamp(0, _DQ - 1)
        keys.append(torch.where(use, (ccy * wc + ccx) * _DQ + dq, n_vcells * _DQ))
    n_splat = len(offsets)
    key = torch.stack(keys, dim=1).reshape(-1).to(torch.int32)
    val = torch.arange(pcap, dtype=torch.int32, device=dev)[:, None].expand(
        pcap, n_splat).reshape(-1)
    # coverage: a 3x3 splat needs cells >= the reach, a 2x2 one twice that
    min_lam = params.reach * (2.0 if params.splat_cells == 4 else 1.0)
    if params.camera_frame:
        min_lam = min_lam * boost.stretch(cam.vel[0], cam.vel[1])
    cell_too_small = lam < min_lam
    geom = (wc_img, hc_img, pixel_size, x0, y0)
    return key, val, wc, hc, geom, cell_too_small


@spanned("splat CSR")
def _splat_csr(pairs: PairData, cam: Camera, width: int, height: int,
               params: RenderParams):
    """Splat pairs into a per-image-cell CSR of entries.

    A stable sort of the composite keys keeps entries of one cell contiguous,
    nearest quantile first, and equal keys in pair order (the tie rule of
    the pixel pass).  Cell c's entries are
    entries[cell_lo[c]:cell_hi[c]], at most `bin_capacity` of them.
    Returns (entries (E, 10), cell_lo, cell_hi (n_img_cells,) i32,
    bin_dropped, entry_dropped, cell_too_small, geom)."""
    cap = params.bin_capacity
    key, val, wc, hc, geom, cell_too_small = _splat_keys(pairs, cam, width, height, params)
    dev = key.device
    n_vcells = wc * hc
    wc_img, hc_img = geom[0], geom[1]

    skey, perm = torch.sort(key, stable=True)
    sval = val[perm]
    entry_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if 0 < params.entry_budget < skey.shape[0]:
        # sentinel keys sort last, so the prefix keeps every valid entry
        # while they fit; overflow drops the highest-key cells
        eb = params.entry_budget
        n_valid = (key < n_vcells * _DQ).sum()
        entry_dropped = torch.clamp(n_valid - eb, min=0)
        skey, sval = skey[:eb], sval[:eb]
    scell = (skey // _DQ).contiguous()
    rank = torch.arange(scell.shape[0], device=dev) - torch.searchsorted(scell, scell)
    bin_dropped = ((scell < n_vcells) & (rank >= cap)).sum()

    rows = torch.arange(1, hc_img + 1, dtype=torch.int32, device=dev)[:, None] * wc
    halo_ids = (rows + torch.arange(1, wc_img + 1, dtype=torch.int32, device=dev)[None, :])
    halo_ids = halo_ids.reshape(-1)
    cell_lo = torch.searchsorted(scell, halo_ids, out_int32=True)
    cell_hi = torch.searchsorted(scell, halo_ids, right=True, out_int32=True)
    cell_hi = torch.minimum(cell_hi, cell_lo + cap)
    entries = pairs.pdata[sval.long()].contiguous()
    return entries, cell_lo, cell_hi, bin_dropped, entry_dropped, cell_too_small, geom


# ---------------------------------------------------------------------------
# Dense per-cell tables: the curved renderers' route pass
# ---------------------------------------------------------------------------

# a route pass tests every pixel of a view cell against every candidate of
# its table, (cells, k * k, bin_capacity) elements; it runs over blocks of
# cells of at most this many elements (the JAX package's lax.map over
# `cells_per_block` cells, a RenderParams field the port leaves out)
ROUTE_PASS_ELEMENTS = 1 << 23


class ViewTables(NamedTuple):
    """Per-frame candidate rows densified onto the image's view-cell grid."""

    vdat: torch.Tensor  # (n_img_cells, cap, 10) f32 pair rows, CSR order
    vok: torch.Tensor  # (n_img_cells, cap) bool
    n_img_cells: int


def _build_view_tables(pairs: PairData, cam: Camera, width: int, height: int,
                       params: RenderParams):
    """Each image cell's CSR run (`_splat_csr`) padded to bin_capacity rows
    in CSR order, by one row gather: the JAX package's `_splat_vslot`
    table, whose stable sort on the same keys keeps each cell's first `cap`
    entries in the same order (the route pass's first-of-ties winner reads
    that order).  Empty slots hold entry 0's row, masked by `vok`.  Returns
    (ViewTables, bin_dropped, entry_dropped, cell_too_small, geom)."""
    cap = params.bin_capacity
    entries, cell_lo, cell_hi, bin_dropped, entry_dropped, cell_too_small, geom = _splat_csr(
        pairs, cam, width, height, params)
    slot = cell_lo[:, None] + torch.arange(cap, dtype=torch.int32, device=cell_lo.device)
    vok = slot < cell_hi[:, None]
    vdat = entries[torch.where(vok, slot, 0).long()]
    return (ViewTables(vdat, vok, cell_lo.shape[0]), bin_dropped, entry_dropped,
            cell_too_small, geom)


def _cell_pixel_coords(width: int, height: int, cam: Camera, params: RenderParams):
    """Pixel-centre world coordinates grouped by view cell: (px, py), each
    (n_img_cells, k * k), cell-major in row order, pixels row-major in a
    cell (those past the image edge included; `_assemble_image` crops
    them)."""
    k = params.cell_px
    wc_img, hc_img, pixel_size, x0, y0 = _view_grid(width, height, cam, k)
    dev = cam.pos.device
    ci = torch.arange(hc_img * wc_img, dtype=torch.int32, device=dev)[:, None]
    pj = torch.arange(k * k, dtype=torch.int32, device=dev)[None, :]
    gx = (ci % wc_img) * k + pj % k
    gy = (ci // wc_img) * k + pj // k
    return (x0 + gx.to(torch.float32) * pixel_size,
            y0 + gy.to(torch.float32) * pixel_size)


def _cell_blocks(n_cells: int, params: RenderParams):
    """Slices of view cells whose route-pass tests fit ROUTE_PASS_ELEMENTS."""
    per_cell = params.cell_px * params.cell_px * params.bin_capacity
    step = max(1, ROUTE_PASS_ELEMENTS // per_cell)
    return [slice(a, min(a + step, n_cells)) for a in range(0, n_cells, step)]


def _occupancy_cells(px, py, t_e, vdat, vok, dt, rho):
    """Dense per-cell occupancy: pixels (C, k2) at event times t_e (C, k2)
    against their cells' candidates (C, cap, 10).  Returns (occupied (C,
    k2) bool, winner (C, k2) i64): the winner is the first candidate in
    table order among those of least squared distance (the JAX package's
    first-of-ties mask), candidate 0 where none is inside."""
    inside, dist2 = _occupancy_xy(
        px[:, :, None], py[:, :, None], t_e[:, :, None],
        vdat[:, None, :, _F_AX], vdat[:, None, :, _F_AY],
        vdat[:, None, :, _F_BX], vdat[:, None, :, _F_BY],
        vdat[:, None, :, _F_TA], dt, rho,
    )
    inside = inside & vok[:, None, :]
    min_d, winner = torch.where(inside, dist2, _BIG).min(dim=2)  # first index of the min
    return min_d < _BIG, winner


def _field_at(vdat, winner, field: int):
    """Each pixel's winning candidate's `field`: (C, k2)."""
    return torch.gather(vdat[:, :, field], 1, winner)


def _assemble_image(crgb, width: int, height: int, params: RenderParams, planar: bool,
                    wc_img: int, hc_img: int):
    """(n_img_cells, 3, k * k) cell colours -> (3, H, W), or (H, W, 3)."""
    k = params.cell_px
    img = crgb.reshape(hc_img, wc_img, 3, k, k).permute(2, 0, 3, 1, 4)
    img = img.reshape(3, hc_img * k, wc_img * k)[:, :height, :width]
    return img.contiguous() if planar else img.permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------------------
# Occlusion retina
# ---------------------------------------------------------------------------


def _ray_angles(n_rays: int, device):
    """Ray angles -pi + (i + 0.5) 2pi / n_rays, in the reference's f32 steps."""
    step = np.float32(2 * _PI / n_rays)
    i = torch.arange(n_rays, dtype=torch.float32, device=device)
    return -float(_PI) + (i + 0.5) * float(step)


@spanned("retina march")
def _retina(pairs: PairData, cam: Camera, t_now, params: RenderParams):
    """First-hit arclength per angle over all pairs: s_first (num_rays,)
    (ops/retina_cuda.py: a CUDA kernel on the card, a chunked march on the
    CPU)."""
    return retina_cuda.retina_march(pairs, cam, t_now, params)


def _occlusion_ds(params: RenderParams) -> int:
    ds = max(1, params.occlusion_downsample)
    return ds if params.cell_px % ds == 0 else 1


def _sfirst_lookup(s_first, gxq, gyq, x0, y0, pixel_size, cam, n_rays, off,
                   camera_frame: bool):
    """Retina value at the angle of pixel (gxq, gyq) + `off` pixels.  With
    `camera_frame` the pixel is a boosted-view point; the retina bins by
    GROUND bearing, so it is unwarped first."""
    pxw = x0 + (gxq.to(torch.float32) + off) * pixel_size
    pyw = y0 + (gyq.to(torch.float32) + off) * pixel_size
    ox = pxw - cam.pos[0]
    oy = pyw - cam.pos[1]
    if camera_frame:
        ox, oy = boost.unwarp_xy(ox, oy, cam.vel[0], cam.vel[1])
    phi = torch.atan2(oy, ox)
    ri = torch.floor((phi + float(_PI)) / float(np.float32(2 * _PI)) * n_rays)
    ri = ri.clamp(0, n_rays - 1).long()
    return s_first[ri]


@spanned("retina lookup")
def _retina_quads(s_first, cam, width, height, params: RenderParams, geom):
    """Retina lookup for every d x d pixel quad of the padded view-cell grid
    (d = occlusion downsample), at the quad's centre angle:
    (hc_img * k / d, wc_img * k / d)."""
    wc_img, hc_img, pixel_size, x0, y0 = geom
    k = params.cell_px
    ds = _occlusion_ds(params)
    dev = s_first.device
    qy = torch.arange(hc_img * (k // ds), dtype=torch.int32, device=dev)[:, None]
    qx = torch.arange(wc_img * (k // ds), dtype=torch.int32, device=dev)[None, :]
    return _sfirst_lookup(
        s_first, qx * ds, qy * ds, x0, y0, pixel_size, cam, params.num_rays,
        (ds - 1) * 0.5, params.camera_frame,
    ).contiguous()


# ---------------------------------------------------------------------------
# Mesh: the pair gather and the banded pixel pass
# ---------------------------------------------------------------------------


def _gather_pairs(mesh, pairs: PairData, first_mask=None, counters=()):
    """Every rank's pair rows in rank order, as the single-device pair
    layout (particle-major), by one all-gather of the 10 fields, the
    validity and `first_mask` (per pair row, or None) packed as f32
    columns; and `counters` (() i64 tensors, None kept) summed over the
    ranks by one all-reduce.  Returns (PairData, first_mask, counters)."""
    cols = [pairs.pdata, pairs.pair_valid[:, None].to(torch.float32)]
    if first_mask is not None:
        cols.append(first_mask[:, None].to(torch.float32))
    g = comm.all_gather(torch.cat(cols, dim=1), mesh)
    valid = g[:, 10] > 0.5
    out = PairData(pdata=g[:, :10].contiguous(), pair_valid=valid, n_pairs=valid.sum())
    fm = g[:, 11] > 0.5 if first_mask is not None else None
    live = [c for c in counters if c is not None]
    if live:
        summed = iter(comm.all_reduce(torch.stack([c.to(torch.int64) for c in live]),
                                      mesh).unbind())
        counters = tuple(None if c is None else next(summed) for c in counters)
    return out, fm, counters


def _mesh_pixel_pass(inputs, params, width: int, height: int, mesh):
    """(3, H, W): this rank shades its share of the view-cell rows
    (ceil(hc_img / size) a rank, in rank order) with the pixel pass, and
    one all-gather of the equal-sized bands assembles the image on every
    rank."""
    k = params.cell_px
    per = -(-inputs.hc_img // mesh.size)
    row0, count = comm.block(inputs.hc_img, mesh.rank, mesh.size)
    band = render_cuda.pixel_pass(inputs, params, width=width, height=height, rows=(row0, count, per * k))
    g = comm.all_gather(band.reshape(1, -1), mesh)
    img = g.reshape(mesh.size, 3, per * k, width).transpose(0, 1)
    return img.reshape(3, mesh.size * per * k, width)[:, :height].contiguous()


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------


class PixelInputs(NamedTuple):
    """Everything the pixel pass (ops/render_cuda.py) reads for one frame."""

    entries: torch.Tensor  # (E, 10) f32 splat entries, per-cell CSR order
    cell_lo: torch.Tensor  # (hc_img * wc_img,) i32
    cell_hi: torch.Tensor  # (hc_img * wc_img,) i32
    sfq: object  # (hc_img * k / d, wc_img * k / d) f32 retina per quad, or None
    scal: torch.Tensor  # (8,) f32: t_now, cam x, y, vx, vy, x0, y0, pixel size
    wc_img: int
    hc_img: int
    ds: int  # occlusion downsample d


def prepare_pixel_pass(buf: WorldlineBuffer, obj_index: torch.Tensor,
                       objects: Objects, cam: Camera, width: int, height: int,
                       params: RenderParams, boundary=None, mesh=None):
    """Steps 1-4 of the frame (see the module docstring).  Returns
    (PixelInputs, RenderDiag); the diag fields are device tensors.  With
    `mesh`, `buf`, `obj_index` and `boundary` are this rank's columns and
    rows, and the result is every rank's the same."""
    t_now = newest_time(buf)
    use_rays = params.opaque and params.retarded
    if params.camera_frame and not params.retarded:
        raise ValueError(
            "camera_frame requires retarded=True (the boosted view is a warp of the past "
            "light cone; an instantaneous boosted view would need a per-event "
            "simultaneity re-slice)")

    retina_dropped = None
    segment_dropped = None
    if not params.retarded:
        pairs = _instant_pairs(buf, obj_index, objects, params)
        if mesh is not None:
            pairs = _gather_pairs(mesh, pairs)[0]
        rpairs = pairs
        band_truncated = torch.zeros((), dtype=torch.int64, device=pairs.pdata.device)
    else:
        pairs, n_b, band_truncated, segment_dropped = _frame_pairs(
            buf, obj_index, objects, cam, t_now, width, height, params,
            boundary if use_rays else None, mesh)
        if n_b is not None:
            rb = min(params.retina_budget, pairs.pdata.shape[0])
            n_r = torch.clamp(n_b, max=rb)
            in_prefix = torch.arange(rb, device=n_b.device) < n_r
            rpairs = PairData(pdata=pairs.pdata[:rb],
                              pair_valid=pairs.pair_valid[:rb] & in_prefix, n_pairs=n_r)
            retina_dropped = torch.clamp(n_b - rb, min=0)
        else:
            rpairs = pairs

    entries, cell_lo, cell_hi, bin_dropped, entry_dropped, cell_too_small, geom = _splat_csr(
        pairs, cam, width, height, params
    )
    wc_img, hc_img, pixel_size, x0, y0 = geom
    sfq = None
    if use_rays:
        s_first = _retina(rpairs, cam, t_now, params)
        sfq = _retina_quads(s_first, cam, width, height, params, geom)
    scal = torch.stack(
        [t_now, cam.pos[0], cam.pos[1], cam.vel[0], cam.vel[1], x0, y0, pixel_size]
    ).to(torch.float32)
    inputs = PixelInputs(entries, cell_lo, cell_hi, sfq, scal, wc_img, hc_img,
                         _occlusion_ds(params))
    diag = RenderDiag(
        pairs_used=pairs.n_pairs,
        band_truncated=band_truncated,
        bin_dropped=bin_dropped,
        cell_too_small=cell_too_small,
        retina_dropped=retina_dropped,
        entry_dropped=entry_dropped,
        segment_dropped=segment_dropped,
    )
    return inputs, diag


def render_retarded_with_diag(
    buf: WorldlineBuffer,
    obj_index: torch.Tensor,
    objects: Objects,
    cam: Camera,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool = False,
    boundary=None,
    mesh=None,
):
    """(image, RenderDiag).  The image is (H, W, 3), or (3, H, W) with
    `planar`.  `boundary` ((N,) bool, e.g. worldline.boundary_mask) enables
    the boundary-only occlusion retina when params.retina_budget > 0.
    RenderDiag fields are device tensors (no host sync).  With `mesh` the
    ring, `obj_index` and `boundary` are this rank's share, and every rank
    gets the whole image and the same diagnostics."""
    inputs, diag = prepare_pixel_pass(
        buf, obj_index, objects, cam, width, height, params, boundary, mesh
    )
    if mesh is None:
        img = render_cuda.pixel_pass(inputs, params, width=width, height=height)
    else:
        img = _mesh_pixel_pass(inputs, params, width, height, mesh)
    return (img if planar else img.permute(1, 2, 0)), diag


def render_retarded(buf, obj_index, objects, cam, width, height, params,
                    planar=False, boundary=None, mesh=None):
    """The retarded-time image; see render_retarded_with_diag."""
    img, _ = render_retarded_with_diag(
        buf, obj_index, objects, cam, width, height, params, planar, boundary, mesh
    )
    return img


def render_views(buf, obj_index, objects, cams: Camera, width, height, params,
                 planar=False, boundary=None, mesh=None):
    """B observers of one ring: `cams` is a batched Camera (camera.
    stack_cameras; each field has a leading B axis).  Each view is
    render_retarded's image (on a `mesh`, its mesh path); returns (B, H,
    W, 3), or (B, 3, H, W) with `planar`."""
    views = [
        render_retarded(buf, obj_index, objects,
                        Camera(pos=cams.pos[b], zoom=cams.zoom[b], vel=cams.vel[b]),
                        width, height, params, planar, boundary, mesh)
        for b in range(cams.pos.shape[0])
    ]
    return torch.stack(views)


def _aberrated_directions(theta, cvx, cvy):
    """Ground-frame look directions (dhx, dhy) of the camera-frame arrival
    angles `theta` for a camera moving at (cvx, cvy): the photon arrives
    along -d_cam in the camera frame, is composed with the camera velocity
    (relativistic velocity addition, c = 1) into its ground-frame
    propagation, and the camera looks along minus that."""
    acx = -torch.cos(theta)
    acy = -torch.sin(theta)
    v2 = cvx * cvx + cvy * cvy
    safe_v2 = torch.clamp(v2, min=1e-12)
    udotv = acx * cvx + acy * cvy
    parx = udotv / safe_v2 * cvx
    pary = udotv / safe_v2 * cvy
    g = _gamma_xy(cvx, cvy)
    denom = 1.0 + udotv
    moving = v2 > 1e-12
    px_ = torch.where(moving, (parx + cvx + (acx - parx) / g) / denom, acx)
    py_ = torch.where(moving, (pary + cvy + (acy - pary) / g) / denom, acy)
    inv = 1.0 / torch.clamp(torch.sqrt(px_ * px_ + py_ * py_), min=1e-12)
    return -px_ * inv, -py_ * inv


def render_retina(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                  params: RenderParams, height: int = 64, planar: bool = False, mesh=None):
    """The observer's own field of view: a 360-degree 1D retina strip of
    params.num_rays camera-frame arrival angles, with aberration (a moving
    observer sees the forward view compressed) and Doppler shading; the
    strip repeated over `height` rows.  Returns (height, num_rays, 3), or
    (3, height, num_rays) with `planar`.

    The pairs are _band_pairs_nocull's (the band kernel on the card); the
    march runs over them in chunks of params.ray_chunk and keeps, per ray,
    the first hit's arclength and the winning pair's velocity and colour
    (the lowest pair index among equal arclengths, as the JAX scan's
    first-in-chunk pick and strict improvement across chunks give).  On a
    `mesh` the band search runs on this rank's ring columns and one
    all-gather of the pairs makes the march replicated."""
    dt, rho = params.dt, params.rho
    t_now = newest_time(buf)
    n_rays = params.num_rays
    theta = _ray_angles(n_rays, buf.pos_x.device)
    cvx, cvy = cam.vel[0], cam.vel[1]
    dhx, dhy = _aberrated_directions(theta, cvx, cvy)

    pairs = _band_pairs_nocull(buf, obj_index, objects, cam, t_now, params)
    if mesh is not None:
        pairs = _gather_pairs(mesh, pairs)[0]
    pd = pairs.pdata
    s_first = torch.full((n_rays,), _BIG, dtype=torch.float32, device=pd.device)
    win = torch.zeros((n_rays, 5), dtype=torch.float32, device=pd.device)  # vx vy r g b
    for a in range(0, pd.shape[0], params.ray_chunk):
        c = pd[a:a + params.ray_chunk]
        hit, s_hit = _ray_hit_xy(
            cam.pos[0], cam.pos[1], dhx[:, None], dhy[:, None],
            c[None, :, _F_AX], c[None, :, _F_AY], c[None, :, _F_BX],
            c[None, :, _F_BY], c[None, :, _F_TA], t_now, dt, rho,
        )
        s_hit = torch.where(hit & pairs.pair_valid[None, a:a + params.ray_chunk], s_hit, _BIG)
        s_c, idx = s_hit.min(dim=1)  # the first index of the minimum
        better = s_c < s_first
        s_first = torch.where(better, s_c, s_first)
        win = torch.where(better[:, None], c[idx, _F_VX:], win)
    hit_any = s_first < _BIG
    nx, ny = -dhx, -dhy  # photon propagation: event -> camera (ground frame)
    d = doppler_factor_xy(win[:, 0], win[:, 1], nx, ny) * camera_doppler_factor_xy(
        cvx, cvy, nx, ny)
    sr, sg, sb = shade_channels(win[:, 2], win[:, 3], win[:, 4], d, params)
    strip = torch.stack([torch.where(hit_any, v, 1.0) for v in (sr, sg, sb)])  # (3, R)
    img = strip[:, None, :].expand(3, height, n_rays)
    return img.contiguous() if planar else img.permute(1, 2, 0).contiguous()


def _segment_data(buf: WorldlineBuffer, dt: float):
    """Per-(slot, particle) segment endpoints as (T, N) planes (oracle only).
    Slot k's segment runs from (pos[k], times[k]) to pos[(k + 1) % T]; it is
    valid iff the next slot holds the consecutive tick."""
    t_cap = buf.capacity
    nxt = (torch.arange(t_cap, device=buf.times.device) + 1) % t_cap
    ta = buf.times
    valid = torch.isfinite(ta) & (torch.abs(buf.times[nxt] - ta - dt) < 0.5 * dt)
    qax = buf.pos_x[:t_cap]
    qay = buf.pos_y[:t_cap]
    return qax, qay, qax[nxt], qay[nxt], ta, valid


def render_retarded_brute(buf: WorldlineBuffer, obj_index, objects: Objects,
                          cam: Camera, width: int, height: int,
                          params: RenderParams) -> torch.Tensor:
    """Oracle: every pixel tests every (slot, particle) segment.  O(pixels *
    T * N) — tests on tiny scenes only.  Returns (H, W, 3)."""
    dt, rho = params.dt, params.rho
    qax, qay, qbx, qby, ta, seg_valid = _segment_data(buf, dt)
    t_now = newest_time(buf)
    t_cap, n = qax.shape

    pc = pixel_centers(width, height, cam)
    px = pc[..., 0].reshape(-1)
    py = pc[..., 1].reshape(-1)
    if params.camera_frame:
        # pixels are boosted-view points: evaluate everything at the ground
        # query point the inverse warp gives
        ox, oy = boost.unwarp_xy(px - cam.pos[0], py - cam.pos[1], cam.vel[0], cam.vel[1])
        px = cam.pos[0] + ox
        py = cam.pos[1] + oy
    relx, rely = px - cam.pos[0], py - cam.pos[1]
    r = torch.sqrt(relx * relx + rely * rely)
    inv_r = 1.0 / torch.clamp(r, min=1e-12)
    dhx, dhy = relx * inv_r, rely * inv_r

    fax, fay = qax.reshape(-1), qay.reshape(-1)
    fbx, fby = qbx.reshape(-1), qby.reshape(-1)
    fta = ta.repeat_interleave(n)
    valid_f = seg_valid.repeat_interleave(n) & (torch.abs(fax) < 1e8)
    fobj = obj_index.long().repeat(t_cap)
    fvx = buf.vel_x[:t_cap].reshape(-1)
    fvy = buf.vel_y[:t_cap].reshape(-1)

    t_e = t_now - r if params.retarded else t_now.expand(r.shape)
    inside, dist2 = _occupancy_xy(
        px[:, None], py[:, None], t_e[:, None],
        fax[None], fay[None], fbx[None], fby[None], fta[None], dt, rho,
    )
    inside = inside & valid_f[None, :]
    dist2 = torch.where(inside, dist2, _BIG)
    best = torch.argmin(dist2, dim=1)
    occupied = torch.gather(inside, 1, best[:, None])[:, 0]

    hit, s_hit = _ray_hit_xy(
        cam.pos[0], cam.pos[1], dhx[:, None], dhy[:, None],
        fax[None], fay[None], fbx[None], fby[None], fta[None], t_now, dt, rho,
    )
    s_hit = torch.where(hit & valid_f[None, :], s_hit, _BIG)
    s_first = s_hit.amin(dim=1)

    obj = fobj[best]
    cr, cg, cb = (objects.base_color[:, c][obj] for c in range(3))
    nx, ny = -dhx, -dhy
    d = doppler_factor_xy(fvx[best], fvy[best], nx, ny) * camera_doppler_factor_xy(
        cam.vel[0], cam.vel[1], nx, ny
    )
    sr, sg, sb = shade_channels(cr, cg, cb, d, params)
    if params.opaque and params.retarded:
        blocked = s_first < (r - 2.0 * params.rho)
        comp = lambda s: torch.where(
            occupied,
            torch.where(blocked, s * params.absorbed_dim, s),
            torch.where(blocked, params.shadow, 1.0),
        )
    else:
        comp = lambda s: torch.where(occupied, s, 1.0)
    img = torch.stack([comp(sr), comp(sg), comp(sb)], dim=-1)
    return img.reshape(height, width, 3)
