"""The retarded render of one frame, in plain torch: a frozen copy of the
port's plain-torch path (the dense cone band sweep, the pair rows with
rank compaction, the budget compaction, the boundary occlusion retina,
the view-cell splat CSR and the pixel pass over padded cell tables),
with the mesh and camera-frame branches left out.  The band search takes
a route length and leaves the view-hull cull out for the curved routes
(reference/conical.py, which shares the rest of the pair rows, the
compaction, the splat and the retina with this file).

It reads a ring laid out as the program's (four (2T, N) planes mirrored
on the time axis, the tick times, the cursor and the in-use count), the
particles' object index and boundary mask, the objects' colours, a camera
and the frame's render parameters, and returns the (3, H, W) image and
the render's counters.  It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..check import PLANES, RING_FIELDS, lowp

C2 = 1.0

_BIG = 3.0e38
_PI = np.float32(np.pi)
_DQ = 64  # splat-key distance-quantization levels (nearest-k bin retention)


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """The render parameters of a frame, field for field as the program
    names them (`from_fields` takes the program's as a dict)."""

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

    @classmethod
    def from_fields(cls, fields: dict) -> "RenderParams":
        """The parameters of `fields`; a field this copy does not know
        raises, so a program that grows one is not judged by a render that
        ignores it."""
        unknown = set(fields) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"render fields unknown to the reference: {sorted(unknown)}")
        return cls(**fields)


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


# ---------------------------------------------------------------------------
# Ring reads and the cone band sweep
# ---------------------------------------------------------------------------

class Ring(NamedTuple):
    """The worldline ring as the program lays it out."""

    pos_x: torch.Tensor  # (2T, N) f32, mirrored time axis
    pos_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    times: torch.Tensor  # (T,) f32, -inf = unused
    cursor: torch.Tensor  # () i32, the slot of the newest tick
    frames_in_use: torch.Tensor  # () i32

    @property
    def capacity(self) -> int:
        return self.times.shape[0]

    @property
    def num_particles(self) -> int:
        return self.pos_x.shape[1]


class Camera(NamedTuple):
    pos: torch.Tensor  # (2,) f32
    zoom: torch.Tensor  # () f32
    vel: torch.Tensor  # (2,) f32


def newest_time(buf: Ring) -> torch.Tensor:
    return buf.times.index_select(0, buf.cursor.reshape(1).long())[0]


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
    distance to the camera by default (the curved routes pass their
    geodesic lengths)."""

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


def _band_pairs(buf: Ring, obj_index, base_color, cam: Camera,
                t_now, width: int, height: int, params: RenderParams,
                cull_hull: bool = True, route_lengths=None):
    """Cone-crossing segments in the (N * band) pair layout, validity
    re-checked exactly per segment and, with `cull_hull`, culled to the
    view + camera hull.  With 0 < segments < band each particle keeps its
    first `segments` valid crossings, oldest first, in an (N * segments)
    layout.  `route_lengths(qx, qy) -> distance` is the cone metric (the
    curved routes; they turn the hull cull off), the Euclidean distance to
    the camera by default.  Returns (PairData, band_truncated,
    segment_dropped), the last a () i64 device tensor with compaction on,
    else None."""
    dt, rho, band = params.dt, params.rho, params.band
    n = buf.num_particles
    cxm, cym = cam.pos[0], cam.pos[1]
    # the program's band kernel (CUDA, Euclidean route) computes what this
    # dense sweep does
    bw = cone_band_window_plain(buf, params, cam, route_lengths)
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
    if cull_hull:
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
    prgb = base_color[obj_index.long()]  # (N, 3)
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


def _compact_by_class(pairs: PairData, key: torch.Tensor, budget: int,
                      n_classes_kept: int) -> PairData:
    """Stable-sort rows by class `key` and keep the first `budget`; rows of
    class >= n_classes_kept (invalid) become far sentinels."""
    order = torch.sort(key, stable=True).indices[:budget]
    ok = key[order] < n_classes_kept
    pdata = torch.where(ok[:, None], pairs.pdata[order], 2.0e9)
    return PairData(pdata=pdata, pair_valid=ok, n_pairs=pairs.n_pairs)


def _compact_pairs_to_budget(pairs: PairData, budget: int) -> PairData:
    """Valid rows first, in row order, cut to `budget` rows.  `n_pairs`
    stays the pre-budget count."""
    rows = pairs.pdata.shape[0]
    if budget <= 0 or budget >= rows:
        return pairs
    key = (~pairs.pair_valid).to(torch.int32)
    return _compact_by_class(pairs, key, budget, 1)


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
    cell_too_small = lam < min_lam
    geom = (wc_img, hc_img, pixel_size, x0, y0)
    return key, val, wc, hc, geom, cell_too_small


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
# Occlusion retina
# ---------------------------------------------------------------------------


def _ray_angles(n_rays: int, device):
    """Ray angles -pi + (i + 0.5) 2pi / n_rays, in the reference's f32 steps."""
    step = np.float32(2 * _PI / n_rays)
    i = torch.arange(n_rays, dtype=torch.float32, device=device)
    return -float(_PI) + (i + 0.5) * float(step)


def _retina(pairs: PairData, cam: Camera, t_now, params: RenderParams):
    """First-hit arclength per angle over all pairs: s_first (num_rays,)."""
    dt, rho = params.dt, params.rho
    dev = pairs.pdata.device
    theta = _ray_angles(params.num_rays, dev)
    dhx = torch.cos(theta)[:, None]
    dhy = torch.sin(theta)[:, None]
    pd = pairs.pdata
    s_first = torch.full((params.num_rays,), _BIG, dtype=torch.float32, device=dev)
    for a in range(0, pd.shape[0], params.ray_chunk):
        c = pd[a:a + params.ray_chunk]
        hit, s_hit = _ray_hit_xy(
            cam.pos[0], cam.pos[1], dhx, dhy,
            c[None, :, _F_AX], c[None, :, _F_AY], c[None, :, _F_BX],
            c[None, :, _F_BY], c[None, :, _F_TA], t_now, dt, rho,
        )
        ok = hit & pairs.pair_valid[None, a:a + params.ray_chunk]
        s_hit = torch.where(ok, s_hit, _BIG)
        s_first = torch.minimum(s_first, s_hit.amin(dim=1))
    return s_first


def _occlusion_ds(params: RenderParams) -> int:
    ds = max(1, params.occlusion_downsample)
    return ds if params.cell_px % ds == 0 else 1


def _sfirst_lookup(s_first, gxq, gyq, x0, y0, pixel_size, cam, n_rays, off):
    """Retina value at the angle of pixel (gxq, gyq) + `off` pixels."""
    pxw = x0 + (gxq.to(torch.float32) + off) * pixel_size
    pyw = y0 + (gyq.to(torch.float32) + off) * pixel_size
    ox = pxw - cam.pos[0]
    oy = pyw - cam.pos[1]
    phi = torch.atan2(oy, ox)
    ri = torch.floor((phi + float(_PI)) / float(np.float32(2 * _PI)) * n_rays)
    ri = ri.clamp(0, n_rays - 1).long()
    return s_first[ri]


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
        (ds - 1) * 0.5,
    ).contiguous()


# ---------------------------------------------------------------------------
# The pixel pass and the frame's render
# ---------------------------------------------------------------------------

PLAIN_CELL_CHUNK = 256  # view cells per block of the pixel pass


class PixelInputs(NamedTuple):
    """Everything the pixel pass reads for one frame."""

    entries: torch.Tensor  # (E, 10) f32 splat entries, per-cell CSR order
    cell_lo: torch.Tensor  # (hc_img * wc_img,) i32
    cell_hi: torch.Tensor  # (hc_img * wc_img,) i32
    sfq: object  # (hc_img * k / d, wc_img * k / d) f32 retina per quad, or None
    scal: torch.Tensor  # (8,) f32: t_now, cam x, y, vx, vy, x0, y0, pixel size
    wc_img: int
    hc_img: int
    ds: int  # occlusion downsample d


def _f32(x) -> float:
    return float(np.float32(x))


def _edge_constants(params):
    """(rho2_edge, inv_dt): one f32 ULP past rho^2, so `dist2 < rho2_edge` is
    exactly `dist2 <= rho^2`, and 1/dt in f32."""
    rho2 = np.float32(params.rho * params.rho)
    return float(np.nextafter(rho2, np.float32(np.inf))), _f32(1.0 / params.dt)


def pixel_pass_plain(inputs, params, *, width, height):
    """Per pixel, over chunks of cells: the CSR gathered into a padded
    (cells, bin_capacity, 10) table, the winner taken by argmin (the first
    minimum in entry order), shading and occlusion.  Returns (3, H, W)."""

    entries, cell_lo, cell_hi, sfq, scal, wc_img, hc_img, ds = inputs
    k, cap = params.cell_px, params.bin_capacity
    dev = entries.device
    row0, count, out_h = 0, hc_img, height
    rho2_edge, inv_dt = _edge_constants(params)
    t_now, cxm, cym, cvx, cvy, x0, y0, ps = scal.unbind()
    wp = wc_img * k
    out = torch.zeros((3, max(count * k, out_h) * wp), dtype=torch.float32, device=dev)
    sub = torch.arange(k * k, device=dev)
    slots = torch.arange(cap, device=dev)
    last = max(entries.shape[0] - 1, 0)
    first_cell, end_cell = row0 * wc_img, (row0 + count) * wc_img
    for a in range(first_cell, end_cell, PLAIN_CELL_CHUNK):
        cells = torch.arange(a, min(a + PLAIN_CELL_CHUNK, end_cell), device=dev)
        lo = cell_lo[cells].long()
        idx = lo[:, None] + slots[None, :]  # (C, cap)
        ok = idx < cell_hi[cells, None]
        tab = entries[idx.clamp(max=last)]  # (C, cap, 10)
        gx = (cells % wc_img)[:, None] * k + sub % k  # (C, k2)
        gy = (cells // wc_img)[:, None] * k + sub // k
        pxw = x0 + gx.to(torch.float32) * ps
        pyw = y0 + gy.to(torch.float32) * ps
        relx, rely = pxw - cxm, pyw - cym
        r = torch.sqrt(relx * relx + rely * rely)
        t_e = t_now - r if params.retarded else t_now.expand(r.shape)

        fld = lambda f: tab[:, None, :, f]  # (C, 1, cap)
        tau = (t_e[:, :, None] - fld(_F_TA)) * inv_dt
        in_time = torch.abs(tau - 0.5) <= 0.501
        tc = torch.clamp(tau, 0.0, 1.0)
        dx = pxw[:, :, None] - (fld(_F_AX) + tc * (fld(_F_BX) - fld(_F_AX)))
        dy = pyw[:, :, None] - (fld(_F_AY) + tc * (fld(_F_BY) - fld(_F_AY)))
        d2 = dx * dx + dy * dy
        cand = ok[:, None, :] & in_time & (d2 < rho2_edge)
        best = torch.argmin(torch.where(cand, d2, float("inf")), dim=2)  # (C, k2)
        occupied = torch.gather(cand, 2, best[:, :, None])[:, :, 0]
        win = lambda f: torch.gather(tab[:, :, f], 1, best)

        inv_r = 1.0 / torch.clamp(r, min=1e-12)
        nx, ny = (cxm - pxw) * inv_r, (cym - pyw) * inv_r
        d = doppler_factor_xy(win(_F_VX), win(_F_VY), nx, ny) * \
            camera_doppler_factor_xy(cvx, cvy, nx, ny)
        shaded = shade_channels(win(_F_CR), win(_F_CG), win(_F_CB), d, params)
        if sfq is not None:
            blocked = sfq[gy // ds, gx // ds] < (r - 2.0 * params.rho)
            bg = torch.where(blocked, params.shadow, 1.0)
            shaded = [torch.where(blocked, s * params.absorbed_dim, s) for s in shaded]
        else:
            bg = torch.ones_like(r)
        flat = ((gy - row0 * k) * wp + gx).reshape(-1)
        for c, s in enumerate(shaded):
            out[c, flat] = torch.where(occupied, s, bg).reshape(-1)
    return out.reshape(3, -1, wp)[:, :out_h, :width].contiguous()


def render(buf: Ring, obj_index, boundary, base_color, cam: Camera, width: int, height: int,
           params: RenderParams):
    """The frame's retarded image, (3, H, W) f32, and its RenderDiag, as
    the program's render stage computes them from the same ring."""
    if params.camera_frame or not params.retarded or not params.opaque:
        raise ValueError("the reference renders the opaque ground-frame retarded view only")
    t_now = newest_time(buf)
    pairs_raw, band_truncated, segment_dropped = _band_pairs(
        buf, obj_index, base_color, cam, t_now, width, height, params)
    rows = pairs_raw.pdata.shape[0]
    retina_dropped = None
    if 0 < params.retina_budget < rows:
        # boundary pairs at the buffer front; the retina reads a prefix
        n = boundary.shape[0]
        k_rows = params.segments if 0 < params.segments < params.band else params.band
        rmask = boundary[:, None].expand(n, k_rows).reshape(-1)
        pairs, n_b = _compact_pairs_two_segment(pairs_raw, rmask, params.pair_budget)
        rb = min(params.retina_budget, pairs.pdata.shape[0])
        n_r = torch.clamp(n_b, max=rb)
        in_prefix = torch.arange(rb, device=n_b.device) < n_r
        rpairs = PairData(pdata=pairs.pdata[:rb],
                          pair_valid=pairs.pair_valid[:rb] & in_prefix, n_pairs=n_r)
        retina_dropped = torch.clamp(n_b - rb, min=0)
    else:
        pairs = _compact_pairs_to_budget(pairs_raw, params.pair_budget)
        rpairs = pairs
    entries, cell_lo, cell_hi, bin_dropped, entry_dropped, cell_too_small, geom = _splat_csr(
        pairs, cam, width, height, params)
    wc_img, hc_img, pixel_size, x0, y0 = geom
    s_first = _retina(rpairs, cam, t_now, params)
    sfq = _retina_quads(s_first, cam, width, height, params, geom)
    scal = torch.stack(
        [t_now, cam.pos[0], cam.pos[1], cam.vel[0], cam.vel[1], x0, y0, pixel_size]
    ).to(torch.float32)
    inputs = PixelInputs(entries, cell_lo, cell_hi, sfq, scal, wc_img, hc_img,
                         _occlusion_ds(params))
    img = pixel_pass_plain(inputs, params, width=width, height=height)
    diag = RenderDiag(pairs_used=pairs.n_pairs, band_truncated=band_truncated,
                      bin_dropped=bin_dropped, cell_too_small=cell_too_small,
                      retina_dropped=retina_dropped, entry_dropped=entry_dropped,
                      segment_dropped=segment_dropped)
    return img, diag


# the check's entry points (../check.py, found by spec.mode_reference)

CONFIG_KEYS = frozenset()  # configuration keys read beyond check.CONFIG_KEYS
# render fields whose values `render` reproduces only as listed (see its guard)
RENDER = {"camera_frame": (False,), "retarded": (True,), "opaque": (True,)}
FULL_RING = True  # the image reads the whole ring after the frame


def image(s, after, ring, colors, config):
    """The (3, H, W) image and the counters of the frame of check.Sample
    `s`, from the particles `after` its tick and `ring`, the ring after
    the frame (`config`, the values of CONFIG_KEYS, is empty)."""
    buf = Ring(**{k: ring[k] for k in RING_FIELDS})
    pos, zoom, vel = s.cam
    params = RenderParams.from_fields(s.params)
    boundary = after["active"] & (after["neighbors"] < 0).any(dim=1)
    img, diag = render(buf, after["object_index"], boundary, colors, Camera(pos, zoom, vel),
                       s.image.shape[2], s.image.shape[1], params)
    return img, {k: v for k, v in diag._asdict().items() if v is not None}


def control(s, after, colors, config):
    """The bfloat16 control's image and counters: `image` of the ring the
    frame saw after it, its planes rounded to bfloat16."""
    return image(s, after, {**s.ring, **{k: lowp(s.ring[k]) for k in PLANES}}, colors, config)
