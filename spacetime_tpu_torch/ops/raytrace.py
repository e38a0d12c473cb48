"""Retarded-time raytracer over the worldline ring (flat spacetime).

Counterpart of the flat retarded path of `spacetime_tpu/ops/raytrace.py`.
What map point p shows is what the camera at c sees of p at coordinate time
t_now: the event (p, t_now - |p - c|) on its past light cone.  Softbodies
are unions of radius-rho discs; between stored ticks each disc sweeps a
linear capsule in (x, y, t).

Per frame (`render_retarded`):
  1. `_band_pairs`: a dense sweep over the ring finds each particle's
     cone-crossing tick band; its (N, band) segments become pair rows of 10
     fields (`_F_*`), culled to the view hull.
  2. compaction to `pair_budget`; with a boundary mask, boundary pairs go to
     the front so the occlusion retina reads a prefix of `retina_budget`.
  3. `_retina`: the first hit per angle over the retina pairs.
  4. `_splat_csr`: every pair splats into the view cells (k x k pixel
     blocks) its capsule can reach; a stable sort on (cell, quantized
     distance) keys yields a per-cell CSR of entries, nearest first,
     keeping `bin_capacity` per cell and an `entry_budget` prefix.
  5. the pixel pass (ops/render_cuda.py): per pixel, the nearest in-time
     capsule of its cell, Doppler/beaming shading and occlusion.

Only steps 5's kernel is CUDA; the sweep, compaction, retina and splat are
plain torch on every device (in the JAX package they are XLA, not Pallas).
Not ported yet: the camera-frame (boosted) view, the instantaneous view
(`retarded=False`), `segments` rank compaction, the nearest-corner 2x2
splat (`splat_cells=4`) and the band kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..camera import Camera, pixel_centers
from ..constants import C2
from ..state import Objects
from . import render_cuda
from .worldline import WorldlineBuffer

_BIG = 3.0e38
_PI = np.float32(np.pi)
_DQ = 64  # splat-key distance-quantization levels (nearest-k bin retention)


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static renderer configuration (the JAX package's fields that the flat
    retarded path reads; same names, same defaults)."""

    dt: float = 0.005  # history tick spacing (= PhysicsParams.h when pushed every step)
    rho: float = 0.0026  # particle render radius
    band: int = 6  # cone-crossing ticks kept per particle
    segments: int = 0  # rank compaction of valid crossings (not ported: 0 only)
    bin_capacity: int = 64  # candidates kept per view cell, nearest first
    num_rays: int = 2048  # 1D retina resolution (occlusion only)
    ray_chunk: int = 8192  # pairs per chunk of the retina march
    cell_px: int = 16  # view-cell edge in pixels; k * pixel_size must be >= reach
    pair_budget: int = 131072  # compact valid pairs to this many rows (0 = never)
    entry_budget: int = 0  # cap on sorted splat entries (0 = all)
    opaque: bool = True  # False = x-ray: no occlusion shading
    retarded: bool = True  # False = instantaneous view (not ported)
    camera_frame: bool = False  # boosted map view (not ported)
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

    @property
    def reach(self) -> float:
        """Max capsule reach: rho + half a max-speed tick of motion."""
        return self.rho + 0.5 * self.dt


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


def _cone_band_window(buf: WorldlineBuffer, params: RenderParams, cam: Camera):
    """Each particle's cone-crossing tick band and its window.

    Because |v| < c while the cone radius grows at c per tick,
    f(age) = |pos(age) - cam| - age * dt is monotone, so each worldline
    crosses the cone in one contiguous band.  One dense sweep over ages
    [0, A) finds the youngest entering age a0 and the oldest crossing age;
    the window holds ages [a0 + band - 1 .. a0 - 1] as ascending mirrored
    rows, read by one gather.

    Returns (a0, hi0, truncated, (wx, wy, wvx, wvy, ages)), window tensors
    (N, band + 1).  Window rows outside the swept ages hold the ring's
    values there; they only feed pairs that fail the age-range validity."""
    dt, rho, band = params.dt, params.rho, params.band
    t_cap = buf.capacity
    n = buf.num_particles
    dev = buf.pos_x.device
    thresh = rho + dt
    base_col = buf.cursor + t_cap  # mirrored row of age 0
    a_sw = t_cap if params.max_age <= 0 else min(params.max_age, t_cap)
    col0 = buf.cursor + 1 + (t_cap - a_sw)  # rows col0.. hold ages A-1 .. 0
    # no window column (or its younger endpoint) may reach an unswept tick
    hi0 = min(buf.frames_in_use - 1, t_cap - 1, a_sw - 1)
    route = _euclid_route(cam.pos[0], cam.pos[1])

    sx = buf.pos_x[col0:col0 + a_sw]
    sy = buf.pos_y[col0:col0 + a_sw]
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
    return a0, hi0, truncated, (
        window(buf.pos_x), window(buf.pos_y), window(buf.vel_x), window(buf.vel_y), ages
    )


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


def _band_pairs(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                t_now, width: int, height: int, params: RenderParams):
    """Cone-crossing segments in the (N * band) pair layout, validity
    re-checked exactly per segment and culled to the view + camera hull.
    Returns (PairData, band_truncated, segment_dropped)."""
    dt, rho, band = params.dt, params.rho, params.band
    if 0 < params.segments < band:
        raise NotImplementedError("segments rank compaction is not ported yet")
    n = buf.num_particles
    cxm, cym = cam.pos[0], cam.pos[1]
    a0, hi0, truncated, (wx, wy, wvx, wvy, ages) = _cone_band_window(buf, params, cam)
    route = _euclid_route(cxm, cym)

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
    return pairs, truncated, None


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
    # clamp before the int cast (far sentinels would overflow i32); values
    # past the clamp are out of the grid for every splat offset either way
    cell_x = torch.floor((cx - gx0) / lam).clamp(-2, wc + 1).to(torch.int32)
    cell_y = torch.floor((cy - gy0) / lam).clamp(-2, hc + 1).to(torch.int32)

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
    cell_too_small = lam < params.reach  # a 3x3 splat needs cells >= the reach
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
    phi = torch.atan2(pyw - cam.pos[1], pxw - cam.pos[0])
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
                       params: RenderParams, boundary=None):
    """Steps 1-4 of the frame (see the module docstring).  Returns
    (PixelInputs, RenderDiag); the diag fields are device tensors."""
    if params.camera_frame:
        raise NotImplementedError("camera_frame needs ops/boost.py, not ported yet")
    if not params.retarded:
        raise NotImplementedError("retarded=False needs _instant_pairs, not ported yet")
    t_now = buf.times[buf.cursor]
    use_rays = params.opaque

    retina_dropped = None
    pairs_raw, band_truncated, segment_dropped = _band_pairs(
        buf, obj_index, objects, cam, t_now, width, height, params
    )
    if use_rays and boundary is not None and 0 < params.retina_budget < pairs_raw.pdata.shape[0]:
        # boundary pairs at the buffer front; the retina reads a prefix
        rmask = boundary.repeat_interleave(params.band)
        pairs, n_b = _compact_pairs_two_segment(pairs_raw, rmask, params.pair_budget)
        rb = min(params.retina_budget, pairs.pdata.shape[0])
        n_r = torch.clamp(n_b, max=rb)
        in_prefix = torch.arange(rb, device=n_b.device) < n_r
        rpairs = PairData(pdata=pairs.pdata[:rb], pair_valid=pairs.pair_valid[:rb] & in_prefix,
                          n_pairs=n_r)
        retina_dropped = torch.clamp(n_b - rb, min=0)
    else:
        pairs = _compact_pairs_to_budget(pairs_raw, params.pair_budget)
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
):
    """(image, RenderDiag).  The image is (H, W, 3), or (3, H, W) with
    `planar`.  `boundary` ((N,) bool, e.g. worldline.boundary_mask) enables
    the boundary-only occlusion retina when params.retina_budget > 0.
    RenderDiag fields are device tensors (no host sync)."""
    inputs, diag = prepare_pixel_pass(
        buf, obj_index, objects, cam, width, height, params, boundary
    )
    img = render_cuda.pixel_pass(inputs, params, width=width, height=height)
    return (img if planar else img.permute(1, 2, 0)), diag


def render_retarded(buf, obj_index, objects, cam, width, height, params,
                    planar=False, boundary=None):
    """The retarded-time image; see render_retarded_with_diag."""
    img, _ = render_retarded_with_diag(
        buf, obj_index, objects, cam, width, height, params, planar, boundary
    )
    return img


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
    t_now = buf.times[buf.cursor]
    t_cap, n = qax.shape

    pc = pixel_centers(width, height, cam)
    px = pc[..., 0].reshape(-1)
    py = pc[..., 1].reshape(-1)
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
