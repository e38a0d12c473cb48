"""The conical mode's render of one frame, in plain torch: a frozen copy of
the port's retarded-time render around conical defects (the single-device
path of its curved renderer), with the mesh branch left out.

A point mass in 2+1 dimensions turns space into a cone: flat but for an
angle deficit at the defect.  Light reaches the camera along the chart's
straight chord (route 1) and, where the angle left around the back of the
cone is under pi, along a second geodesic around it (route 2); several
defects superpose one back route each.  A frame:
  1. one band sweep per route with that route's length and no view-hull
     cull (retarded._band_pairs), as the program's CPU path runs both (its
     band kernel takes route 1 on the card and computes the same);
  2. every route's pairs compacted to one `pair_budget`;
  3. the view tables: each view cell's splat run (retarded._splat_csr)
     padded to `bin_capacity` rows;
  4. with `opaque`, one retina per route over the whole compacted table,
     route 2's over the candidates' rotated images;
  5. the route pass over blocks of view cells: per pixel the shortest
     visible route wins, else the shortest occupied one, dimmed;
  6. the image assembled from the cells.
Its counters are those the program packs in this mode: no
`retina_dropped`, and `pairs_used`, `band_truncated` and `segment_dropped`
summed over the routes.

The defects are the configuration's `defect` (static; the check refuses
the program's moving and matter-sourced defects before a run).  It imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..check import PLANES, RING_FIELDS, lowp
from .retarded import (
    _BIG, _F_AX, _F_AY, _F_BX, _F_BY, _F_CB, _F_CG, _F_CR, _F_TA, _F_VX, _F_VY, _PI,
    Camera, PairData, RenderDiag, RenderParams, Ring, _band_pairs, _compact_pairs_to_budget,
    _retina, _splat_csr, _view_grid, camera_doppler_factor_xy, doppler_factor_xy,
    newest_time, shade_channels,
)

_TWO_PI = 2.0 * math.pi
# a route pass tests every pixel of a view cell against every candidate of
# its table, (cells, k * k, bin_capacity) elements; it runs over blocks of
# cells of at most this many elements
ROUTE_PASS_ELEMENTS = 1 << 23


class Defect(NamedTuple):
    center: torch.Tensor  # (2,) f32, chart coordinates
    deficit: torch.Tensor  # () f32, the deficit angle (8 pi G M) in radians


def defects(spec, device) -> tuple:
    """The Defects of a configuration's `defect`: one ((cx, cy), deficit),
    or a list of them."""
    specs = spec if isinstance(spec[0][0], (list, tuple)) else [spec]
    return tuple(Defect(torch.tensor(c, dtype=torch.float32, device=device),
                        torch.full((), d, dtype=torch.float32, device=device))
                 for c, d in specs)


def floored_mod(x, m: float):
    """x mod m (m > 0) as the floored remainder in [0, m), by fmod and a
    sign fix (torch.remainder rounds otherwise)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


# ---------------------------------------------------------------------------
# Geodesics on the cone
# ---------------------------------------------------------------------------


def geodesic_lengths_xy(ax, ay, bx, by, defect: Defect):
    """(l1, l2, valid2): the chord between chart points a and b, the route
    around the back (_BIG where it does not exist), and where it does."""
    dxc, dyc = defect.center[0], defect.center[1]
    rax, ray_ = ax - dxc, ay - dyc
    rbx, rby = bx - dxc, by - dyc
    ra = torch.sqrt(rax * rax + ray_ * ray_)
    rb = torch.sqrt(rbx * rbx + rby * rby)
    ex, ey = ax - bx, ay - by
    l1 = torch.sqrt(ex * ex + ey * ey)
    cos_d = torch.clamp((rax * rbx + ray_ * rby) / torch.clamp(ra * rb, min=1e-12), -1.0, 1.0)
    d_phi = torch.acos(cos_d)
    back = (_TWO_PI - defect.deficit) - d_phi
    valid2 = back < math.pi
    l2 = torch.sqrt(torch.clamp(ra * ra + rb * rb - 2.0 * ra * rb * torch.cos(back), min=0.0))
    return l1, torch.where(valid2, l2, _BIG), valid2


def _route2_theta(px, py, cam: Camera, defect: Defect):
    """The rotation about the defect that maps chart points to their
    route-2 images seen from the camera: -sign(bearing - camera bearing)
    times the cone's angle, the bearing difference wrapped to [-pi, pi)."""
    cx, cy = defect.center[0], defect.center[1]
    phi_c = torch.atan2(cam.pos[1] - cy, cam.pos[0] - cx)
    d = torch.atan2(py - cy, px - cx) - phi_c
    d = floored_mod(d + math.pi, _TWO_PI) - math.pi
    alpha = _TWO_PI - defect.deficit
    return torch.where(d >= 0, -alpha, alpha)


def _rotate_about(px, py, theta, defect: Defect):
    cx, cy = defect.center[0], defect.center[1]
    ct, st = torch.cos(theta), torch.sin(theta)
    rx, ry = px - cx, py - cy
    return cx + ct * rx - st * ry, cy + st * rx + ct * ry


def _route2_image_pairs(pairs: PairData, cam: Camera, defect: Defect) -> PairData:
    """The candidates' route-2 images: endpoints and velocity rotated about
    the defect by the angle of each candidate's midpoint."""
    pd = pairs.pdata
    mx = 0.5 * (pd[:, _F_AX] + pd[:, _F_BX])
    my = 0.5 * (pd[:, _F_AY] + pd[:, _F_BY])
    theta = _route2_theta(mx, my, cam, defect)
    ax, ay = _rotate_about(pd[:, _F_AX], pd[:, _F_AY], theta, defect)
    bx, by = _rotate_about(pd[:, _F_BX], pd[:, _F_BY], theta, defect)
    ct, st = torch.cos(theta), torch.sin(theta)
    vx = ct * pd[:, _F_VX] - st * pd[:, _F_VY]
    vy = st * pd[:, _F_VX] + ct * pd[:, _F_VY]
    pdata = torch.stack([ax, ay, bx, by, pd[:, _F_TA], vx, vy,
                         pd[:, _F_CR], pd[:, _F_CG], pd[:, _F_CB]], dim=1)
    return PairData(pdata=pdata, pair_valid=pairs.pair_valid, n_pairs=pairs.n_pairs)


# ---------------------------------------------------------------------------
# Dense per-cell tables
# ---------------------------------------------------------------------------


class ViewTables(NamedTuple):
    vdat: torch.Tensor  # (n_img_cells, cap, 10) f32 pair rows, CSR order
    vok: torch.Tensor  # (n_img_cells, cap) bool
    n_img_cells: int


def _build_view_tables(pairs: PairData, cam: Camera, width: int, height: int,
                       params: RenderParams):
    """Each image cell's CSR run padded to bin_capacity rows in CSR order;
    empty slots hold entry 0's row, masked by `vok`.  Returns (ViewTables,
    bin_dropped, entry_dropped, cell_too_small, geom)."""
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
    (n_img_cells, k * k), cells in row order, pixels row-major in a cell."""
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


def _occupancy_xy(px, py, t_e, ax, ay, bx, by, ta, dt, rho):
    """Is map point (px, py) inside the segment's capsule at event time
    t_e?  Returns (inside, dist2)."""
    tau = (t_e - ta) / dt
    in_time = (tau >= -0.001) & (tau <= 1.001)
    tau_c = torch.clamp(tau, 0.0, 1.0)
    d_x = px - (ax + tau_c * (bx - ax))
    d_y = py - (ay + tau_c * (by - ay))
    dist2 = d_x * d_x + d_y * d_y
    return in_time & (dist2 <= rho * rho), dist2


def _occupancy_cells(px, py, t_e, vdat, vok, dt, rho):
    """Pixels (C, k2) at event times t_e against their cells' candidates:
    (occupied (C, k2), winner (C, k2) i64), the winner the first candidate
    in table order of least squared distance, 0 where none is inside."""
    inside, dist2 = _occupancy_xy(
        px[:, :, None], py[:, :, None], t_e[:, :, None],
        vdat[:, None, :, _F_AX], vdat[:, None, :, _F_AY],
        vdat[:, None, :, _F_BX], vdat[:, None, :, _F_BY],
        vdat[:, None, :, _F_TA], dt, rho,
    )
    inside = inside & vok[:, None, :]
    min_d, winner = torch.where(inside, dist2, _BIG).min(dim=2)
    return min_d < _BIG, winner


def _field_at(vdat, winner, field: int):
    return torch.gather(vdat[:, :, field], 1, winner)


# ---------------------------------------------------------------------------
# The route pass and the frame
# ---------------------------------------------------------------------------


def _retina_at(s_first, phi, n_rays: int):
    """The retina's value at bearing `phi` (its 2 pi / n_rays bin)."""
    ri = torch.floor((phi + float(_PI)) / float(np.float32(2 * _PI)) * n_rays)
    return s_first[ri.long().clamp(0, n_rays - 1)]


def _winning_route(routes, visible_only: bool, like):
    """Per pixel the index of the shortest route that is occupied (and,
    with `visible_only`, not blocked), -1 for none; the first of equals."""
    best_lp = torch.full_like(like, _BIG)
    sel = torch.full(like.shape, -1, dtype=torch.int32, device=like.device)
    for i, r in enumerate(routes):
        cond = r["occ"] & ~r["blk"] if visible_only else r["occ"]
        better = cond & (r["lp"] < best_lp)
        best_lp = torch.where(better, r["lp"], best_lp)
        sel = torch.where(better, i, sel)
    return sel


def _compose(routes, visible, occupied, params: RenderParams, use_rays: bool):
    """Visible matter, then occupied matter dimmed, then the background,
    shadowed where every route that exists is blocked (opaque)."""
    if not use_rays:
        return lambda s: torch.where(occupied, s, 1.0)
    bg_blocked = routes[0]["blk"]
    for r in routes[1:]:
        bg_blocked = bg_blocked & (r["blk"] | (r["lp"] >= _BIG))
    background = torch.where(bg_blocked, params.shadow, 1.0)
    return lambda s: torch.where(visible, s,
                                 torch.where(occupied, s * params.absorbed_dim, background))


def _shade(vx, vy, cr, cg, cb, r_eff, ex, ey, cam: Camera, params: RenderParams):
    """Doppler and beaming with the arrival direction from the emission
    point (ex, ey) at route length r_eff."""
    inv_r = 1.0 / torch.clamp(r_eff, min=1e-12)
    nx = (cam.pos[0] - ex) * inv_r
    ny = (cam.pos[1] - ey) * inv_r
    d = doppler_factor_xy(vx, vy, nx, ny) * camera_doppler_factor_xy(
        cam.vel[0], cam.vel[1], nx, ny)
    return shade_channels(cr, cg, cb, d, params)


def _route_pass_block(vdat, vok, px, py, t_now, cam: Camera, defs, retinas,
                      params: RenderParams):
    """The route pass over one block of view cells: (C, 3, k2) colours."""
    dt, rho = params.dt, params.rho
    cxm, cym = cam.pos[0], cam.pos[1]
    use_rays = retinas is not None
    n_rays = params.num_rays
    ex1, ey1 = px - cxm, py - cym
    lp1 = torch.sqrt(ex1 * ex1 + ey1 * ey1)
    occ1, win1 = _occupancy_cells(px, py, t_now - lp1, vdat, vok, dt, rho)
    if use_rays:
        blk1 = _retina_at(retinas[0], torch.atan2(py - cym, px - cxm), n_rays) < (lp1 - 2.0 * rho)
    else:
        blk1 = torch.zeros_like(occ1)
    routes = [dict(lp=lp1, occ=occ1, win=win1, blk=blk1, ex=px, ey=py, theta=None)]
    for i, d in enumerate(defs):
        _l1, lp2, v2 = geodesic_lengths_xy(px, py, cxm, cym, d)
        occ2, win2 = _occupancy_cells(px, py, t_now - lp2, vdat, vok, dt, rho)
        occ2 = occ2 & v2
        theta_p = _route2_theta(px, py, cam, d)
        rpx, rpy = _rotate_about(px, py, theta_p, d)
        if use_rays:
            blk2 = _retina_at(retinas[i + 1], torch.atan2(rpy - cym, rpx - cxm),
                              n_rays) < (lp2 - 2.0 * rho)
        else:
            blk2 = torch.zeros_like(occ2)
        routes.append(dict(lp=lp2, occ=occ2, win=win2, blk=blk2, ex=rpx, ey=rpy, theta=theta_p))

    vis_idx = _winning_route(routes, True, lp1)
    occ_idx = _winning_route(routes, False, lp1)
    visible = vis_idx >= 0
    occupied = occ_idx >= 0
    route_idx = torch.where(visible, vis_idx, occ_idx)

    winner = routes[0]["win"]
    r_eff, ex, ey = lp1, px, py
    for i, r in enumerate(routes[1:], start=1):
        m = route_idx == i
        winner = torch.where(m, r["win"], winner)
        r_eff = torch.where(m, r["lp"], r_eff)
        ex = torch.where(m, r["ex"], ex)
        ey = torch.where(m, r["ey"], ey)
    # a back route's emitter velocity is parallel-transported: rotated by
    # the pixel's angle
    vx0 = _field_at(vdat, winner, _F_VX)
    vy0 = _field_at(vdat, winner, _F_VY)
    vx, vy = vx0, vy0
    for i, r in enumerate(routes[1:], start=1):
        m = route_idx == i
        ct, st = torch.cos(r["theta"]), torch.sin(r["theta"])
        vx = torch.where(m, ct * vx0 - st * vy0, vx)
        vy = torch.where(m, st * vx0 + ct * vy0, vy)
    cr, cg, cb = (_field_at(vdat, winner, f) for f in (_F_CR, _F_CG, _F_CB))
    sr, sg, sb = _shade(vx, vy, cr, cg, cb, r_eff, ex, ey, cam, params)
    comp = _compose(routes, visible, occupied, params, use_rays)
    return torch.stack([comp(sr), comp(sg), comp(sb)], dim=1)


def render(buf: Ring, obj_index, base_color, cam: Camera, defs, width: int, height: int,
           params: RenderParams):
    """The frame's image through the direct route and each defect's back
    route, (3, H, W) f32, and its RenderDiag, as the program's render stage
    computes them from the same ring."""
    if params.camera_frame or not params.retarded:
        raise ValueError("the reference renders the ground-frame retarded view only")
    t_now = newest_time(buf)
    use_rays = params.opaque

    def l2_of(d):
        return lambda qx, qy: geodesic_lengths_xy(qx, qy, cam.pos[0], cam.pos[1], d)[1]

    plist, band_truncated, seg_dropped = [], 0, None
    for fn in [None] + [l2_of(d) for d in defs]:
        p, trunc, segd = _band_pairs(buf, obj_index, base_color, cam, t_now, width, height,
                                     params, cull_hull=False, route_lengths=fn)
        plist.append(p)
        band_truncated = band_truncated + trunc
        if segd is not None:
            seg_dropped = segd if seg_dropped is None else seg_dropped + segd
    pairs = PairData(pdata=torch.cat([p.pdata for p in plist]),
                     pair_valid=torch.cat([p.pair_valid for p in plist]),
                     n_pairs=sum(p.n_pairs for p in plist))
    pairs = _compact_pairs_to_budget(pairs, params.pair_budget)
    tables, bin_dropped, entry_dropped, cell_too_small, geom = _build_view_tables(
        pairs, cam, width, height, params)
    wc_img, hc_img = geom[0], geom[1]
    diag = RenderDiag(pairs_used=pairs.n_pairs, band_truncated=band_truncated,
                      bin_dropped=bin_dropped, cell_too_small=cell_too_small,
                      retina_dropped=None, entry_dropped=entry_dropped,
                      segment_dropped=seg_dropped)
    retinas = None
    if use_rays:
        retinas = [_retina(pairs, cam, t_now, params)]
        retinas += [_retina(_route2_image_pairs(pairs, cam, d), cam, t_now, params)
                    for d in defs]
    pxs, pys = _cell_pixel_coords(width, height, cam, params)
    crgb = torch.cat([
        _route_pass_block(tables.vdat[b], tables.vok[b], pxs[b], pys[b], t_now, cam, defs,
                          retinas, params)
        for b in _cell_blocks(tables.n_img_cells, params)
    ])
    k = params.cell_px
    img = crgb.reshape(hc_img, wc_img, 3, k, k).permute(2, 0, 3, 1, 4)
    img = img.reshape(3, hc_img * k, wc_img * k)[:, :height, :width].contiguous()
    return img, diag


# the check's entry points (../check.py, found by spec.mode_reference)

CONFIG_KEYS = frozenset({"defect"})  # configuration keys read beyond check.CONFIG_KEYS
# render fields whose values `render` reproduces only as listed (see its guard);
# `opaque` at both values
RENDER = {"camera_frame": (False,), "retarded": (True,)}
FULL_RING = True  # the image reads the whole ring after the frame


def image(s, after, ring, colors, config):
    """The (3, H, W) image and the counters of the frame of check.Sample
    `s`, from the particles `after` its tick, `ring`, the ring after the
    frame, and `config`'s `defect`."""
    buf = Ring(**{k: ring[k] for k in RING_FIELDS})
    pos, zoom, vel = s.cam
    img, diag = render(buf, after["object_index"], colors, Camera(pos, zoom, vel),
                       defects(config["defect"], pos.device), s.image.shape[2],
                       s.image.shape[1], RenderParams.from_fields(s.params))
    return img, {k: v for k, v in diag._asdict().items() if v is not None}


def control(s, after, colors, config):
    """The bfloat16 control's image and counters: `image` of the ring the
    frame saw after it, its planes rounded to bfloat16."""
    return image(s, after, {**s.ring, **{k: lowp(s.ring[k]) for k in PLANES}}, colors, config)
