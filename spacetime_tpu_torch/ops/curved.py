"""Curved 2+1 spacetime: retarded-time rendering around conical defects.

Counterpart of `spacetime_tpu/ops/curved.py`.  A point mass M in 2+1D GR
curves space into a cone: flat everywhere but at the defect, with a total
angle alpha = 2 pi - deficit around it (deficit = 8 pi G M).  Between two
points there are up to two geodesics: route 1, the chart-straight segment
(the Euclidean chord), and route 2 "around the back", which spans the
angle alpha - d_phi and exists while that is below pi; by the law of
cosines L2 = sqrt(ra^2 + rb^2 - 2 ra rb cos(alpha - d_phi)).  Two routes
of different lengths reach the camera from two moments of a body's
history: a moving body near the defect shows two images.

Occlusion and arrival directions use the unrolled cone: rotating a chart
point about the defect by -sign(d_phi) alpha maps it to its route-2 image,
and route 2 from the camera is the chart-straight segment to that image.
So route-1 occlusion is the flat retina, route-2 occlusion a retina over
route-2-imaged (rotated) candidates, and the route-2 arrival direction and
the parallel-transported emitter velocity are rotated likewise.

A frame (`render_retarded_conical_with_diag`):
  1. one cone band search per route (`raytrace._band_pairs`, no view-hull
     cull: off-screen matter can occlude a curved route).  Route 1 is
     Euclidean and takes the band kernel on the card; a route-2 length has
     no kernel and takes the plain sweep on every device (the JAX package's
     Pallas band kernel takes the Euclidean route only);
  2. the routes' pairs concatenated and compacted to one `pair_budget`;
  3. the dense view tables (`raytrace._build_view_tables`);
  4. in opaque mode one occlusion retina per route, each over the whole
     compacted table (route 2's over its rotated images);
  5. the route pass over blocks of view cells: per pixel and route the
     occupancy against its cell's table, the shortest visible route wins
     (else the shortest occupied one, dimmed), shaded with that route's
     arrival direction and transported velocity.
Steps 2-5 are plain torch on every device, as the JAX package runs them
in XLA.  `RenderDiag.segment_dropped` is the sum over the routes (the JAX
package drops it).

On a mesh (`mesh`, parallel/) the ring holds this rank's particle columns:
step 1 runs on them, then each route's pair rows are all-gathered in rank
order with its band counters all-reduced (`raytrace._gather_pairs`), so
steps 2-5 run replicated and every rank renders the whole image (JAX runs
the same frame GSPMD-partitioned, `spacetime_tpu/engine.py:276-297`).

Multi-defect scenes (a tuple of defects) use the single-scattering
superposition: the direct route plus one back route per defect.
`render_conical_brute` is the exhaustive oracle of tests.

Modelling limits, as the JAX package documents: the physics runs in the
flat chart (keep bodies off the defect); the rotation sign is taken per
candidate and pixel from its bearing, so paths grazing d_phi ~ 0 or pi can
pick the other image; moving defects are quasi-static (or retarded, at the
Engine level).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..camera import Camera, pixel_centers
from ..state import Objects
from .raytrace import (
    _BIG, _F_AX, _F_AY, _F_BX, _F_BY, _F_CB, _F_CG, _F_CR, _F_TA, _F_VX, _F_VY, _PI,
    PairData, RenderDiag, RenderParams, _assemble_image, _band_pairs, _build_view_tables,
    _gather_pairs,
    _cell_blocks, _cell_pixel_coords, _compact_pairs_to_budget, _field_at,
    _occupancy_cells, _occupancy_xy, _ray_hit_xy, _retina, _segment_data,
    camera_doppler_factor_xy, doppler_factor_xy, floored_mod, shade_channels,
)
from .worldline import WorldlineBuffer, newest_time

_TWO_PI = 2.0 * math.pi
# the oracle tests pixels against every (slot, particle) segment in chunks
# of pixels holding at most this many (pixel, segment) elements
_BRUTE_ELEMENTS = 1 << 22


@dataclasses.dataclass(frozen=True)
class ConicalDefect:
    center: torch.Tensor  # (2,) f32: the defect's position in chart coordinates
    deficit: torch.Tensor  # () f32: the deficit angle in radians (8 pi G M)

    @staticmethod
    def create(center=(0.5, 0.5), deficit=0.8, device="cpu") -> "ConicalDefect":
        """A defect from host values (tensors are stacked as they are)."""
        if isinstance(center, torch.Tensor) or any(isinstance(c, torch.Tensor) for c in center):
            c = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device)
                             for v in center]).to(torch.float32)
        else:
            c = torch.tensor(center, dtype=torch.float32, device=device)
        if isinstance(deficit, torch.Tensor):
            d = deficit.to(device=c.device, dtype=torch.float32)
        else:
            # a fill, not a host copy: a CUDA graph may capture it
            d = torch.full((), deficit, dtype=torch.float32, device=c.device)
        return ConicalDefect(center=c, deficit=d)


def _defect_tuple(defect):
    return tuple(defect) if isinstance(defect, (tuple, list)) else (defect,)


def geodesic_lengths_xy(ax, ay, bx, by, defect: ConicalDefect):
    """Lengths of the two geodesics between chart points a and b (scalar
    components).  Returns (l1, l2, valid2): l1 the direct chart distance,
    l2 the around-the-back route (_BIG where it does not exist)."""
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


def geodesic_lengths(a, b, defect: ConicalDefect):
    """Vector form of geodesic_lengths_xy: a, b are (..., 2)."""
    return geodesic_lengths_xy(a[..., 0], a[..., 1], b[..., 0], b[..., 1], defect)


def _route2_theta(px, py, cam: Camera, defect: ConicalDefect):
    """Rotation angle mapping chart points to their route-2 images as seen
    from the camera: theta = -sign(bearing - camera bearing) alpha, so the
    rotated angular separation is alpha - |d_phi| (the back route).  The
    bearing difference wraps to [-pi, pi) as JAX's jnp.mod does (the
    floored remainder, not fmod)."""
    cx, cy = defect.center[0], defect.center[1]
    phi_c = torch.atan2(cam.pos[1] - cy, cam.pos[0] - cx)
    d = torch.atan2(py - cy, px - cx) - phi_c
    d = floored_mod(d + math.pi, _TWO_PI) - math.pi
    alpha = _TWO_PI - defect.deficit
    return torch.where(d >= 0, -alpha, alpha)


def _rotate_about(px, py, theta, defect: ConicalDefect):
    cx, cy = defect.center[0], defect.center[1]
    ct, st = torch.cos(theta), torch.sin(theta)
    rx, ry = px - cx, py - cy
    return cx + ct * rx - st * ry, cy + st * rx + ct * ry


def _route2_image_pairs(pairs: PairData, cam: Camera, defect: ConicalDefect) -> PairData:
    """Route-2 images of the candidates: segment endpoints and velocities
    rotated about the defect by each candidate's (midpoint) rotation angle.
    A straight retina over them is route-2 occlusion (the unrolled cone)."""
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


def _retina_at(s_first, phi, n_rays: int):
    """The retina value at bearing `phi` (its 2 pi / n_rays bin)."""
    ri = torch.floor((phi + float(_PI)) / float(np.float32(2 * _PI)) * n_rays)
    return s_first[ri.long().clamp(0, n_rays - 1)]


def _winning_route(routes, visible_only: bool, like):
    """Index of the shortest route that is occupied (and, with
    `visible_only`, not blocked) per pixel, -1 for none: the JAX package's
    masked minimum over the routes in order."""
    best_lp = torch.full_like(like, _BIG)
    sel = torch.full(like.shape, -1, dtype=torch.int32, device=like.device)
    for i, r in enumerate(routes):
        cond = r["occ"] & ~r["blk"] if visible_only else r["occ"]
        better = cond & (r["lp"] < best_lp)
        best_lp = torch.where(better, r["lp"], best_lp)
        sel = torch.where(better, i, sel)
    return sel


def _compose(routes, visible, occupied, params: RenderParams, use_rays: bool):
    """The per-channel composition: visible matter, then occupied (absorbed)
    matter dimmed, then background, shadowed where every route that could
    carry light is blocked (opaque mode)."""
    if not use_rays:
        return lambda s: torch.where(occupied, s, 1.0)
    bg_blocked = routes[0]["blk"]
    for r in routes[1:]:
        # a defect route shadows only where it exists (lp < _BIG)
        bg_blocked = bg_blocked & (r["blk"] | (r["lp"] >= _BIG))
    background = torch.where(bg_blocked, params.shadow, 1.0)
    return lambda s: torch.where(visible, s,
                                 torch.where(occupied, s * params.absorbed_dim, background))


def _shade(vx, vy, cr, cg, cb, r_eff, ex, ey, cam: Camera, params: RenderParams):
    """Doppler/beaming shading with the arrival direction from the emission
    point (ex, ey) at route length r_eff."""
    inv_r = 1.0 / torch.clamp(r_eff, min=1e-12)
    nx = (cam.pos[0] - ex) * inv_r
    ny = (cam.pos[1] - ey) * inv_r
    d = doppler_factor_xy(vx, vy, nx, ny) * camera_doppler_factor_xy(
        cam.vel[0], cam.vel[1], nx, ny)
    return shade_channels(cr, cg, cb, d, params)


def _route_pass_block(vdat, vok, px, py, t_now, cam: Camera, defects, retinas,
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
    for i, d in enumerate(defects):
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
    # the back route's emitter velocity is parallel-transported: rotated by
    # the pixel's theta (the winner sits within rho of it, same branch)
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


def _render_conical_impl(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                         defect, width: int, height: int, params: RenderParams,
                         planar: bool, mesh=None):
    """(image, RenderDiag); see the module docstring."""
    defects = _defect_tuple(defect)
    t_now = newest_time(buf)
    use_rays = params.opaque and params.retarded

    def l2_of(d):
        return lambda qx, qy: geodesic_lengths_xy(qx, qy, cam.pos[0], cam.pos[1], d)[1]

    # one band search per route (each route length is monotone in age, as
    # |v| < c); route 1 (None) is the Euclidean chord
    plist, band_truncated, seg_dropped = [], 0, None
    for fn in [None] + [l2_of(d) for d in defects]:
        p, trunc, segd = _band_pairs(buf, obj_index, objects, cam, t_now, width, height,
                                     params, cull_hull=False, route_lengths=fn)
        if mesh is not None:
            p, _, (trunc, segd) = _gather_pairs(mesh, p, None, (trunc, segd))
        plist.append(p)
        band_truncated = band_truncated + trunc
        if segd is not None:
            seg_dropped = segd if seg_dropped is None else seg_dropped + segd
    pairs = PairData(pdata=torch.cat([p.pdata for p in plist]),
                     pair_valid=torch.cat([p.pair_valid for p in plist]),
                     n_pairs=sum(p.n_pairs for p in plist))
    # the K + 1 routes share one pair_budget; n_pairs stays the count before
    # it, so the Engine's adaptation sees an overflow
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
                    for d in defects]
    pxs, pys = _cell_pixel_coords(width, height, cam, params)
    crgb = torch.cat([
        _route_pass_block(tables.vdat[b], tables.vok[b], pxs[b], pys[b], t_now, cam, defects,
                          retinas, params)
        for b in _cell_blocks(tables.n_img_cells, params)
    ])
    img = _assemble_image(crgb, width, height, params, planar, wc_img, hc_img)
    return img, diag


def render_retarded_conical_with_diag(buf: WorldlineBuffer, obj_index, objects: Objects,
                                      cam: Camera, defect, width: int, height: int,
                                      params: RenderParams, planar: bool = False, mesh=None):
    """(image, RenderDiag): the retarded-time image through the direct and
    every defect's back route, (H, W, 3) or (3, H, W) with `planar`.
    `defect` is a ConicalDefect or a tuple of them.  retina_dropped is None
    (each retina marches the whole compacted table); segment_dropped is
    the sum over the routes with rank compaction on, else None.  The diag
    fields are device tensors.  With `mesh`, `buf` and `obj_index` are this
    rank's share (see the module docstring)."""
    return _render_conical_impl(buf, obj_index, objects, cam, defect, width, height, params,
                                planar, mesh)


def render_retarded_conical(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                            defect, width: int, height: int, params: RenderParams,
                            planar: bool = False, mesh=None) -> torch.Tensor:
    """The image of render_retarded_conical_with_diag."""
    return _render_conical_impl(buf, obj_index, objects, cam, defect, width, height, params,
                                planar, mesh)[0]


def render_conical_brute(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                         defect, width: int, height: int,
                         params: RenderParams) -> torch.Tensor:
    """Exhaustive oracle: every pixel tests every (slot, particle) segment on
    every route (direct, and one back route per defect), with exact
    per-pixel occlusion (chart-straight rays on the direct route, each back
    route against its route-2-imaged segments).  O(pixels * T * N): tests
    on tiny scenes only.  Returns (H, W, 3)."""
    defects = _defect_tuple(defect)
    dt, rho = params.dt, params.rho
    t_now = newest_time(buf)
    cxm, cym = cam.pos[0], cam.pos[1]
    use_rays = params.opaque and params.retarded

    qax, qay, qbx, qby, ta, seg_valid = _segment_data(buf, dt)
    t_cap, n = qax.shape
    fax, fay = qax.reshape(-1), qay.reshape(-1)
    fbx, fby = qbx.reshape(-1), qby.reshape(-1)
    fta = ta.repeat_interleave(n)
    valid_f = seg_valid.repeat_interleave(n) & (torch.abs(fax) < 1e8)
    fobj = obj_index.long().repeat(t_cap)
    fvx = buf.vel_x[:t_cap].reshape(-1)
    fvy = buf.vel_y[:t_cap].reshape(-1)

    pc = pixel_centers(width, height, cam)
    px_all = pc[..., 0].reshape(-1)
    py_all = pc[..., 1].reshape(-1)
    step = max(1, _BRUTE_ELEMENTS // max(fax.shape[0], 1))

    def route_pass(px, py, t_e):
        inside, dist2 = _occupancy_xy(px[:, None], py[:, None], t_e[:, None], fax[None],
                                      fay[None], fbx[None], fby[None], fta[None], dt, rho)
        inside = inside & valid_f[None, :]
        best = torch.argmin(torch.where(inside, dist2, _BIG), dim=1)
        return torch.gather(inside, 1, best[:, None])[:, 0], best

    def first_hit(dhx, dhy, ax, ay, bx, by):
        hit, s_hit = _ray_hit_xy(cxm, cym, dhx[:, None], dhy[:, None], ax[None], ay[None],
                                 bx[None], by[None], fta[None], t_now, dt, rho)
        return torch.where(hit & valid_f[None, :], s_hit, _BIG).amin(dim=1)

    # route-2 images of every segment (midpoint rotation sign), per defect
    images = []
    for dfc in defects:
        th_s = _route2_theta(0.5 * (fax + fbx), 0.5 * (fay + fby), cam, dfc)
        images.append(_rotate_about(fax, fay, th_s, dfc) + _rotate_about(fbx, fby, th_s, dfc))

    def pixel_chunk(px, py):
        ex1, ey1 = px - cxm, py - cym
        lp1 = torch.sqrt(ex1 * ex1 + ey1 * ey1)
        occ1, best1 = route_pass(px, py, t_now - lp1)
        if use_rays:
            inv1 = 1.0 / torch.clamp(lp1, min=1e-12)
            blk1 = first_hit((px - cxm) * inv1, (py - cym) * inv1,
                             fax, fay, fbx, fby) < (lp1 - 2.0 * rho)
        else:
            blk1 = torch.zeros_like(occ1)
        routes = [dict(lp=lp1, occ=occ1, best=best1, blk=blk1, ex=px, ey=py,
                       theta=torch.zeros_like(px))]
        for dfc, (rax, ray_, rbx, rby) in zip(defects, images):
            _l1, lp2, v2 = geodesic_lengths_xy(px, py, cxm, cym, dfc)
            theta_p = _route2_theta(px, py, cam, dfc)
            rpx, rpy = _rotate_about(px, py, theta_p, dfc)
            occ2, best2 = route_pass(px, py, t_now - lp2)
            occ2 = occ2 & v2
            if use_rays:
                gx, gy = rpx - cxm, rpy - cym
                inv2 = 1.0 / torch.clamp(torch.sqrt(gx * gx + gy * gy), min=1e-12)
                blk2 = first_hit((rpx - cxm) * inv2, (rpy - cym) * inv2,
                                 rax, ray_, rbx, rby) < (lp2 - 2.0 * rho)
            else:
                blk2 = torch.zeros_like(occ2)
            routes.append(dict(lp=lp2, occ=occ2, best=best2, blk=blk2, ex=rpx, ey=rpy,
                               theta=theta_p))

        vis_idx = _winning_route(routes, True, px)
        occ_idx = _winning_route(routes, False, px)
        visible = vis_idx >= 0
        occupied = occ_idx >= 0
        route_idx = torch.where(visible, vis_idx, occ_idx)
        best = routes[0]["best"]
        r_eff, ex, ey, theta_p = (routes[0][k] for k in ("lp", "ex", "ey", "theta"))
        for i, r in enumerate(routes[1:], start=1):
            m = route_idx == i
            best = torch.where(m, r["best"], best)
            r_eff = torch.where(m, r["lp"], r_eff)
            ex = torch.where(m, r["ex"], ex)
            ey = torch.where(m, r["ey"], ey)
            theta_p = torch.where(m, r["theta"], theta_p)
        obj = fobj[best]
        cr, cg, cb = (objects.base_color[:, c][obj] for c in range(3))
        wvx, wvy = fvx[best], fvy[best]
        ct, st = torch.cos(theta_p), torch.sin(theta_p)
        vx = ct * wvx - st * wvy  # theta = 0 on the direct route
        vy = st * wvx + ct * wvy
        sr, sg, sb = _shade(vx, vy, cr, cg, cb, r_eff, ex, ey, cam, params)
        comp = _compose(routes, visible, occupied, params, use_rays)
        return torch.stack([comp(sr), comp(sg), comp(sb)], dim=-1)

    img = torch.cat([pixel_chunk(px_all[a:a + step], py_all[a:a + step])
                     for a in range(0, px_all.shape[0], step)])
    return img.reshape(height, width, 3)
