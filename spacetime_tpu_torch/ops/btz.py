"""BTZ black hole (2+1 AdS): retarded-time rendering along closed-form null
geodesics.

Counterpart of `spacetime_tpu/ops/btz.py`.  The non-rotating BTZ metric

    ds^2 = -f(r) dt^2 + dr^2 / f(r) + r^2 dphi^2,   f(r) = r^2 / l^2 - M,

has its horizon at r_h = l sqrt(M), and every quantity a retarded render
needs is closed form:

  * orbits: with u = 1/r a null orbit solves u'' = M u, so u(phi) =
    A e^{mu phi} + B e^{-mu phi} (mu = sqrt(M)); the boundary problem (u at
    the camera, phi = 0, and at the emitter, phi = dphi) is a 2x2 solve;
  * travel time and the slow-rotation drag integral int dphi / f: rational
    integrands in w = e^{2 mu phi}, whose antiderivatives are logarithms
    (`_null_delay_u`, `_drag_integral_u`), with their own closed forms for
    near-radial paths (dphi < 3e-3) and +BIG (delay) / 0 (drag) where an
    endpoint lies inside the horizon;
  * routes: `route` encodes base = route % 4 and winding = route // 4.
    Bases 0 / 1 span the minor angle |dphi| and 2 pi - |dphi| around the
    back; bases 2 / 3 are the same two separations reflected once off the
    AdS boundary (the emitter endpoint negated in u); winding k adds 2 pi k.
    `params.btz_reflections` adds bases 2 and 3, `params.btz_windings` the
    windings 1..k of every base;
  * spin: a rotating hole (`BTZBlackHole.spin` = J) adds the first-order
    drag s (J / 2) int dphi / f along the travel sense s; with
    `params.btz_exact_spin` the full rotating metric is solved instead
    (ops/btz_exact.py).

A frame (`render_btz_with_diag`):
  1. one band search per route (`raytrace._band_pairs` with the route's
     delay as its cone metric and no view-hull cull: curved routes pass
     off-screen).  Every route has its own metric, so each takes the plain
     sweep (ops/band_cuda.py), on the card too, as in the JAX package;
  2. the routes' pairs concatenated and compacted to one `pair_budget`
     (`n_pairs` stays the count before it, so the Engine's adaptation sees
     an overflow);
  3. the dense view tables (`raytrace._build_view_tables`);
  4. in opaque mode the bearing retina (`_btz_retina`): every pair whose
     event is cone-consistent with a route puts its delay into the
     arrival-bearing bins its angular footprint covers, a dense chunked
     (rays x pairs) masked minimum;
  5. each route's optics (bearing, delay, emitter-side direction) for every
     pixel at once (elementwise, the values the JAX package computes per
     block), then the route pass over blocks of view cells: per pixel and
     route the occupancy against its cell's table, the earliest visible
     arrival winning (the lower route index on ties; else the earliest
     occupied one, dimmed), Doppler with the emitter-side and camera-side
     ray directions, the gravitational redshift sqrt(f(r_e) / f(r_c)), and
     the horizon disc black.
Everything is plain torch on every device: the JAX package runs it as XLA,
with no Pallas kernel.  `RenderDiag.segment_dropped` is the sum over the
routes (the JAX package drops it).  `render_btz_brute` is the exhaustive
oracle of tests.  On a mesh (`mesh`, parallel/) step 1 runs on this rank's
ring columns and each route's pairs are all-gathered with its counters
all-reduced (`raytrace._gather_pairs`); steps 2-5 run replicated.

Modelling limits, as the JAX package documents them: the physics runs in
the flat chart (keep bodies at r >> r_h); images use coordinate time; the
slow-rotation model keeps the orbit shape of J = 0 (exact to O(J^2)).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..camera import Camera, pixel_centers
from ..state import Objects
from .raytrace import (
    _BIG, _F_AX, _F_AY, _F_BX, _F_BY, _F_CB, _F_CG, _F_CR, _F_TA, _F_VX, _F_VY, _PI,
    PairData, RenderDiag, RenderParams, _assemble_image, _band_pairs, _build_view_tables,
    _gather_pairs,
    _cell_blocks, _cell_pixel_coords, _compact_pairs_to_budget, _field_at, _occupancy_cells,
    _occupancy_xy, _ray_angles, _segment_data, camera_doppler_factor_xy, doppler_factor_xy,
    floored_mod, shade_channels,
)
from .worldline import WorldlineBuffer, newest_time

_EPS = 1e-12
_TWO_PI = 2.0 * math.pi
_TWO_PI32 = float(2 * _PI)  # the f32 2 pi of the retina's bin index
# the oracle tests pixels against every (slot, particle) segment in chunks
# of pixels holding at most this many (pixel, segment) elements
_BRUTE_ELEMENTS = 1 << 20


@dataclasses.dataclass(frozen=True)
class BTZBlackHole:
    center: torch.Tensor  # (2,) f32: the hole's chart position
    mass: torch.Tensor  # () f32: M > 0 (horizon r_h = l sqrt(M))
    ads_l: torch.Tensor  # () f32: the AdS curvature radius l
    # () f32: angular momentum J.  The slow-rotation model adds the
    # first-order drag to the delays and keeps the orbit shape of J = 0
    # (exact to O(J^2)); valid for |J| << M l (extremal at |J| = M l)
    spin: torch.Tensor

    @staticmethod
    def create(center=(0.5, 0.5), mass=0.01, ads_l=4.0, spin=0.0,
               device="cpu") -> "BTZBlackHole":
        """A hole from host values, as f32 tensors on `device` (fills, not
        host copies, for the scalars: a CUDA graph may capture them)."""
        c = torch.tensor(center, dtype=torch.float32, device=device)
        scalar = lambda v: torch.full((), v, dtype=torch.float32, device=c.device)
        return BTZBlackHole(center=c, mass=scalar(mass), ads_l=scalar(ads_l),
                            spin=scalar(spin))

    @property
    def device(self) -> torch.device:
        return self.center.device

    @property
    def r_h(self) -> torch.Tensor:
        return self.ads_l * torch.sqrt(self.mass)


def _inv(r):
    return 1.0 / torch.clamp(r, min=_EPS)


def btz_null_delay(ra, rb, dphi, mass, ads_l):
    """Coordinate-time delay of the null geodesic from (ra, 0) to
    (rb, dphi), dphi > 0; +BIG where an endpoint is inside the horizon."""
    return _null_delay_u(_inv(ra), _inv(rb), dphi, mass, ads_l)


def btz_null_delay_reflected(ra, rb, dphi, mass, ads_l):
    """The delay of the geodesic reflected once off the AdS boundary: the
    continued orbit with the far endpoint negated in u."""
    return _null_delay_u(_inv(ra), -_inv(rb), dphi, mass, ads_l)


def _orbit_coefficients(ua, ub, dphi, mass, ads_l):
    """(mu, e^{mu dphi}, A, B, a2, a1, a0, sq, W) of the orbit u = A e^{mu
    phi} + B e^{-mu phi} through ua at 0 and ub at dphi, the quadratic
    D(w) = -a2 w^2 + a1 w - a0 whose roots are the horizon touchpoints, sq
    the root of its discriminant and W = e^{2 mu dphi}."""
    M, l = mass, ads_l
    mu = torch.sqrt(M)
    e_half = torch.exp(mu * dphi)
    denom = e_half - 1.0 / e_half
    A = (ub - ua / e_half) / torch.clamp(denom, min=_EPS)
    B = ua - A
    Ml2 = M * l * l
    a2 = Ml2 * A * A
    a1 = 1.0 - 2.0 * A * B * Ml2
    a0 = Ml2 * B * B
    sq = torch.sqrt(torch.clamp(a1 * a1 - 4.0 * a2 * a0, min=_EPS))
    return mu, e_half, A, B, a2, a1, a0, sq, e_half * e_half


def _null_delay_u(ua, ub, dphi, mass, ads_l):
    """Signed-u core of btz_null_delay: ub < 0 is the orbit reflected once
    off the AdS boundary (u'' = M u is linear and odd, every integrand even
    in u).  Inputs broadcast; +BIG where an endpoint is inside the
    horizon."""
    M, l = mass, ads_l
    mu, _e, _A, B, a2, a1, _a0, sq, W = _orbit_coefficients(ua, ub, dphi, M, l)
    Ml2 = M * l * l
    # general roots; a2 ~ 0 (a purely decaying orbit) takes the degenerate
    # closed form t = l/(2 mu) ln((W - Ml2 B^2) / (1 - Ml2 B^2))
    safe_a2 = torch.clamp(a2, min=_EPS)
    w_plus = (a1 + sq) / (2.0 * safe_a2)
    w_minus = (a1 - sq) / (2.0 * safe_a2)

    def g(w):
        return torch.log(torch.abs(w - w_minus) / torch.clamp(torch.abs(w - w_plus), min=_EPS))

    t_gen = (l / (2.0 * mu)) * (g(W) - g(1.0))
    t_deg = (l / (2.0 * mu)) * torch.log(
        torch.abs(W - Ml2 * B * B) / torch.clamp(torch.abs(1.0 - Ml2 * B * B), min=_EPS))
    t = torch.where(a2 < 1e-9, t_deg, t_gen)

    r_h = l * mu
    ra = _inv(ua)
    rb = _inv(torch.abs(ub))
    # near-radial paths: the boundary solve cancels as dphi -> 0; the radial
    # null path t = int dr / f has its own closed form
    t_rad = (l / (2.0 * mu)) * torch.abs(torch.log(
        torch.clamp((rb - r_h) * (ra + r_h), min=_EPS)
        / torch.clamp((rb + r_h) * (ra - r_h), min=_EPS)))
    # reflected radial limit: out to the boundary and back, two legs of
    # int_r^inf dr / f = (l / 2 mu) ln((r + rh) / (r - rh))
    leg = lambda r: torch.log(torch.clamp(r + r_h, min=_EPS) / torch.clamp(r - r_h, min=_EPS))
    t_rad_reflect = (l / (2.0 * mu)) * (leg(ra) + leg(rb))
    t_rad = torch.where(ub < 0, t_rad_reflect, t_rad)
    t = torch.where(dphi < 3e-3, t_rad, t)
    inside = (ra <= r_h) | (rb <= r_h)
    return torch.where(inside, _BIG, torch.abs(t))


def btz_drag_integral(ra, rb, dphi, mass, ads_l):
    """int_0^dphi dphi' / f(r(phi')) >= 0 along btz_null_delay's orbit: the
    frame-dragging kernel (the delay at spin J is t(0) + s (J / 2) times
    this, s the travel sense)."""
    return _drag_integral_u(_inv(ra), _inv(rb), dphi, mass, ads_l)


def btz_drag_integral_reflected(ra, rb, dphi, mass, ads_l):
    """btz_drag_integral along the orbit reflected once off the AdS
    boundary."""
    return _drag_integral_u(_inv(ra), -_inv(rb), dphi, mass, ads_l)


def _drag_integral_u(ua, ub, dphi, mass, ads_l):
    """Signed-u core of btz_drag_integral (ub < 0: one AdS-boundary
    reflection).  With w = e^{2 mu phi}, int dphi / f = (1 / (2 mu M))
    int_1^W (1/D - 1/w) dw, D sharing the delay's roots."""
    M, l = mass, ads_l
    mu, _e, _A, _B, a2, a1, a0, sq, W = _orbit_coefficients(ua, ub, dphi, M, l)
    safe_a2 = torch.clamp(a2, min=_EPS)
    w_plus = (a1 + sq) / (2.0 * safe_a2)
    # the product-of-roots form: no a1 - sq cancellation (f32-critical)
    w_minus = 2.0 * a0 / torch.clamp(a1 + sq, min=_EPS)

    def logratio(wr):
        # ln |(W - wr) / (1 - wr)| with clamped operands
        return torch.log(torch.clamp(torch.abs(W - wr), min=_EPS)
                         / torch.clamp(torch.abs(1.0 - wr), min=_EPS))

    core_gen = -(1.0 / sq) * (logratio(w_plus) - logratio(w_minus))
    # degenerate A ~ 0: D(w) = a1 w - a0, int_1^W dw / D = (1/a1) ln|..|
    safe_a1 = torch.where(torch.abs(a1) < _EPS, 1.0, a1)
    core_deg = (1.0 / safe_a1) * torch.log(
        torch.clamp(torch.abs(safe_a1 * W - a0), min=_EPS)
        / torch.clamp(torch.abs(safe_a1 - a0), min=_EPS))
    core = torch.where(a2 < 1e-9, core_deg, core_gen)
    # ln W = 2 mu dphi exactly (not log(W), for f32 accuracy)
    out = core / (2.0 * mu * M) - dphi / M

    # near-radial: the trapezoid of the endpoints (exact as dphi -> 0)
    ra = _inv(ua)
    rb = _inv(torch.abs(ub))
    fa = torch.clamp(ra * ra / (l * l) - M, min=_EPS)
    fb = torch.clamp(rb * rb / (l * l) - M, min=_EPS)
    i_rad = dphi * 0.5 * (1.0 / fa + 1.0 / fb)
    # reflected radial limit: the u-average of 1/f over both legs,
    # g(u) = (artanh(k u) / k - u) / M, k = l sqrt(M)
    k = l * mu
    g_of = lambda u: (torch.atanh(torch.clamp(k * u, 0.0, 1.0 - 1e-6)) / k - u) / M
    ub_a = torch.abs(ub)
    i_rad_reflect = dphi * (g_of(ua) + g_of(ub_a)) / torch.clamp(ua + ub_a, min=_EPS)
    i_rad = torch.where(ub < 0, i_rad_reflect, i_rad)
    out = torch.where(dphi < 3e-3, i_rad, out)
    r_h = l * mu
    inside = (ra <= r_h) | (rb <= r_h)
    return torch.where(inside, 0.0, torch.clamp(out, min=0.0))


def _spin_delay(base, ra, rb, dphi, s, hole: BTZBlackHole):
    """A route's delay with the slow-rotation drag: t(J) = t(0) + s (J/2) I,
    `s` the camera -> emitter sweep sense (co-rotating light arrives
    earlier)."""
    drag = hole.spin * 0.5 * s * btz_drag_integral(ra, rb, dphi, hole.mass, hole.ads_l)
    return torch.where(base >= _BIG, base, torch.clamp(base + drag, min=0.0))


def _spin_delay_u(base, ua, ub, dphi, s, hole: BTZBlackHole):
    """_spin_delay in signed-u space (ub < 0: the AdS-boundary reflection)."""
    drag = hole.spin * 0.5 * s * _drag_integral_u(ua, ub, dphi, hole.mass, hole.ads_l)
    return torch.where(base >= _BIG, base, torch.clamp(base + drag, min=0.0))


def _polar_separation(qx, qy, cx, cy, hole: BTZBlackHole):
    """(rq, rc, d_phi): the radii of q and c about the hole and their
    angular separation in [0, pi]."""
    hx, hy = hole.center[0], hole.center[1]
    rqx, rqy = qx - hx, qy - hy
    rcx, rcy = cx - hx, cy - hy
    rq = torch.sqrt(rqx * rqx + rqy * rqy)
    rc = torch.sqrt(rcx * rcx + rcy * rcy)
    cos_d = torch.clamp((rqx * rcx + rqy * rcy) / torch.clamp(rq * rc, min=_EPS), -1.0, 1.0)
    return rq, rc, torch.acos(cos_d)


def _orbit_setup(qx, qy, cx, cy, hole: BTZBlackHole, route: int) -> dict:
    """The orbit boundary problem of one route (camera at phi = 0, emitter q
    at phi = dphi): the polar decomposition about the hole, the route's
    separation dphi and travel sense s (+1 / -1), and the coefficients A,
    B of u(phi) = A e^{mu phi} + B e^{-mu phi}.  Route encoding (module
    docstring): base = route % 4 (odd: around the back; >= 2: the emitter
    negated in u, one AdS-boundary reflection), winding = route // 4 adds
    2 pi per winding.  Every consumer (bearing, emitter direction, orbit
    sampling, the oracle) derives from this one function."""
    hx, hy = hole.center[0], hole.center[1]
    mu = torch.sqrt(hole.mass)
    rqx, rqy = qx - hx, qy - hy
    rcx, rcy = cx - hx, cy - hy
    rq = torch.sqrt(rqx * rqx + rqy * rqy)
    rc = torch.sqrt(rcx * rcx + rcy * rcy)
    phi_c = torch.atan2(rcy, rcx)
    phi_q = torch.atan2(rqy, rqx)
    delta = floored_mod(phi_q - phi_c + math.pi, _TWO_PI) - math.pi  # [-pi, pi)
    sgn = torch.where(delta >= 0, 1.0, -1.0)
    base, winding = route % 4, route // 4
    if base % 2 == 0:
        dphi = torch.clamp(torch.abs(delta), min=1e-4)
        s = sgn
    else:
        dphi = _TWO_PI - torch.abs(delta)
        s = -sgn
    dphi = dphi + _TWO_PI * winding
    u_c = _inv(rc)
    u_q = _inv(rq)
    u_q_bvp = -u_q if base >= 2 else u_q
    e = torch.exp(mu * dphi)
    A = (u_q_bvp - u_c / e) / torch.clamp(e - 1.0 / e, min=_EPS)
    B = u_c - A
    return dict(mu=mu, rq=rq, rc=rc, phi_c=phi_c, dphi=dphi, s=s, u_c=u_c, u_q=u_q,
                u_q_bvp=u_q_bvp, A=A, B=B)


def _tangent_at(ob: dict, phi, sigma: float = 1.0):
    """Chart tangent of the orbit at sweep angle phi (per unit phi, in the
    travel sense s): (dr/dphi) r_hat + r phi_hat.  `sigma` -1 takes the
    physical branch past the AdS-boundary bounce of a reflected orbit."""
    mu, s = ob["mu"], ob["s"]
    ep, em = torch.exp(mu * phi), torch.exp(-mu * phi)
    u = sigma * (ob["A"] * ep + ob["B"] * em)
    du = sigma * (mu * (ob["A"] * ep - ob["B"] * em))
    r = _inv(u)
    dr_dphi = -du / torch.clamp(u * u, min=_EPS)
    ang = ob["phi_c"] + s * phi
    rhx, rhy = torch.cos(ang), torch.sin(ang)
    thx, thy = -rhy * s, rhx * s
    return dr_dphi * rhx + r * thx, dr_dphi * rhy + r * thy


def route_optics_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """(camera bearing, delay, emitter-side propagation direction x, y) of
    one route: the bearing (atan2 convention) at the camera of the
    geodesic toward q, its delay with the slow-rotation drag, and the unit
    direction of the photon at q along its travel toward the camera."""
    ob = _orbit_setup(qx, qy, cx, cy, hole, route)
    vx, vy = _tangent_at(ob, torch.zeros_like(ob["dphi"]))
    bearing = torch.atan2(vy, vx)
    delay = _null_delay_u(ob["u_c"], ob["u_q_bvp"], ob["dphi"], hole.mass, hole.ads_l)
    delay = _spin_delay_u(delay, ob["u_c"], ob["u_q_bvp"], ob["dphi"], ob["s"], hole)
    # a reflected route's emitter side lies on the -u branch
    tx, ty = _tangent_at(ob, ob["dphi"], sigma=-1.0 if (route % 4) >= 2 else 1.0)
    inv = torch.rsqrt(torch.clamp(tx * tx + ty * ty, min=_EPS))
    return bearing, delay, -tx * inv, -ty * inv


def arrival_bearing_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """(camera bearing, delay) of route_optics_xy."""
    bearing, delay, _, _ = route_optics_xy(qx, qy, cx, cy, hole, route)
    return bearing, delay


def emitter_direction_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """The emitter-side propagation direction of route_optics_xy."""
    _, _, nex, ney = route_optics_xy(qx, qy, cx, cy, hole, route)
    return nex, ney


def sample_orbit(qx, qy, cx, cy, hole: BTZBlackHole, route: int, n: int):
    """(xs, ys, delays): n chart points along the route's geodesic from the
    camera to q (scalar q and c), with the delay from the camera to each."""
    hx, hy = hole.center[0], hole.center[1]
    ob = _orbit_setup(qx, qy, cx, cy, hole, route)
    mu = ob["mu"]
    frac = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=hole.device)
    phis = ob["dphi"] * frac
    # the signed continued orbit; |u| is the physical inverse radius
    u = ob["A"] * torch.exp(mu * phis) + ob["B"] * torch.exp(-mu * phis)
    r = _inv(torch.abs(u))
    ang = ob["phi_c"] + ob["s"] * phis
    xs = hx + r * torch.cos(ang)
    ys = hy + r * torch.sin(ang)
    part = torch.clamp(phis, min=1e-5)
    delays = _null_delay_u(ob["u_c"], u, part, hole.mass, hole.ads_l)
    delays = _spin_delay_u(delays, ob["u_c"], u, part, ob["s"], hole)
    return xs, ys, delays


def _travel_sense(qx, qy, cx, cy, hole: BTZBlackHole):
    """The sign of the wrapped angle phi_q - phi_c (route 0's sweep sense),
    from the cross product."""
    hx, hy = hole.center[0], hole.center[1]
    cross = (cx - hx) * (qy - hy) - (cy - hy) * (qx - hx)
    return torch.where(cross >= 0, 1.0, -1.0)


def route_delay_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """One route's delay between chart point q and the camera c (the band
    search's cone metric: one closed-form evaluation per probe)."""
    rq, rc, d_phi = _polar_separation(qx, qy, cx, cy, hole)
    b, winding = route % 4, route // 4
    sep = torch.clamp(d_phi, min=1e-6) if b % 2 == 0 else _TWO_PI - d_phi
    sep = sep + _TWO_PI * winding
    s = _travel_sense(qx, qy, cx, cy, hole)
    if b % 2:
        s = -s
    uc, uq = _inv(rc), _inv(rq)
    ub = -uq if b >= 2 else uq
    base = _null_delay_u(uc, ub, sep, hole.mass, hole.ads_l)
    return _spin_delay_u(base, uc, ub, sep, s, hole)


def route_delays_xy(qx, qy, cx, cy, hole: BTZBlackHole):
    """The delays of routes 0 and 1 (|dphi| and 2 pi - |dphi|)."""
    rq, rc, d_phi = _polar_separation(qx, qy, cx, cy, hole)
    s = _travel_sense(qx, qy, cx, cy, hole)
    d1 = torch.clamp(d_phi, min=1e-6)
    d2 = _TWO_PI - d_phi
    t1 = _spin_delay(btz_null_delay(rq, rc, d1, hole.mass, hole.ads_l), rq, rc, d1, s, hole)
    t2 = _spin_delay(btz_null_delay(rq, rc, d2, hole.mass, hole.ads_l), rq, rc, d2, -s, hole)
    return t1, t2


def _select_optics(params: RenderParams):
    """(route optics, route delay): the slow-rotation closed forms, or with
    params.btz_exact_spin the full rotating-metric solve (ops/btz_exact.py,
    its fallback mask dropped)."""
    if not params.btz_exact_spin:
        return route_optics_xy, route_delay_xy
    from . import btz_exact

    def optics(qx, qy, cx, cy, hole, route):
        b, d, nx, ny, _fb = btz_exact.exact_route_optics_xy(qx, qy, cx, cy, hole, route)
        return b, d, nx, ny

    return optics, btz_exact.exact_route_delay_xy


def route_ids(params: RenderParams):
    """The routes a frame renders: bases (0, 1), plus (2, 3) with
    btz_reflections, at every winding 0..btz_windings."""
    bases = (0, 1, 2, 3) if params.btz_reflections else (0, 1)
    return tuple(4 * k + b for k in range(params.btz_windings + 1) for b in bases)


def _btz_retina(pairs: PairData, cam: Camera, t_now, hole: BTZBlackHole, dt, rho, n_rays: int,
                ray_chunk: int = 8192, routes=(0, 1), optics=None):
    """The occlusion retina over arrival bearing at the camera: every pair
    whose event is cone-consistent with a route (emitted one route delay
    before t_now, within a tick and the capsule's slack) puts that delay
    into every bearing bin its angular footprint covers; (n_rays,) minima.
    A dense chunked (rays x pairs) masked minimum, as the JAX package's."""
    pd = pairs.pdata
    cxm, cym = cam.pos[0], cam.pos[1]
    optics = optics or route_optics_xy
    ex = 0.5 * (pd[:, _F_AX] + pd[:, _F_BX])
    ey = 0.5 * (pd[:, _F_AY] + pd[:, _F_BY])
    t_mid = pd[:, _F_TA] + 0.5 * dt
    sx, sy = pd[:, _F_BX] - pd[:, _F_AX], pd[:, _F_BY] - pd[:, _F_AY]
    half_sweep = 0.5 * torch.sqrt(sx * sx + sy * sy)
    chart_d = torch.sqrt((ex - cxm) ** 2 + (ey - cym) ** 2)
    # the angular footprint, to first order
    w_ang = (rho + half_sweep) / torch.clamp(chart_d, min=1e-6)
    betas = _ray_angles(n_rays, pd.device)[:, None]
    retina = torch.full((n_rays,), _BIG, dtype=torch.float32, device=pd.device)
    chunk = max(ray_chunk, 128)
    for route in routes:
        beta, delay, _, _ = optics(ex, ey, cxm, cym, hole, route)
        slack = 1.5 * dt + (rho + half_sweep) * delay / torch.clamp(chart_d, min=1e-6)
        ok = pairs.pair_valid & (delay < _BIG) & (torch.abs((t_now - delay) - t_mid) <= slack)
        d = torch.where(ok, delay, _BIG)
        for a in range(0, beta.shape[0], chunk):
            b = beta[None, a:a + chunk]
            d_ang = torch.abs(floored_mod(betas - b + float(_PI), _TWO_PI32) - float(_PI))
            val = torch.where(d_ang <= w_ang[None, a:a + chunk], d[None, a:a + chunk], _BIG)
            retina = torch.minimum(retina, val.amin(dim=1))
    return retina


def _retina_index(beta, n_rays: int):
    """The retina bin of bearing `beta`."""
    ri = torch.floor((beta + float(_PI)) / _TWO_PI32 * n_rays)
    return ri.clamp(0, n_rays - 1).long()


def _earliest(routes, key: str, like):
    """Per pixel, the index of the route of least delay among those where
    `key` holds (the lower index on ties), 0 where none does."""
    best_td = torch.full_like(like, _BIG)
    best_i = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
    for i, ro in enumerate(routes):
        v = torch.where(ro[key], ro["td"], _BIG)
        take = v < best_td
        best_td = torch.where(take, v, best_td)
        best_i = torch.where(take, i, best_i)
    return best_i


def _shade_winner(routes, idx, vx, vy, cr, cg, cb, px, py, cam: Camera, hole: BTZBlackHole,
                  params: RenderParams):
    """Doppler and beaming of the winning route's candidate: the emitter
    term with the route's emitter-side direction, the camera term with its
    camera-side one (-bearing), times the gravitational redshift
    sqrt(f(r_emit) / f(r_cam)) between static frames."""
    beta_w, nex, ney = routes[0]["beta"], routes[0]["nex"], routes[0]["ney"]
    for i, ro in enumerate(routes[1:], start=1):
        pick = idx == i
        beta_w = torch.where(pick, ro["beta"], beta_w)
        nex = torch.where(pick, ro["nex"], nex)
        ney = torch.where(pick, ro["ney"], ney)
    nx, ny = -torch.cos(beta_w), -torch.sin(beta_w)
    d = doppler_factor_xy(vx, vy, nex, ney) * camera_doppler_factor_xy(
        cam.vel[0], cam.vel[1], nx, ny)
    hx, hy = hole.center[0], hole.center[1]
    cxm, cym = cam.pos[0], cam.pos[1]
    r_e = torch.sqrt((px - hx) ** 2 + (py - hy) ** 2)
    r_c = torch.sqrt((cxm - hx) ** 2 + (cym - hy) ** 2)
    f_of = lambda r: torch.clamp(r * r / (hole.ads_l ** 2) - hole.mass, min=0.0)
    d = d * torch.sqrt(f_of(r_e) / torch.clamp(f_of(r_c), min=1e-6))
    return shade_channels(cr, cg, cb, d, params)


def _compose(routes, visible, occupied, in_hole, params: RenderParams, use_rays: bool):
    """The per-channel composition: the horizon black, then visible matter,
    occupied (absorbed) matter dimmed, and the background, shadowed where
    every route that exists is blocked (opaque mode)."""
    if not use_rays:
        return lambda s: torch.where(in_hole, 0.0, torch.where(occupied, s, 1.0))
    all_blocked = routes[0]["blk"] | (routes[0]["td"] >= _BIG)
    any_route = routes[0]["td"] < _BIG
    for ro in routes[1:]:
        all_blocked = all_blocked & (ro["blk"] | (ro["td"] >= _BIG))
        any_route = any_route | (ro["td"] < _BIG)
    background = torch.where(all_blocked & any_route, params.shadow, 1.0)
    return lambda s: torch.where(
        in_hole, 0.0,
        torch.where(visible, s, torch.where(occupied, s * params.absorbed_dim, background)))


def _route_pass_block(vdat, vok, px, py, optics, t_now, cam: Camera, hole: BTZBlackHole,
                      retina, params: RenderParams):
    """The route pass over one block of view cells; `optics` holds each
    route's (bearing, delay, emitter direction x, y) at these pixels.
    Returns (C, 3, k2) colours."""
    dt, rho = params.dt, params.rho
    cxm, cym = cam.pos[0], cam.pos[1]
    use_rays = retina is not None
    chart_d = torch.clamp(torch.sqrt((px - cxm) ** 2 + (py - cym) ** 2), min=1e-6)
    routes = []
    for beta, td, nex, ney in optics:
        occ, win = _occupancy_cells(px, py, t_now - td, vdat, vok, dt, rho)
        occ = occ & (td < _BIG)
        if use_rays:
            margin = 2.0 * rho * td / chart_d  # the capsule's slack in delay units
            blk = retina[_retina_index(beta, params.num_rays)] < (td - margin)
        else:
            blk = torch.zeros_like(occ)
        routes.append(dict(td=td, occ=occ, win=win, blk=blk, sel=occ & ~blk, beta=beta,
                           nex=nex, ney=ney))
    visible, occupied = routes[0]["sel"], routes[0]["occ"]
    for ro in routes[1:]:
        visible = visible | ro["sel"]
        occupied = occupied | ro["occ"]
    like = routes[0]["td"]
    idx = torch.where(visible, _earliest(routes, "sel", like), _earliest(routes, "occ", like))
    winner = routes[0]["win"]
    for i, ro in enumerate(routes[1:], start=1):
        winner = torch.where(idx == i, ro["win"], winner)
    vx, vy = _field_at(vdat, winner, _F_VX), _field_at(vdat, winner, _F_VY)
    cr, cg, cb = (_field_at(vdat, winner, f) for f in (_F_CR, _F_CG, _F_CB))
    sr, sg, sb = _shade_winner(routes, idx, vx, vy, cr, cg, cb, px, py, cam, hole, params)
    hx, hy = hole.center[0], hole.center[1]
    in_hole = ((px - hx) ** 2 + (py - hy) ** 2) < hole.r_h ** 2
    comp = _compose(routes, visible, occupied, in_hole, params, use_rays)
    return torch.stack([comp(sr), comp(sg), comp(sb)], dim=1)


def _route_pairs(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera, t_now,
                 width: int, height: int, params: RenderParams, hole: BTZBlackHole, route: int,
                 delay_fn):
    """One route's band search and pair rows (`raytrace._band_pairs` with the
    route's delay as the cone metric, no view-hull cull)."""
    fn = lambda qx, qy: delay_fn(qx, qy, cam.pos[0], cam.pos[1], hole, route)
    return _band_pairs(buf, obj_index, objects, cam, t_now, width, height, params,
                       cull_hull=False, route_lengths=fn)


def _pixel_optics(pxs, pys, cam: Camera, hole: BTZBlackHole, routes, optics_fn):
    """Each route's (bearing, delay, emitter direction x, y) at every pixel
    at once (elementwise: the values the JAX package computes per block)."""
    return [optics_fn(pxs, pys, cam.pos[0], cam.pos[1], hole, r) for r in routes]


def _render_btz_impl(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                     hole: BTZBlackHole, width: int, height: int, params: RenderParams,
                     planar: bool, mesh=None):
    """(image, RenderDiag); see the module docstring."""
    t_now = newest_time(buf)
    use_rays = params.opaque and params.retarded
    routes = route_ids(params)
    optics_fn, delay_fn = _select_optics(params)

    plist, band_truncated, seg_dropped = [], 0, None
    for r in routes:
        p, trunc, segd = _route_pairs(buf, obj_index, objects, cam, t_now, width, height,
                                      params, hole, r, delay_fn)
        if mesh is not None:
            p, _, (trunc, segd) = _gather_pairs(mesh, p, None, (trunc, segd))
        plist.append(p)
        band_truncated = band_truncated + trunc
        if segd is not None:
            seg_dropped = segd if seg_dropped is None else seg_dropped + segd
    pairs = PairData(pdata=torch.cat([p.pdata for p in plist]),
                     pair_valid=torch.cat([p.pair_valid for p in plist]),
                     n_pairs=sum(p.n_pairs for p in plist))
    # the routes share one pair_budget; n_pairs stays the count before it
    pairs = _compact_pairs_to_budget(pairs, params.pair_budget)
    tables, bin_dropped, entry_dropped, cell_too_small, geom = _build_view_tables(
        pairs, cam, width, height, params)
    wc_img, hc_img = geom[0], geom[1]
    diag = RenderDiag(pairs_used=pairs.n_pairs, band_truncated=band_truncated,
                      bin_dropped=bin_dropped, cell_too_small=cell_too_small,
                      retina_dropped=None, entry_dropped=entry_dropped,
                      segment_dropped=seg_dropped)

    retina = None
    if use_rays:
        retina = _btz_retina(pairs, cam, t_now, hole, params.dt, params.rho, params.num_rays,
                             ray_chunk=params.ray_chunk, routes=routes, optics=optics_fn)
    pxs, pys = _cell_pixel_coords(width, height, cam, params)
    optics = _pixel_optics(pxs, pys, cam, hole, routes, optics_fn)
    crgb = torch.cat([
        _route_pass_block(tables.vdat[b], tables.vok[b], pxs[b], pys[b],
                          [tuple(o[b] for o in opt) for opt in optics], t_now, cam, hole,
                          retina, params)
        for b in _cell_blocks(tables.n_img_cells, params)
    ])
    img = _assemble_image(crgb, width, height, params, planar, wc_img, hc_img)
    return img, diag


def render_btz_with_diag(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                         hole: BTZBlackHole, width: int, height: int, params: RenderParams,
                         planar: bool = False, mesh=None):
    """(image, RenderDiag): the retarded-time image around the hole, (H, W,
    3) or (3, H, W) with `planar`.  retina_dropped is None (the retina
    marches the whole compacted table); segment_dropped is the sum over the
    routes with rank compaction on, else None.  The diag fields are device
    tensors.  With `mesh`, `buf` and `obj_index` are this rank's share (see
    the module docstring)."""
    return _render_btz_impl(buf, obj_index, objects, cam, hole, width, height, params, planar,
                            mesh)


def render_btz_xray(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                    hole: BTZBlackHole, width: int, height: int, params: RenderParams,
                    planar: bool = False) -> torch.Tensor:
    """The image of render_btz_with_diag (it honours params.opaque too; the
    name is the JAX package's)."""
    return _render_btz_impl(buf, obj_index, objects, cam, hole, width, height, params,
                            planar)[0]


render_btz = render_btz_xray


def render_btz_brute(buf: WorldlineBuffer, obj_index, objects: Objects, cam: Camera,
                     hole: BTZBlackHole, width: int, height: int, params: RenderParams,
                     n_samples: int = 48) -> torch.Tensor:
    """Exhaustive oracle: per pixel and route, occupancy against every
    (slot, particle) segment at the route's retarded time, and occlusion by
    walking `n_samples` closed-form points along the pixel's own geodesic,
    each tested against every segment at its own retarded time.
    Independent of the fast path's bearing retina.  O(pixels * T * N *
    n_samples): tests on tiny scenes only.  Returns (H, W, 3)."""
    dt, rho = params.dt, params.rho
    t_now = newest_time(buf)
    cxm, cym = cam.pos[0], cam.pos[1]
    use_rays = params.opaque and params.retarded
    M, l = hole.mass, hole.ads_l
    hx, hy = hole.center[0], hole.center[1]
    dev = buf.pos_x.device

    qax, qay, qbx, qby, ta, seg_valid = _segment_data(buf, dt)
    t_cap, n = qax.shape
    fax, fay = qax.reshape(-1), qay.reshape(-1)
    fbx, fby = qbx.reshape(-1), qby.reshape(-1)
    fta = ta.repeat_interleave(n)
    valid_f = seg_valid.repeat_interleave(n) & (torch.abs(fax) < 1e8)
    fobj = obj_index.long().repeat(t_cap)
    fvx = buf.vel_x[:t_cap].reshape(-1)
    fvy = buf.vel_y[:t_cap].reshape(-1)
    routes = route_ids(params)
    optics_fn, delay_fn = _select_optics(params)
    fracs = torch.linspace(0.02, 0.995, n_samples, dtype=torch.float32, device=dev)

    def hits(sx, sy, t_e):
        inside, dist2 = _occupancy_xy(sx[:, None], sy[:, None], t_e[:, None], fax[None],
                                      fay[None], fbx[None], fby[None], fta[None], dt, rho)
        return inside & valid_f[None, :], dist2

    def route_pass(px, py, chart_d, route):
        # the slow-rotation orbit shape, and with btz_exact_spin the exact
        # delay (the walk keeps the static shape, as the JAX oracle does)
        ob = _orbit_setup(px, py, cxm, cym, hole, route)
        dphi, s, A, B, mu = ob["dphi"], ob["s"], ob["A"], ob["B"], ob["mu"]
        if params.btz_exact_spin:
            td = delay_fn(px, py, cxm, cym, hole, route)
        else:
            td = _null_delay_u(ob["u_c"], ob["u_q_bvp"], dphi, M, l)
        inside, dist2 = hits(px, py, t_now - td)
        best = torch.argmin(torch.where(inside, dist2, _BIG), dim=1)
        occ = torch.gather(inside, 1, best[:, None])[:, 0] & (td < _BIG)
        blocked = torch.zeros_like(occ)
        if use_rays:
            margin = 2.0 * rho * td / chart_d
            for j in range(n_samples):
                phis = dphi * fracs[j]
                u = A * torch.exp(mu * phis) + B * torch.exp(-mu * phis)
                r = _inv(torch.abs(u))
                ang = ob["phi_c"] + s * phis
                sx, sy = hx + r * torch.cos(ang), hy + r * torch.sin(ang)
                dj = _null_delay_u(ob["u_c"], u, torch.clamp(phis, min=1e-5), M, l)
                hit = hits(sx, sy, t_now - dj)[0].any(dim=1)
                blocked = blocked | (hit & (dj < td - margin) & (dj < _BIG))
        return dict(td=td, occ=occ, best=best, blk=blocked, sel=occ & ~blocked)

    def pixel_chunk(px, py):
        chart_d = torch.clamp(torch.sqrt((px - cxm) ** 2 + (py - cym) ** 2), min=1e-6)
        passes = []
        for r in routes:
            ro = route_pass(px, py, chart_d, r)
            ro["beta"], _, ro["nex"], ro["ney"] = optics_fn(px, py, cxm, cym, hole, r)
            passes.append(ro)
        visible, occupied = passes[0]["sel"], passes[0]["occ"]
        for ro in passes[1:]:
            visible = visible | ro["sel"]
            occupied = occupied | ro["occ"]
        idx = torch.where(visible, _earliest(passes, "sel", px), _earliest(passes, "occ", px))
        best = passes[0]["best"]
        for i, ro in enumerate(passes[1:], start=1):
            best = torch.where(idx == i, ro["best"], best)
        obj = fobj[best]
        cr, cg, cb = (objects.base_color[:, c][obj] for c in range(3))
        sr, sg, sb = _shade_winner(passes, idx, fvx[best], fvy[best], cr, cg, cb, px, py, cam,
                                   hole, params)
        rp = torch.sqrt((px - hx) ** 2 + (py - hy) ** 2)
        comp = _compose(passes, visible, occupied, rp < hole.r_h, params, use_rays)
        return torch.stack([comp(sr), comp(sg), comp(sb)], dim=-1)

    pc = pixel_centers(width, height, cam)
    px_all, py_all = pc[..., 0].reshape(-1), pc[..., 1].reshape(-1)
    step = max(1, _BRUTE_ELEMENTS // max(fax.shape[0], 1))
    img = torch.cat([pixel_chunk(px_all[a:a + step], py_all[a:a + step])
                     for a in range(0, px_all.shape[0], step)])
    return img.reshape(height, width, 3)
