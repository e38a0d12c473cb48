"""Exact rotating-BTZ null-geodesic optics: closed-form integrals and a
branch-bracketed bisection of the boundary problem.

Counterpart of `spacetime_tpu/ops/btz_exact.py`.  The slow-rotation model
of ops/btz.py is exact to O(J^2); this module solves the full rotating
metric

    ds^2 = -N^2 dt^2 + dr^2 / N^2 + r^2 (dphi + N^phi dt)^2,
    N^2 = r^2 / l^2 - M + J^2 / (4 r^2),   N^phi = -J / (2 r^2).

With E = 1, L = k and x = r^2, (dx/dlambda)^2 = 4 (alpha x + beta) with
alpha = 1 - k^2 / l^2 and beta = k (M k - J); the sweep and the time along
a monotone x-segment integrate in closed form by partial fractions over the
horizon poles x+- (`_seg`, `_G`: a log or an arctan per pole).  The
boundary problem (find k whose sweep is the route's separation) bisects
inside per-branch brackets whose edges are closed form:

  * mono: x monotone between the endpoints;
  * apo: out to the apocentre and back in (searched together with mono by
    one bisection in a signed turning-point parameter that runs straight
    through the junction, `_solve_exact`);
  * peri: in to a pericentre and back out (frame dragging, J > 0 only);
  * bounce: out to the AdS boundary and back, the reflected routes
    (`_solve_exact_bounce`).

Every bisection takes `_N_BISECT` = 54 steps, a Python loop of tensor ops
with no host read and no data-dependent exit, so a CUDA graph can capture
it.  A solve is accepted within 1e-2 of the target sweep; where no branch
brackets the target, `exact_route_optics_xy` returns the slow-rotation
values there and says so in its `fallback` mask (the JAX package's
algorithm).  Roughly 100 times the slow-rotation evaluation's work, all
elementwise.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12
_BIG = 1e9
_N_BISECT = 54


def _horizons_x(M, l, J):
    """(xp, xm): the squared outer and inner horizon radii."""
    root = torch.sqrt(torch.clamp(M * M - (J * J) / (l * l), min=0.0))
    return l * l * (M + root) * 0.5, l * l * (M - root) * 0.5


def _G(w, wc2, at_inf: bool):
    """Antiderivative in w of 2 / (w^2 - wc2); `at_inf` takes the w -> inf
    limit (the AdS-boundary endpoint)."""
    pos = wc2 > _EPS
    wc = torch.sqrt(torch.clamp(wc2, min=_EPS))
    s = torch.sqrt(torch.clamp(-wc2, min=_EPS))
    if at_inf:
        log_form = torch.zeros_like(wc)  # ln((w - wc) / (w + wc)) -> ln 1
        atan_form = math.pi / s
    else:
        num = torch.abs(w - wc)
        den = torch.clamp(w + wc, min=_EPS)
        log_form = torch.log(torch.clamp(num, min=1e-30) / den) / wc
        atan_form = 2.0 * torch.atan(w / s) / s
    return torch.where(pos, log_form, atan_form)


def _seg(x1, x2, k, M, l, J, sr, to_inf: bool = False, beta=None, hz=None,
         with_t: bool = True):
    """(dphi, dt) along one monotone x-segment x1 -> x2, sr the sign of
    dx/dlambda; `to_inf` replaces x2 by the AdS boundary.  `beta`
    overrides k (M k - J) (turning-point solves pass -alpha x_t, exact at
    the grazing endpoint); `hz` is _horizons_x(M, l, J) when the caller
    has it.  Without `with_t` dt is None (the bisection reads the sweep
    only; XLA drops the unread time the same way)."""
    xp, xm = _horizons_x(M, l, J) if hz is None else hz
    alpha = 1.0 - (k * k) / (l * l)
    if beta is None:
        beta = k * (M * k - J)
    cphi = -l * l * (M * k - J / 2.0)
    ct = -J * k / 2.0
    dx = torch.clamp(xp - xm, min=_EPS)
    Pp = (k * xp + cphi) / dx
    Pm = -(k * xm + cphi) / dx
    if with_t:
        Qp = l * l * (xp + ct) / dx
        Qm = -l * l * (xm + ct) / dx
    else:
        Qp = Qm = None

    w1 = torch.sqrt(torch.clamp(alpha * x1 + beta, min=0.0))
    w2 = None if to_inf else torch.sqrt(torch.clamp(alpha * x2 + beta, min=0.0))
    out_phi = torch.zeros_like(x1)
    out_t = torch.zeros_like(x1)
    for c, P, Q in ((xp, Pp, Qp), (xm, Pm, Qm)):
        wc2 = alpha * c + beta
        g2 = _G(torch.zeros_like(w1), wc2, True) if to_inf else _G(w2, wc2, False)
        g = g2 - _G(w1, wc2, False)
        out_phi = out_phi + P * g
        if with_t:
            out_t = out_t + Q * g
    return sr * out_phi * 0.5, (sr * out_t * 0.5 if with_t else None)


def _path(xc, xq, k, M, l, J, branch: str, xt_exact=None, hz=None, with_t: bool = True):
    """(dphi, dt) of the branch's path; dphi NaN where the branch is not
    valid at this k.  `xt_exact` is the turning point of a turning-point-
    parametrized solve (beta = -alpha x_t exactly); `hz` and `with_t` as
    for _seg (dt None without `with_t`)."""
    hz = _horizons_x(M, l, J) if hz is None else hz
    seg = lambda *a, **kw: _seg(*a, **kw, beta=beta, hz=hz, with_t=with_t)
    add = lambda a, b: a + b if with_t else None
    alpha = 1.0 - (k * k) / (l * l)
    if xt_exact is None:
        beta = k * (M * k - J)
        xt = -beta / torch.where(torch.abs(alpha) > _EPS, alpha, _EPS)
    else:
        xt = xt_exact
        beta = -alpha * xt
    rr2c = alpha + beta / xc
    rr2q = alpha + beta / xq
    nan = float("nan")

    if branch == "mono":
        sr = torch.where(xq >= xc, 1.0, -1.0)
        p, t = seg(xc, xq, k, M, l, J, sr)
        ok = (rr2c > 0) & (rr2q > 0)
        return torch.where(ok, p, nan), t
    if branch == "apo":
        # f32 tolerance at the mono/apo junction: the clamped x_t makes the
        # marginal path exactly the junction orbit
        ok = (alpha < 0) & (beta > 0) & (xt >= torch.maximum(xc, xq) * (1.0 - 1e-4))
        xt_s = torch.maximum(xt, torch.maximum(xc, xq))
        pa, ta = seg(xc, xt_s, k, M, l, J, 1.0)
        pb, tb = seg(xt_s, xq, k, M, l, J, -1.0)
        return torch.where(ok, pa + pb, nan), add(ta, tb)
    if branch == "peri":
        xp = hz[0]
        ok = ((alpha > 0) & (beta < 0) & (xt <= torch.minimum(xc, xq) * (1.0 + 1e-4))
              & (xt > xp))
        xt_s = torch.minimum(xt, torch.minimum(xc, xq))
        xt_s = torch.maximum(xt_s, xp * (1.0 + 1e-6))
        pa, ta = seg(xc, xt_s, k, M, l, J, -1.0)
        pb, tb = seg(xt_s, xq, k, M, l, J, 1.0)
        return torch.where(ok, pa + pb, nan), add(ta, tb)
    if branch == "bounce":
        # rdot^2 > 0 at both endpoints is the whole validity condition (a
        # pericentre blocking the down-leg is rr2q < 0)
        ok = (alpha > 0) & (rr2c > 0) & (rr2q > 0)
        pa, ta = seg(xc, xc, k, M, l, J, 1.0, to_inf=True)
        pb, tb = seg(xq, xq, k, M, l, J, 1.0, to_inf=True)
        # (xc -> inf, +1) then (inf -> xq, -1), the latter equal to
        # +seg(xq -> inf, +1)
        return torch.where(ok, pa + pb, nan), add(ta, tb)
    raise ValueError(branch)


def _k_edge_rr2(xe, M, l, J):
    """The smallest positive k with rdot^2(xe) = 0 (the mono and bounce
    brackets' top); _BIG where rdot^2 > 0 for every k."""
    a = M / xe - 1.0 / (l * l)
    b = -J / xe
    disc = b * b - 4.0 * a
    has = disc > 0
    root = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (
        2.0 * torch.where(torch.abs(a) > _EPS, a, _EPS))
    # a ~ 0: b k + 1 = 0, k = -1/b (b < 0)
    lin = torch.where(b < -_EPS, -1.0 / torch.where(b < -_EPS, b, -1.0), _BIG)
    root = torch.where(torch.abs(a) > _EPS, root, lin)
    return torch.where(has & (root > 0), root, _BIG)


def _k_apo_edge(xe, M, l, J):
    """The positive k whose turning point x_t(k) is xe:
    k^2 (xe - l^2 M) + l^2 J k - xe l^2 = 0."""
    a = xe - l * l * M
    b = l * l * J
    c = -xe * l * l
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    root = (-b + torch.sqrt(disc)) / (2.0 * torch.where(torch.abs(a) > _EPS, a, _EPS))
    lin = torch.where(torch.abs(b) > _EPS, -c / torch.where(torch.abs(b) > _EPS, b, 1.0), _BIG)
    return torch.where(torch.abs(a) > _EPS, root, lin)


def _bisect(xc, xq, target, M, l, J, branch, lo, hi, k_of=None, signed_param: bool = False,
            xt_of=None):
    """Fixed-depth bisection of the branch's sweep toward `target` inside
    the parameter bracket [lo, hi]; `k_of` maps the parameter to k (the
    identity by default), `xt_of` to the turning point of turning-point-
    parametrized solves.  With `signed_param`, `branch` is (negative-side
    branch, positive-side branch), evaluated by the parameter's sign.
    Returns (k, dt, valid); with `signed_param` k is (k, positive side)."""
    if k_of is None:
        k_of = lambda v: v
    shape = torch.broadcast_shapes(xc.shape, xq.shape, target.shape, lo.shape, hi.shape)
    xc, xq, target, lo, hi = (v.expand(shape) for v in (xc, xq, target, lo, hi))

    hz = _horizons_x(M, l, J)

    def PT(v, with_t=True):
        k = k_of(v)
        xt = None if xt_of is None else xt_of(v)
        path = lambda b: _path(xc, xq, k, M, l, J, b, xt_exact=xt, hz=hz, with_t=with_t)
        if signed_param:
            (pn, tn), (pp, tp) = path(branch[0]), path(branch[1])
            pos = v >= 0
            return torch.where(pos, pp, pn), (torch.where(pos, tp, tn) if with_t else None)
        return path(branch)

    F = lambda v: PT(v, with_t=False)[0]
    flo, fhi = F(lo), F(hi)
    inc = fhi > flo
    valid = ((hi > lo) & torch.isfinite(flo) & torch.isfinite(fhi)
             & (torch.minimum(flo, fhi) <= target) & (target <= torch.maximum(flo, fhi)))
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        fm = F(mid)
        go_lo = ((fm < target) == inc) & torch.isfinite(fm)
        lo, hi = torch.where(go_lo, mid, lo), torch.where(go_lo, hi, mid)
    v = 0.5 * (lo + hi)
    k = k_of(v)
    p, t = PT(v)
    # acceptance within 1e-2 of the target sweep: junction-adjacent orbits
    # carry ~5e-3 f32 sweep noise once |F - target| is below the evaluation
    # noise (~1e-3 relative delay error); unbracketed targets still fail
    valid = valid & torch.isfinite(p) & (
        torch.abs(p - target) <= 1e-2 * torch.clamp(target, min=1.0))
    if signed_param:
        return (k, v >= 0), t, valid
    return k, t, valid


def _solve_exact(xc, xq, dphi, M, l, J):
    """The direct routes' solve: (k, dt, sr_cam, sr_emit, valid).  Three
    searches cover the family: mono-low (k-bisection over (0, l)); the
    combined mono/apo search in sigma, x_t = xmax + sigma^2 with
    k = _k_apo_edge(x_t), sigma < 0 the monotone path and sigma > 0 the
    apocentre path (monotone through sigma = 0, where a k-bisection loses
    its precision); and peri, a sigma-bisection below xmin (J > 0 only)."""
    tiny = 1e-4 * torch.sqrt(torch.clamp(M, min=_EPS)) * l

    k_m_hi = torch.minimum(_k_edge_rr2(xc, M, l, J), _k_edge_rr2(xq, M, l, J))
    k_m_hi = torch.minimum(k_m_hi, l) * (1.0 - 1e-6)
    km, tm, vm = _bisect(xc, xq, dphi, M, l, J, "mono", tiny, k_m_hi)

    xmax = torch.maximum(xc, xq)
    xt_cap = 1e4 * torch.maximum(l * l * M, xmax)
    s_cap = torch.sqrt(xt_cap - xmax)
    xt_of_comb = lambda sg: xmax + sg * sg
    k_of_comb = lambda sg: _k_apo_edge(xmax + sg * sg, M, l, J)
    kc, tc, vc = _bisect(xc, xq, dphi, M, l, J, ("mono", "apo"), -s_cap, s_cap,
                         k_of=k_of_comb, signed_param=True, xt_of=xt_of_comb)

    # peri: the turning point below both endpoints (frame-dragging dips)
    xp_h, _ = _horizons_x(M, l, J)
    xmin = torch.minimum(xc, xq)
    xt_of_peri = lambda s: torch.maximum(xmin - s * s, xp_h * (1.0 + 1e-5))

    def k_of_peri(s):
        xt = xt_of_peri(s)
        # the co-rotating root of k^2 (xt - l^2 M) + l^2 J k - xt l^2 = 0
        a = xt - l * l * M
        b = l * l * J
        c = -xt * l * l
        disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
        two_a = 2.0 * torch.where(torch.abs(a) > _EPS, a, _EPS)
        r1, r2 = (-b + disc) / two_a, (-b - disc) / two_a
        small = torch.minimum(torch.abs(r1), torch.abs(r2))
        pick = torch.where(torch.abs(r1) <= torch.abs(r2), r1, r2)
        return torch.where(pick > 0, pick, torch.clamp(small, min=_EPS))

    kp, tp, vp = _bisect(xc, xq, dphi, M, l, J, "peri", torch.zeros_like(xc),
                         torch.sqrt(torch.clamp(xmin - xp_h * (1.0 + 1e-5), min=_EPS)),
                         k_of=k_of_peri, xt_of=xt_of_peri)
    vp = vp & (J > 0)

    kc_k, kc_apo = kc
    k = torch.where(vm, km, torch.where(vc, kc_k, kp))
    t = torch.where(vm, tm, torch.where(vc, tc, tp))
    valid = vm | vc | vp
    mono_dir = torch.where(xq >= xc, 1.0, -1.0)
    comb_cam = torch.where(kc_apo, 1.0, mono_dir)
    comb_emit = torch.where(kc_apo, -1.0, mono_dir)
    sr_cam = torch.where(vm, mono_dir, torch.where(vc, comb_cam, -1.0))
    sr_emit = torch.where(vm, mono_dir, torch.where(vc, comb_emit, 1.0))
    return k, t, sr_cam, sr_emit, valid


def _solve_exact_bounce(xc, xq, dphi, M, l, J):
    """The reflected routes' solve (one AdS-boundary bounce): one k bracket,
    valid where rdot^2 > 0 at both endpoints."""
    tiny = 1e-4 * torch.sqrt(torch.clamp(M, min=_EPS)) * l
    hi_all = torch.minimum(torch.minimum(_k_edge_rr2(xc, M, l, J), _k_edge_rr2(xq, M, l, J)),
                           l) * (1.0 - 1e-6)
    k, t, v = _bisect(xc, xq, dphi, M, l, J, "bounce", tiny, hi_all)
    return k, t, torch.ones_like(k), -torch.ones_like(k), v


def exact_route_optics_xy(qx, qy, cx, cy, hole, route: int):
    """(camera bearing, delay, emitter-side propagation direction x, y,
    fallback) of one route in the exact rotating metric: the counterpart of
    btz.route_optics_xy.  Where the branch solve fails (or an endpoint is
    inside the outer horizon) the slow-rotation values stand and
    `fallback` is True."""
    from .btz import _orbit_setup, route_optics_xy

    M, l, J = hole.mass, hole.ads_l, hole.spin
    # the slow-rotation values: the fallback and the sign convention's anchor
    sb, sd, sx, sy = route_optics_xy(qx, qy, cx, cy, hole, route)
    ob = _orbit_setup(qx, qy, cx, cy, hole, route)
    dphi, s = ob["dphi"], ob["s"]
    xc = ob["rc"] * ob["rc"]
    xq = ob["rq"] * ob["rq"]
    # the positive-sweep problem in the mirrored frame, at spin J_m = -s J
    # (the camera -> emitter traversal at spin J is the delay at spin -J)
    Jm = -s * J
    solve = _solve_exact_bounce if (route % 4) >= 2 else _solve_exact
    k, t, sr_c, sr_e, valid = solve(xc, xq, dphi, M, l, Jm)

    xp, xm = _horizons_x(M, l, Jm)
    alpha = 1.0 - (k * k) / (l * l)
    beta = k * (M * k - Jm)

    def tangent(x, ang, sr):
        # physical x > 0 on explicit legs: the radial sign sr already holds
        # a reflected or turned arrival
        rdot = sr * torch.sqrt(torch.clamp(alpha + beta / x, min=0.0))
        phid = (k * x - l * l * (M * k - Jm / 2.0)) / torch.clamp((x - xp) * (x - xm), min=_EPS)
        r = torch.sqrt(x)
        rhx, rhy = torch.cos(ang), torch.sin(ang)
        thx, thy = -rhy * s, rhx * s
        return rdot * rhx + r * phid * thx, rdot * rhy + r * phid * thy

    vx, vy = tangent(xc, ob["phi_c"], sr_c)
    bearing = torch.atan2(vy, vx)
    tx, ty = tangent(xq, ob["phi_c"] + s * dphi, sr_e)
    inv = torch.rsqrt(torch.clamp(tx * tx + ty * ty, min=_EPS))
    nex, ney = -tx * inv, -ty * inv
    # endpoints inside the outer horizon freeze, as on the slow-rotation path
    inside = (xc <= xp) | (xq <= xp)
    delay = torch.where(inside, _BIG, t)
    valid = valid & ~inside
    return (torch.where(valid, bearing, sb), torch.where(valid, delay, sd),
            torch.where(valid, nex, sx), torch.where(valid, ney, sy), ~valid)


def exact_route_delay_xy(qx, qy, cx, cy, hole, route: int):
    """The delay of exact_route_optics_xy (the band search's cone metric)."""
    return exact_route_optics_xy(qx, qy, cx, cy, hole, route)[1]
